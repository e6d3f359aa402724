"""Test config: run everything on the CPU (JAX_PLATFORMS=cpu) with 8
virtual devices so sharding tests work without accelerators (SURVEY.md §4
test strategy). The persistent compilation cache stays off: CPU
executables cached by one worker are not reused safely by another.
"""

import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402

REFERENCE_DATA = "/root/reference/data"


@pytest.fixture(scope="session")
def reference_data():
    if not os.path.isdir(REFERENCE_DATA):
        pytest.skip("reference data not available")
    return REFERENCE_DATA
