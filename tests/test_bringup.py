"""The pieces that let the program start anywhere: the compile-cache
choice, the procedural scene the entry points train on, and
chip_smoke.py's refusal to pass without a GPU."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_dir", [None, "/some/cache"])
def test_compile_cache_dir(monkeypatch, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins (the package sets no directory);
    without it the cache is <checkout>/.jax_cache."""
    import instant_ngp_tpu

    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert instant_ngp_tpu.compile_cache_dir() == os.path.join(
            REPO, ".jax_cache")
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
        assert instant_ngp_tpu.compile_cache_dir() is None


def test_procedural_scene_deterministic_and_trains_from_disk(tmp_path):
    """Same seed -> same views; the written transforms.json + EXR frames
    load back through load_nerf into the same cameras and colours and
    train two NerfTestbed steps."""
    from instant_ngp_tpu.data.nerf_loader import load_nerf
    from instant_ngp_tpu.data.procedural import (linear_rgba, make_scene,
                                                 write_scene)
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
    sys.path.insert(0, os.path.dirname(__file__))
    from test_nerf_training import CFG

    a, b = make_scene(4, 24, seed=3), make_scene(4, 24, seed=3)
    other = make_scene(4, 24, seed=4)
    for x, y in zip(a.images, b.images):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.xforms_start, b.xforms_start)
    assert np.abs(a.xforms_start - other.xforms_start).max() > 1e-3
    assert max(img[..., 3].max() for img in a.images) == 255

    ds = load_nerf(write_scene(str(tmp_path), 4, 24, seed=3))
    assert ds.n_images == 4 and ds.aabb_scale == 1 and ds.is_hdr
    np.testing.assert_allclose(ds.xforms_start, a.xforms_start, atol=1e-5)
    np.testing.assert_allclose(ds.metadata[0].focal_length,
                               a.metadata[0].focal_length)
    np.testing.assert_allclose(np.asarray(ds.images[1], np.float32),
                               linear_rgba(a.images[1]), atol=2e-3)

    tb = NerfTestbed(ds, CFG)
    tb.target_batch_size = 1 << 10
    tb.rays_per_batch = 1 << 8
    tb.steps_per_dispatch = 1
    loss = tb.train(2)
    assert tb.training_step == 2 and np.isfinite(loss)
    assert tb.measured_batch_size > 0


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits non-zero and prints no "ok" line on the CPU
    backend."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_ENABLE_COMPILATION_CACHE="false")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert jax.default_backend() == "cpu"
