"""scripts/run.py CLI smoke tests (the reference's headless driver,
scripts/run.py:27-70) — invoked as a real subprocess on the CPU backend,
on procedural scenes written by instant_ngp_tpu.data.procedural."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = os.path.join(REPO, "scripts", "run.py")


def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # single CPU device is fine + faster
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_ENABLE_COMPILATION_CACHE"] = "false"
    return env


def test_run_py_image_train_snapshot_roundtrip(tmp_path):
    from instant_ngp_tpu.data.procedural import main as procedural

    image = str(tmp_path / "sphere.exr")
    procedural([image, "--image", "--size", "32"])
    snap = str(tmp_path / "sphere.ingp")
    env = _env()
    out = subprocess.run(
        [sys.executable, RUN, "--scene", image,
         "--n_steps", "8", "--save_snapshot", snap],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert os.path.isfile(snap)

    # reload the snapshot in a fresh process, no further training
    out2 = subprocess.run(
        [sys.executable, RUN, "--scene", image,
         "--load_snapshot", snap, "--n_steps", "0"],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert out2.returncode == 0, out2.stderr[-2000:]


def test_run_py_screenshot_transforms(tmp_path):
    """--screenshot_transforms renders per-frame screenshots from a
    transforms file (reference run.py:128-139,276-303) named after each
    frame's file_path."""
    from instant_ngp_tpu.data.procedural import write_scene

    scene = str(tmp_path / "scene")
    transforms = write_scene(scene, n_cams=2, size=16)
    env = _env()
    out = subprocess.run(
        [sys.executable, RUN, "--scene", scene, "--n_steps", "0",
         "--screenshot_transforms", transforms, "--screenshot_frames", "0",
         "--screenshot_dir", str(tmp_path), "--width", "32",
         "--height", "18", "--screenshot_spp", "1"],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    with open(transforms) as f:
        frame0 = json.load(f)["frames"][0]["file_path"]
    expected = os.path.join(
        str(tmp_path), os.path.basename(frame0))
    if not os.path.splitext(expected)[1]:
        expected += ".png"
    assert os.path.isfile(expected), out.stdout[-2000:]
