"""Benchmark driver: prints ONE JSON line with the headline metric.

Headline: NeRF training throughput (samples/s/chip at the reference batch
size 2^18) with configs/nerf/base.json on the procedural sphere scene
(instant_ngp_tpu/data/procedural.py, 64 views at 400^2). Secondary:
image-mode samples/s (configs/image/base.json on a 1024^2 view of the
same scene), stochastic and exact phases.

Runs in one process on the GPU and fails when JAX finds none. The output
names the device as JAX reports it and the card's name and power limit
as nvidia-smi reports them.

vs_baseline compares against the reference's implied operating point: an
RTX 3090 sustaining ~50 steps/s at 2^18 samples ("fox in 5 seconds" /
~256 steps ≈ 13.1 M samples/s).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_SAMPLES_PER_S = 13.1e6  # RTX 3090 implied (see docstring)


def bench_nerf():
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.procedural import make_scene
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed

    cfg = load_network_config(find_network_config("base.json", mode="nerf"))
    tb = NerfTestbed(make_scene(64, 400, seed=0), cfg)
    assert tb.steps_per_dispatch == 16  # bench path == default path
    # warm-up: compiles every scanned-block shape and lets the adaptive
    # ray batch settle on its bucket
    tb.train(128)

    # median of 3 windows
    windows = []
    n = 32
    for _ in range(3):
        t0 = time.perf_counter()
        tb.train(n)
        windows.append(time.perf_counter() - t0)
    dt = sorted(windows)[1]
    samples_per_s = n * tb.measured_batch_size / dt
    perf = tb.performance_stats()

    # extrinsics-on training (the reference's real-capture recommendation)
    tb.optimize_extrinsics = True
    tb.train(16)       # compile the camera-gradient block
    t0 = time.perf_counter()
    tb.train(32)
    dt_cam = time.perf_counter() - t0
    tb.optimize_extrinsics = False

    return {
        "metric": "nerf_train_samples_per_s",
        "value": round(samples_per_s, 1),
        "unit": "samples/s/chip",
        "vs_baseline": round(samples_per_s / BASELINE_SAMPLES_PER_S, 4),
        "detail": {"steps_per_s": round(n / dt, 3),
                   "steps_per_s_with_extrinsics": round(32 / dt_cam, 3),
                   "rays_per_batch": int(tb.rays_per_batch),
                   "mean_samples_per_ray": round(
                       perf.get("mean_samples_per_ray", 0.0), 2),
                   "loss": round(tb.loss_scalar, 5),
                   "measured_batch": int(tb.measured_batch_size),
                   "stochastic_corners": tb.stochastic_corners,
                   "window_s": [round(w, 3) for w in windows],
                   "phase_ms": perf.get("phase_ms")},
    }


def bench_image():
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.procedural import make_image
    from instant_ngp_tpu.image import ImageTestbed

    cfg = load_network_config(find_network_config("base.json", mode="image"))
    tb = ImageTestbed(make_image(1024, seed=0), cfg)
    tb.steps_per_dispatch = 15  # one dispatch per bench block
    batch = 1 << 18
    tb.train(15, batch_size=batch)
    t0 = time.perf_counter()
    n = 30
    tb.train(n, batch_size=batch)   # steps 15-45: stochastic warmup phase
    stoch_rate = n * batch / (time.perf_counter() - t0)
    # past stochastic_corners_until the training encode is the exact
    # d-linear path (the variance schedule) — measure it too
    until = tb.stochastic_corners_until or 0
    tb.train(max(until - tb.training_step, 0) + 15, batch_size=batch)
    t0 = time.perf_counter()
    tb.train(n, batch_size=batch)
    exact_rate = n * batch / (time.perf_counter() - t0)
    return {"stochastic_warmup_phase": round(stoch_rate, 1),
            "exact_steady_state": round(exact_rate, 1)}


def main():
    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"no GPU: JAX backend is {jax.default_backend()!r}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    result = bench_nerf()
    result["detail"]["image_train_samples_per_s"] = bench_image()
    dev = jax.devices()[0]
    result["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices()),
                        "nvidia_smi": smi.splitlines()}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
