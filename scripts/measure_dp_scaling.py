#!/usr/bin/env python3
"""Measure data-parallel NeRF train-step scaling over a device mesh.

Runs the SAME sharded step the testbed uses (nerf/parallel.py — not a
fork of the train logic) on meshes of 1..N devices with a fixed per-chip
ray budget (weak scaling), and reports rays/s + parallel efficiency.

On GPUs the only cross-chip traffic is the gradient all-reduce over
NVLink; on the CPU backend (JAX_PLATFORMS=cpu with
--xla_force_host_platform_device_count=N) all "devices" share the host's
cores, so CPU efficiency numbers validate the sharding program, not the
hardware scaling — the artifact records which backend produced them.

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python scripts/measure_dp_scaling.py --out dp_scaling.json
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("--rays-per-chip", type=int, default=1 << 10)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--scene", default="")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh

    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.nerf.parallel import make_sharded_train_step
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed

    if args.scene:
        from instant_ngp_tpu.data.nerf_loader import load_nerf

        ds = load_nerf(args.scene)
    else:
        sys.path.insert(0, os.path.join(os.path.dirname(__file__),
                                        "..", "tests"))
        from test_nerf_training import make_dataset

        ds = make_dataset(n_cams=8, size=64)

    cfg_json = load_network_config(find_network_config("base.json",
                                                       mode="nerf"))
    devices = jax.devices()
    results = []
    base_rate = None
    n = 1
    while n <= len(devices):
        tb = NerfTestbed(ds, cfg_json)
        tb.rays_per_batch = args.rays_per_chip
        tb.n_march = 256
        tb.max_samples_per_ray = 128
        cfg = tb._train_cfg(args.rays_per_chip, 128)
        lo = jnp.asarray(tb.scene.aabb_min)
        hi = jnp.asarray(tb.scene.aabb_max)
        mesh = Mesh(np.array(devices[:n]), ("data",))
        step = make_sharded_train_step(tb.model, tb.optimizer, cfg,
                                       lo, hi, mesh)
        keys = jnp.stack([jax.random.PRNGKey(i) for i in range(n)])
        state = tb.state
        bf = jnp.full_like(tb.bitfield, 255)
        state, stats = step(state, tb.data, bf, tb.mean_density, keys)
        jax.block_until_ready(stats)
        t0 = time.perf_counter()
        for s in range(args.steps):
            keys = jnp.stack([
                jax.random.fold_in(jax.random.PRNGKey(i), s)
                for i in range(n)])
            state, stats = step(state, tb.data, bf, tb.mean_density, keys)
        jax.block_until_ready(stats)
        dt = time.perf_counter() - t0
        rays_per_s = args.steps * args.rays_per_chip * n / dt
        if base_rate is None:
            base_rate = rays_per_s
        eff = rays_per_s / (base_rate * n)
        results.append({
            "devices": n,
            "rays_per_s": round(rays_per_s, 1),
            "samples_per_s": round(
                float(stats["measured_batch_size"]) * args.steps / dt, 1),
            "steps_per_s": round(args.steps / dt, 3),
            "weak_scaling_efficiency": round(eff, 4),
        })
        print(results[-1], flush=True)
        n *= 2

    out = {
        "backend": jax.default_backend(),
        "n_devices_available": len(devices),
        "rays_per_chip": args.rays_per_chip,
        "note": ("CPU-mesh runs validate the sharded program; hardware "
                 "scaling numbers need GPUs"),
        "results": results,
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
