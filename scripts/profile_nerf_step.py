#!/usr/bin/env python3
"""Per-phase device timing of one NeRF train step.

Times each stage of the training pipeline as its own jitted program
(march, compaction, hash encode, full network forward, loss forward,
full train step) so the per-step time can be attributed. The scene is
the procedural sphere (instant_ngp_tpu/data/procedural.py) unless
`--scene` names a transforms.json. Each stage is compiled and warmed
before timing; times are pipelined means — `--iters` dispatches enqueued
back-to-back, fenced once with block_until_ready, total/iters reported
(see `timed`).

The stage set mirrors the reference's train_nerf_step phases
(generate_training_samples_nerf -> inference -> loss kernel -> trainer
step, src/testbed_nerf.cu:2683-2930).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def timed(fn, *args, iters=8):
    """Pipelined timing: enqueue `iters` dispatches back-to-back, fence
    once at the end. Device work serializes, so total/iters is the
    per-dispatch device time plus the amortized dispatch overhead."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) * 1e3 / iters


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="",
                    help="transforms.json (default: procedural sphere)")
    ap.add_argument("--rays", type=int, default=1 << 11)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--train-steps", type=int, default=24,
                    help="steps to pre-train so occupancy is realistic")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.nerf_loader import load_nerf
    from instant_ngp_tpu.data.procedural import make_scene
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed
    from instant_ngp_tpu.nerf.sampler import (compact_samples, generate_rays,
                                              march_rays)
    from instant_ngp_tpu.nerf import training as T

    ds = load_nerf(args.scene) if args.scene else make_scene(seed=0)
    cfg = load_network_config(find_network_config("base.json", mode="nerf"))
    tb = NerfTestbed(ds, cfg)
    tb.rays_per_batch = args.rays
    tb.adapt_ray_batch = False
    tb.train(args.train_steps)  # realistic occupancy + steady state

    scene = tb.scene
    lo = jnp.asarray(scene.aabb_min)
    hi = jnp.asarray(scene.aabb_max)
    step_cfg = tb._train_cfg(args.rays, tb._bucket_k(args.rays))
    data = tb.data
    bitfield = tb.bitfield
    key = jax.random.PRNGKey(7)
    report = {"backend": jax.default_backend(), "n_rays": args.rays,
              "n_march": step_cfg.n_march,
              "sample_capacity": step_cfg.sample_capacity, "stages_ms": {}}

    # big arrays (dataset, bitfield) ride as jit ARGUMENTS — closing
    # over them would embed them as HLO constants, which bloats every
    # executable.

    # stage 1: ray generation (pixel pick + lens ray build)
    @jax.jit
    def stage_raygen(k, dd):
        rays, _ = generate_rays(k, dd, step_cfg.n_rays, lo, hi,
                                step_cfg.cone_angle, step_cfg.lens_mode,
                                step_cfg.snap_to_pixel_centers)
        return rays.origins, rays.dirs, rays.t_start

    report["stages_ms"]["raygen"] = timed(stage_raygen, key, data,
                                          iters=args.iters)

    # stage 2: march (analytic candidate grid + bitfield gather)
    @jax.jit
    def stage_march(k, dd, bf):
        rays, _ = generate_rays(k, dd, step_cfg.n_rays, lo, hi,
                                step_cfg.cone_angle, step_cfg.lens_mode,
                                step_cfg.snap_to_pixel_centers)
        return march_rays(rays, bf, lo, hi, step_cfg.cone_angle,
                          step_cfg.max_mip, step_cfg.n_march,
                          step_cfg.max_samples_per_ray)

    report["stages_ms"]["raygen_march"] = timed(stage_march, key, data,
                                                bitfield, iters=args.iters)

    # stage 3: + compaction (prefix-sum scatter/gather)
    @jax.jit
    def stage_compact(k, dd, bf):
        rays, _ = generate_rays(k, dd, step_cfg.n_rays, lo, hi,
                                step_cfg.cone_angle, step_cfg.lens_mode,
                                step_cfg.snap_to_pixel_centers)
        ts, dts, emits = march_rays(rays, bf, lo, hi,
                                    step_cfg.cone_angle, step_cfg.max_mip,
                                    step_cfg.n_march,
                                    step_cfg.max_samples_per_ray)
        s = compact_samples(rays, ts, dts, emits, lo, hi,
                            step_cfg.sample_capacity)
        return s.positions, s.dirs, s.n_samples

    report["stages_ms"]["raygen_march_compact"] = timed(
        stage_compact, key, data, bitfield, iters=args.iters)

    # fixed sample set for network-only stages
    pos, dirs, _ = stage_compact(key, data, bitfield)
    params = tb.state["params"]
    model = tb.model

    # stage 4: hash encode forward only
    @jax.jit
    def stage_encode(p, px, py, pz):
        if hasattr(model.pos_encoding, "apply_components"):
            return model.pos_encoding.apply_components(
                p["pos_encoding"], [px, py, pz])
        return model.pos_encoding.apply(
            p["pos_encoding"], jnp.stack([px, py, pz], -1))

    report["stages_ms"]["encode_fwd"] = timed(
        stage_encode, params, *pos, iters=args.iters)

    # stage 5: full network forward (encode + both MLPs + SH)
    @jax.jit
    def stage_network(p, pxyz, dxyz):
        return model.apply_components(p, pxyz, dxyz, None)

    report["stages_ms"]["network_fwd"] = timed(
        stage_network, params, pos, dirs, iters=args.iters)

    # stage 6: encode forward+backward (gather + scatter-add grads)
    @jax.jit
    def stage_encode_grad(p, px, py, pz):
        def f(pp):
            if hasattr(model.pos_encoding, "apply_components"):
                feats = model.pos_encoding.apply_components(
                    pp["pos_encoding"], [px, py, pz])
            else:
                feats = model.pos_encoding.apply(
                    pp["pos_encoding"], jnp.stack([px, py, pz], -1))
            return jnp.sum(feats * feats)
        return jax.grad(f)(p)

    report["stages_ms"]["encode_fwd_bwd"] = timed(
        stage_encode_grad, params, *pos, iters=args.iters)

    # stage 7: full network forward+backward
    @jax.jit
    def stage_network_grad(p, pxyz, dxyz):
        def f(pp):
            out = model.apply_components(pp, pxyz, dxyz, None)
            return sum(jnp.sum(c * c) for c in out)
        return jax.grad(f)(p)

    report["stages_ms"]["network_fwd_bwd"] = timed(
        stage_network_grad, params, pos, dirs, iters=args.iters)

    # stage 8: the full train step as the testbed runs it. The state is
    # donated, so carry it across calls instead of reusing buffers.
    fn = tb._get_train_fn(args.rays, tb._bucket_k(args.rays))
    md = jnp.asarray(0.0, jnp.float32)
    carry = {"state": tb.state}

    def stage_full(k):
        new_state, stats = fn(carry["state"], data, bitfield, md, k,
                              tb._cam_dict(), tb._error_cdfs,
                              tb._error_map, None, None)
        carry["state"] = new_state
        return stats["loss"]

    report["stages_ms"]["full_train_step"] = timed(stage_full, key,
                                                   iters=args.iters)

    for k, v in report["stages_ms"].items():
        report["stages_ms"][k] = round(v, 3)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
