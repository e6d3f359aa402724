#!/usr/bin/env python3
"""Render-side decay probes on the step-10240 fox snapshot (r5).

Two questions, both answered from the ALREADY-TRAINED round-4 default
arm snapshot (walkthrough_out/fox_r4_default_resume.ingp, step 10240),
so no training cost:

1. TRUNCATION: the eval renderer caps per-ray candidates at 512
   (render_max_samples_per_ray). Fox occupancy GROWS with training
   (decay_bisect_r5: occupied_frac 0.52 @512 -> 0.56+ @1024), so a
   binding cap sheds far content more as training proceeds — a decay
   mechanism that lives entirely in the eval renderer. Probe: eval the
   same views at cap 512 vs 1024 (= n_march, non-binding). A material
   PSNR gain at 1024 confirms truncation as (part of) the decay.

2. STOCHASTIC RENDER ESTIMATOR: eval the same views with
   render_stochastic_corners at spp {2, 8} vs the exact path. The
   PSNR delta prices the ~4x saving in eval table fetches;
   wall times recorded per arm.

Writes walkthrough_out/render_probe_r5.json.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.join(os.path.dirname(__file__), "..")
OUT = os.path.join(REPO, "walkthrough_out")
VIEWS = (0, 30)


def main():
    import numpy as np

    from instant_ngp_tpu.testbed import Testbed

    snap = os.path.join(OUT, "fox_r4_default_resume.ingp")
    tb = Testbed()
    tb.load_training_data("/root/reference/data/nerf/fox/transforms.json")
    tb.load_snapshot(snap)
    impl = tb.impl
    print("loaded snapshot at step", impl.training_step, flush=True)

    report = {"snapshot_step": int(impl.training_step), "views": list(VIEWS),
              "protocol": "ds4 spp2 unless stated", "arms": {}}
    path = os.path.join(OUT, "render_probe_r5.json")

    def run(name, spp=2, downscale=4):
        t0 = time.perf_counter()
        ps = [impl.eval_psnr(v, spp=spp, downscale=downscale)
              for v in VIEWS]
        report["arms"][name] = {
            "psnr_avg": round(float(np.mean(ps)), 3),
            "psnr_per_view": [round(float(p), 3) for p in ps],
            "wall_s": round(time.perf_counter() - t0, 1)}
        print(name, report["arms"][name], flush=True)
        with open(path, "w") as f:
            json.dump(report, f, indent=1)

    run("cap512_exact")                       # the r4 protocol baseline

    impl.render_max_samples_per_ray = 1024    # non-binding (= n_march)
    run("cap1024_exact")

    impl.render_stochastic_corners = True
    run("cap1024_stoch_spp2")
    run("cap1024_stoch_spp8", spp=8)

    impl.render_max_samples_per_ray = None
    run("cap512_stoch_spp8", spp=8)

    # ---- per-ray candidate emission stats at step 10240: does the
    # deep tail exceed the train (512 @2048 rays) or render (512)
    # per-ray caps? A fat tail means truncated supervision/rendering.
    import jax
    import jax.numpy as jnp
    from instant_ngp_tpu.nerf.render import camera_rays_for_frame
    from instant_ngp_tpu.nerf.march import (advance_n_steps,
                                            ray_intersect_aabb)
    from instant_ngp_tpu.nerf.sampler import RayBatch, march_rays

    w0, h0 = (int(v) for v in np.asarray(impl.data.resolutions[0]))
    fl = np.asarray(impl.data.focal_lengths[0]) / 4.0
    cam = impl.effective_xform(0)
    o, d = camera_rays_for_frame(w0 // 4, h0 // 4, fl, cam)
    sel = jax.random.choice(jax.random.PRNGKey(0),
                            o.shape[0], (4096,), replace=False)
    o, d = o[sel], d[sel]
    lo = jnp.asarray(impl.scene.aabb_min)
    hi = jnp.asarray(impl.scene.aabb_max)
    tmin, tmax = ray_intersect_aabb(o, d, lo, hi)
    tmin = jnp.maximum(tmin, 0.0)
    rays = RayBatch(o, d, advance_n_steps(
        tmin, impl.scene.cone_angle_constant, 0.5),
        jnp.zeros(o.shape[0], jnp.int32), jnp.zeros((o.shape[0], 2)),
        jnp.zeros((o.shape[0], 4)), tmax >= tmin)
    _, _, emit = march_rays(rays, impl.bitfield, lo, hi,
                            impl.scene.cone_angle_constant,
                            impl.scene.max_cascade, impl.n_march,
                            impl.n_march)
    counts = np.asarray(jnp.sum(emit, axis=1))
    report["emission_stats_view0"] = {
        "mean": round(float(counts.mean()), 1),
        "p50": int(np.percentile(counts, 50)),
        "p95": int(np.percentile(counts, 95)),
        "p99": int(np.percentile(counts, 99)),
        "max": int(counts.max()),
        "frac_over_512": round(float((counts > 512).mean()), 4),
        "n_march": int(impl.n_march)}
    print("emissions:", report["emission_stats_view0"], flush=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)

    # ---- error anatomy: is the 512->10240 decay a few catastrophic
    # pixels (floaters/fog in front of a camera) or a uniform rise?
    # Huber training loss SATURATES large per-pixel errors while PSNR
    # is MSE-dominated by exactly those pixels — the loss can fall
    # while PSNR falls iff the error mass concentrates.
    impl.render_stochastic_corners = False
    base = os.path.join(OUT, "decay_base_512.ingp")
    if os.path.isfile(base):
        import jax.numpy as jnp  # noqa: F401
        from instant_ngp_tpu.common import linear_to_srgb
        from instant_ngp_tpu.data.images import write_image

        def err_map(view):
            w0, h0 = (int(v) for v in np.asarray(
                impl.data.resolutions[view]))
            w, h = w0 // 4, h0 // 4
            render = impl.render_training_view(view, spp=2, width=w,
                                               height=h)
            gt = np.asarray(impl.data.pixels[view])[:h0, :w0]
            if gt.dtype == np.uint8:
                gt_srgb = gt[..., :3].astype(np.float32) / 255.0
            else:
                gt_srgb = linear_to_srgb(np.asarray(gt[..., :3],
                                                    np.float32))
            gt_srgb = gt_srgb[:h * 4, :w * 4].reshape(
                h, 4, w, 4, 3).mean(axis=(1, 3))
            e = ((np.clip(render[..., :3], 0, 1) - gt_srgb) ** 2
                 ).mean(-1)
            return e

        anatomy = {}
        for tag, snap_path in (("step10240", None), ("step512", base)):
            if snap_path is not None:
                tb.load_snapshot(snap_path)
                impl = tb.impl
                impl.render_max_samples_per_ray = None
            e = err_map(0)
            flat = np.sort(e.reshape(-1))[::-1]
            total = float(flat.sum())
            anatomy[tag] = {
                "mse": round(float(e.mean()), 6),
                "top1pct_share": round(
                    float(flat[:len(flat) // 100].sum()) / total, 4),
                "top01pct_share": round(
                    float(flat[:len(flat) // 1000].sum()) / total, 4),
                "p99_err": round(float(flat[len(flat) // 100]), 6),
                "median_err": round(float(np.median(flat)), 8)}
            write_image(os.path.join(OUT, f"err_{tag}_r5.png"),
                        np.clip(np.sqrt(e / max(e.max(), 1e-9))[..., None]
                                * np.ones(3), 0, 1).astype(np.float32))
            print(tag, anatomy[tag], flush=True)
        report["error_anatomy_view0"] = anatomy
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
