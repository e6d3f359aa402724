#!/usr/bin/env python3
"""Time-to-30dB on a scene that can reach it.

Fox is a real capture with an unknown PSNR ceiling; the north star
(BASELINE.md: lego-class 800x800 to >=30 dB) needs a NOISELESS scene.
This script uses the procedural sphere scene
(instant_ngp_tpu/data/procedural.py: an octant-checker sphere raytraced
analytically at 400x400 from 64 orbit cameras), trains the shipped
configs/nerf/base.json on it, and records the steps-to-PSNR /
time-to-PSNR curve until the target (or the step cap).

Eval: train-view eval (the scene has no test split, like the
reference's run.py on captures without --test_transforms), full-res,
spp 2, black bg, sRGB — run.py:252-268 semantics.

Writes walkthrough_out/time_to_30db_r5.json (wall-clock is TRAIN time
only; eval renders are excluded).

Reference operating point being matched: README.md:10-14 (paper link:
lego >=30 dB in the seconds-to-minutes class on an RTX 3090).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.join(os.path.dirname(__file__), "..")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default=os.path.join(REPO,
                                                      "walkthrough_out"))
    ap.add_argument("--target-db", type=float, default=30.0)
    ap.add_argument("--max-steps", type=int, default=20480)
    ap.add_argument("--eval-views", type=int, nargs="*",
                    default=[0, 16, 32, 48])
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import numpy as np
    import jax

    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.images import write_image
    from instant_ngp_tpu.data.procedural import make_scene
    from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed

    t0 = time.perf_counter()
    ds = make_scene(size=args.size, seed=args.seed)
    gen_s = time.perf_counter() - t0
    cfg = load_network_config(find_network_config("base.json",
                                                  mode="nerf"))
    tb = NerfTestbed(ds, cfg)
    tb.rays_per_batch = 1 << 11
    tb.adapt_ray_batch = False
    # unit-cube scene: rays cross up to ~1024 cone steps, so the eval
    # renderer's default 512-candidate cap TRUNCATES the far half of
    # the scene while the grid is still carving — an eval-side PSNR
    # ceiling unrelated to the model (render_probe_r5 mechanism)
    tb.render_max_samples_per_ray = tb.n_march

    def eval_avg():
        ps = [tb.eval_psnr(v, spp=2, downscale=1)
              for v in args.eval_views]
        return float(np.mean(ps)), [round(float(p), 3) for p in ps]

    report = {
        "scene": f"synthetic octant-checker sphere, {args.size}^2, "
                 "64 views, analytic noiseless GT",
        "backend": jax.default_backend(),
        "config": "configs/nerf/base.json (shipped default)",
        "eval_protocol": {"views": args.eval_views, "spp": 2,
                          "downscale": 1, "bg": "black",
                          "note": "train-view eval, run.py:252-268 "
                                  "semantics; wall-clock excludes "
                                  "eval renders"},
        "scene_gen_s": round(gen_s, 1),
        "curve": [],
        "crossings_db": {},
    }
    path = os.path.join(args.out_dir, "time_to_30db_r5.json")

    tb.train(1)  # compile warm-up outside the timed window
    milestones = [128, 256, 512, 1024, 1536, 2048, 3072, 4096, 6144,
                  8192, 12288, 16384, 20480]
    t_train, trained = 0.0, tb.training_step
    best = 0.0
    for ms in milestones:
        if ms > args.max_steps:
            break
        t0 = time.perf_counter()
        tb.train(ms - trained)
        t_train += time.perf_counter() - t0
        trained = ms
        avg, per_view = eval_avg()
        best = max(best, avg)
        entry = {"step": ms, "train_time_s": round(t_train, 2),
                 "psnr_avg": round(avg, 3), "psnr_per_view": per_view,
                 "loss": round(float(tb.loss_scalar), 6)}
        report["curve"].append(entry)
        print(entry, flush=True)
        for db in (25, 28, 30, 32, 34):
            if avg >= db and str(db) not in report["crossings_db"]:
                report["crossings_db"][str(db)] = {
                    "step": ms, "train_time_s": round(t_train, 2)}
        with open(path, "w") as f:
            json.dump(report, f, indent=1)
        if avg >= args.target_db + 2.0:
            break
    report["reached_target"] = best >= args.target_db
    report["best_psnr"] = round(best, 3)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    img = tb.render_training_view(0, spp=4)
    write_image(os.path.join(args.out_dir, "synth_30db_view0_r5.png"),
                np.clip(img[..., :3], 0, 1).astype(np.float32))
    print("wrote", path, flush=True)


if __name__ == "__main__":
    main()
