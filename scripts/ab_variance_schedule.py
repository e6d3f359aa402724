#!/usr/bin/env python3
"""A/B the coarse-to-fine variance schedule on the precision-regression
workloads (image + SDF), producing the committed artifact behind the
config-zoo default `stochastic_corners_until=256`.

Three arms per workload:
  exact       - stochastic_corners=False (the reference's semantics:
                every corner gathered every step)
  stochastic  - all-stochastic (schedule disabled, until=None)
  scheduled   - the shipped default: stochastic warmup for 256 steps,
                exact d-linear encode after

Metrics: albert.exr quarter-res fit PSNR @ --steps (reference workflow
scripts/run.py image mode) and armadillo.obj IoU @ --steps
(calculate_iou, reference testbed_sdf.cu:1363-1399).

Writes walkthrough_out/variance_schedule_ab.json.

Usage: python scripts/ab_variance_schedule.py [--steps 1000] [--cpu]
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REPO = os.path.join(os.path.dirname(__file__), "..")
ALBERT = "/root/reference/data/image/albert.exr"
ARMADILLO = "/root/reference/data/sdf/armadillo.obj"


def run_image(steps: int, arm: str) -> dict:
    import numpy as np

    from instant_ngp_tpu.config import load_network_config
    from instant_ngp_tpu.data.exr import read_exr
    from instant_ngp_tpu.image.testbed_image import ImageTestbed

    cfg = load_network_config(
        os.path.join(REPO, "configs/image/base.json"))
    img, _ = read_exr(ALBERT)
    img = np.asarray(img, np.float32)[::4, ::4]   # quarter res
    tb = ImageTestbed(img, cfg)
    if arm == "exact":
        tb.stochastic_corners = False
    elif arm == "stochastic":
        tb.stochastic_corners_until = None
    # "scheduled": config default (256)
    t0 = time.perf_counter()
    tb.train(steps)
    wall = time.perf_counter() - t0
    return {"psnr_db": round(tb.psnr(), 2), "train_s": round(wall, 1)}


def run_sdf(steps: int, arm: str) -> dict:
    from instant_ngp_tpu.config import load_network_config
    from instant_ngp_tpu.sdf.testbed_sdf import SdfTestbed

    cfg = load_network_config(os.path.join(REPO, "configs/sdf/base.json"))
    tb = SdfTestbed(ARMADILLO, cfg)
    if arm == "exact":
        tb.stochastic_corners = False
    elif arm == "stochastic":
        tb.stochastic_corners_until = None
    t0 = time.perf_counter()
    tb.train(steps)
    wall = time.perf_counter() - t0
    return {"iou": round(tb.calculate_iou(n_samples=64 ** 3), 4),
            "train_s": round(wall, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--out", default=os.path.join(
        REPO, "walkthrough_out", "variance_schedule_ab.json"))
    args = ap.parse_args()

    import jax

    report = {
        "backend": jax.devices()[0].platform,
        "steps": args.steps,
        "schedule": {"stochastic_corners_until": 256},
        "image_albert_quarter": {},
        "sdf_armadillo": {},
    }
    for arm in ("exact", "stochastic", "scheduled"):
        report["image_albert_quarter"][arm] = run_image(args.steps, arm)
        print("image", arm, report["image_albert_quarter"][arm],
              flush=True)
    for arm in ("exact", "stochastic", "scheduled"):
        report["sdf_armadillo"][arm] = run_sdf(args.steps, arm)
        print("sdf", arm, report["sdf_armadillo"][arm], flush=True)

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print("wrote", args.out)


if __name__ == "__main__":
    main()
