#!/usr/bin/env python3
"""Headless driver + eval harness (reference scripts/run.py, 338 LoC).

Train any testbed mode from the CLI, save/load snapshots, render
screenshots, and run the PSNR/SSIM eval loop over training transforms
(--test_transforms semantics: spp 8, black background, min transmittance
1e-4 — run.py:210-268).
"""

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def parse_args():
    p = argparse.ArgumentParser(
        description="Run instant_ngp_tpu with a scene, train, eval.")
    p.add_argument("files", nargs="*", default=[],
                   help="files to load (scene, snapshot, config)")
    p.add_argument("--scene", default="", help="scene to load")
    p.add_argument("--network", default="", help="network config name/path")
    p.add_argument("--load_snapshot", default="")
    p.add_argument("--save_snapshot", default="")
    p.add_argument("--n_steps", type=int, default=-1,
                   help="training steps (default 35000 when training)")
    p.add_argument("--screenshot_transforms", default="")
    p.add_argument("--screenshot_frames", nargs="*")
    p.add_argument("--screenshot_dir", default="")
    p.add_argument("--screenshot_spp", type=int, default=16)
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--test_transforms", default="",
                   help="transforms.json for PSNR/SSIM eval")
    p.add_argument("--eval_downscale", type=int, default=1)
    p.add_argument("--eval_views", type=int, default=0,
                   help="limit number of eval views (0 = all)")
    p.add_argument("--eval_spp", type=int, default=8,
                   help="samples per pixel for --test_transforms eval")
    p.add_argument("--flip", action="store_true",
                   help="also report the FLIP perceptual metric")
    p.add_argument("--nerf_compatibility", action="store_true",
                   help="match paper conditions: sRGB space, cone angle 0")
    p.add_argument("--train", action="store_true")
    p.add_argument("--save_mesh", default="",
                   help="extract + save a marching-cubes mesh (nerf mode)")
    p.add_argument("--marching_cubes_res", type=int, default=256)
    p.add_argument("--video_camera_path", default="",
                   help="camera path JSON to render to video")
    p.add_argument("--video_n_seconds", type=float, default=1.0)
    p.add_argument("--video_fps", type=float, default=30.0)
    p.add_argument("--video_output", default="video_frames")
    p.add_argument("--video_spp", type=int, default=4)
    p.add_argument("--mode", default="",
                   help="force a testbed mode (nerf/sdf/image/volume/"
                        "geometry; reference --Geometry flag equivalent)")
    return p.parse_args()


def main():
    args = parse_args()
    from instant_ngp_tpu.common import TestbedMode
    from instant_ngp_tpu.testbed import Testbed

    testbed = Testbed()

    for f in args.files:
        testbed.load_file(f)
    if args.scene:
        testbed.load_training_data(args.scene)
    if args.network:
        testbed.reload_network_from_file(args.network)
    elif testbed.impl is None and testbed.data_path:
        testbed.reload_network_from_file("base.json")
    if args.load_snapshot:
        testbed.load_snapshot(args.load_snapshot)
        testbed.apply_pending_snapshot()

    if args.nerf_compatibility and testbed.mode == TestbedMode.Nerf:
        # paper conditions (reference run.py:151-170): sRGB accumulation
        # (our default training color space — pinned here), no
        # exponential cone stepping, fixed black background instead of
        # the random background color, and — for gradient-parity-exact
        # runs — the exact d-linear encode instead of the stochastic
        # estimator family
        testbed.impl.scene.cone_angle_constant = 0.0
        testbed.impl.random_bg_color = False
        testbed.impl.train_in_linear_colors = False
        testbed.impl.stochastic_corners = False
        testbed.impl._train_fns.clear()

    n_steps = args.n_steps
    if n_steps < 0 and not args.load_snapshot:
        n_steps = 35000

    if n_steps > 0:
        print(f"training {n_steps} steps...")
        t0 = time.time()
        log_every = max(n_steps // 50, 1)
        done = 0
        while done < n_steps:
            chunk = min(log_every, n_steps - done)
            loss = testbed.train(chunk)
            done += chunk
            dt = time.time() - t0
            print(f"  step={testbed.training_step} loss={loss:.6f} "
                  f"({done / dt:.1f} steps/s)", flush=True)
        print(f"trained in {time.time() - t0:.1f}s")

    if args.save_snapshot:
        testbed.save_snapshot(args.save_snapshot)
        print("saved snapshot", args.save_snapshot)

    if args.test_transforms and testbed.mode == TestbedMode.Nerf:
        # reference run.py:210-268: load the GIVEN transforms, render each
        # of ITS views at spp 8 / black bg / min transmittance 1e-4,
        # report PSNR avg/min/max + SSIM (+FLIP with --flip)
        from instant_ngp_tpu.eval import eval_test_transforms

        r = eval_test_transforms(
            testbed.impl, args.test_transforms, spp=args.eval_spp,
            limit=args.eval_views, downscale=args.eval_downscale,
            with_flip=args.flip)
        line = (f"PSNR avg={r['psnr_avg']:.3f} min={r['psnr_min']:.3f} "
                f"max={r['psnr_max']:.3f} SSIM avg={r['ssim_avg']:.4f}")
        if args.flip:
            line += f" FLIP avg={r['flip_avg']:.4f}"
        print(line)

    if args.save_mesh and testbed.mode == TestbedMode.Nerf:
        testbed.save_mesh(args.save_mesh,
                          resolution=args.marching_cubes_res)
        print("saved mesh", args.save_mesh)

    if args.video_camera_path:
        from instant_ngp_tpu.camera_path import CameraPath, render_video

        cp = CameraPath.load(args.video_camera_path)
        cp.duration_seconds = args.video_n_seconds
        cp.fps = args.video_fps
        out = render_video(testbed, cp, args.video_output,
                           spp=args.video_spp)
        print("rendered camera path to", out)

    if args.screenshot_transforms:
        # reference run.py:128-139,276-303: render a screenshot per frame
        # of the given transforms file, through the NeRF->NGP camera
        # conversion and the file's camera_angle_x fov, named after each
        # frame's file_path
        from instant_ngp_tpu.data.images import write_image

        with open(args.screenshot_transforms) as f:
            ref_transforms = json.load(f)
        frames = ref_transforms["frames"]
        idxs = (range(len(frames)) if not args.screenshot_frames
                else [int(i) for i in args.screenshot_frames])
        w = args.width or int(ref_transforms.get("w", 1920))
        h = args.height or int(ref_transforms.get("h", 1080))
        impl = testbed.impl
        fl = None
        if "camera_angle_x" in ref_transforms:
            # fov_axis = 0 (reference :277-278)
            fx = 0.5 * w / math.tan(
                0.5 * float(ref_transforms["camera_angle_x"]))
            fl = np.array([fx, fx], np.float32)
        out_dir = args.screenshot_dir or "."
        for idx in idxs:
            fr = frames[int(idx)]
            m = np.asarray(fr.get("transform_matrix",
                                  fr.get("transform_matrix_start")),
                           np.float32)
            cam = impl.dataset.nerf_matrix_to_ngp(m[:3, :4])
            outname = os.path.join(out_dir,
                                   os.path.basename(fr["file_path"]))
            if not os.path.splitext(outname)[1]:
                outname += ".png"
            img = impl.render_frame(w, h, cam, focal_length=fl,
                                    spp=args.screenshot_spp)
            os.makedirs(os.path.dirname(outname) or ".", exist_ok=True)
            write_image(outname, img.astype(np.float32))
            print("wrote", outname)
    elif args.screenshot_dir:
        os.makedirs(args.screenshot_dir, exist_ok=True)
        from instant_ngp_tpu.data.images import write_image

        img = testbed.render(args.width, args.height,
                             spp=args.screenshot_spp)
        out = os.path.join(args.screenshot_dir, "screenshot.png")
        write_image(out, img.astype(np.float32))
        print("wrote", out)


if __name__ == "__main__":
    main()
