#!/usr/bin/env python3
"""Reference-grade mode renders (VERDICT r4 #8).

The round-4 walkthrough artifacts were quick-mode existence proofs
(100-step SDF speckle, 150px volume dots, one flat cube). This script
produces renders a reviewer can hold against the reference's output
class:

  sdf      armadillo trained properly, 512^2 GGX + soft shadow
           (evaluate_shading, testbed_sdf.cu:76-145), plus the
           raytraced-GT pair from the same camera and a Normals view.
  volume   256^2 model/GT delta-tracking pair on the synthetic blob.
  geometry data/geometry assets: bunny + two cubes with distinct BRDFs
           (GGX highlights visible) + a trained fox NeRF object
           composited into the scene (testbed_geometry.cu:2156 class).

Writes walkthrough_out/{sdf_shade_r5,sdf_gt_r5,sdf_normals_r5,
volume_r5,volume_gt_r5,geometry_r5}.png and mode_renders_r5.json with
IoU / run metadata.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

REPO = os.path.join(os.path.dirname(__file__), "..")
OUT = os.path.join(REPO, "walkthrough_out")
DATA = os.environ.get("INGP_DATA", "/root/reference/data")
META = {}


def _save(img, name):
    from instant_ngp_tpu.data.images import write_image

    write_image(os.path.join(OUT, name),
                np.clip(np.asarray(img, np.float32)[..., :3], 0, 1))
    print("wrote", name, flush=True)


def sdf_arm(steps: int):
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.sdf import SdfTestbed

    cfg = load_network_config(find_network_config("base.json", mode="sdf"))
    tb = SdfTestbed(os.path.join(DATA, "sdf", "armadillo.obj"), cfg)
    t0 = time.perf_counter()
    tb.train(steps, batch_size=1 << 18)
    iou = tb.calculate_iou(1 << 18)
    META["sdf"] = {"steps": steps, "iou": round(float(iou), 4),
                   "train_s": round(time.perf_counter() - t0, 1),
                   "loss": round(float(tb.loss_scalar), 6)}
    print("sdf:", META["sdf"], flush=True)
    # 3/4 view from the front-left, light from the upper right
    c = np.array([0.5, 0.5, 0.5], np.float32)
    eye = c + np.array([-0.9, 0.25, 1.5], np.float32)
    f = c - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, [0, 1, 0])
    r /= np.linalg.norm(r)
    up = np.cross(f, r)
    cam = np.stack([r, up, f, eye], axis=1).astype(np.float32)
    _save(tb.render_frame(512, 512, cam, focal_length=640.0),
          "sdf_shade_r5.png")
    _save(tb.render_frame(512, 512, cam, focal_length=640.0,
                          render_mode="Normals"), "sdf_normals_r5.png")
    _save(tb.render_frame(512, 512, cam, focal_length=640.0, use_gt=True),
          "sdf_gt_r5.png")


def volume_arm(steps: int):
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.volume import VolumeTestbed

    g = np.mgrid[0:96, 0:96, 0:96].astype(np.float32) / 96 - 0.5
    # two-lobe blob so structure (not just a disc) is visible
    d1 = 9.0 * np.exp(-np.sum((g - np.array([0.08, 0.05, 0.0]
                                            )[:, None, None, None]) ** 2,
                              0) / 0.02)
    d2 = 6.0 * np.exp(-np.sum((g + np.array([0.12, 0.1, 0.0]
                                            )[:, None, None, None]) ** 2,
                              0) / 0.012)
    dens = np.maximum(d1, d2)
    dens[dens < 0.01] = 0
    cfg = load_network_config(find_network_config("base.json",
                                                  mode="volume"))
    tb = VolumeTestbed(dens.astype(np.float32), cfg)
    t0 = time.perf_counter()
    tb.train(steps, batch_size=1 << 17)
    META["volume"] = {"steps": steps,
                      "train_s": round(time.perf_counter() - t0, 1),
                      "loss": round(float(tb.loss_scalar), 6)}
    print("volume:", META["volume"], flush=True)
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -0.7]],
                   np.float32)
    _save(tb.render_frame(256, 256, cam), "volume_r5.png")
    _save(tb.render_frame(256, 256, cam, use_gt=True), "volume_gt_r5.png")


def geometry_arm(nerf_steps: int):
    import jax.numpy as jnp

    from instant_ngp_tpu.geometry import GeometryTestbed
    from instant_ngp_tpu.testbed import Testbed

    # the scene's NeRF object: prefer the fully-trained fox snapshot
    # from the quality run; fall back to training one quickly
    snap = os.path.join(OUT, "fox_r4_default_resume.ingp")
    if not os.path.isfile(snap):
        snap = os.path.join(OUT, "geometry_fox_obj.ingp")
    if not os.path.isfile(snap):
        tb = Testbed()
        tb.load_training_data(os.path.join(DATA, "nerf", "fox"))
        tb.reload_network_from_file("base.json")
        tb.impl.rays_per_batch = 1 << 11
        tb.impl.adapt_ray_batch = False
        tb.train(nerf_steps)
        tb.save_snapshot(snap)
        print("fox object snapshot saved", flush=True)

    # asset frames differ wildly (bunny ~0.15 units at origin, cube1
    # spans z -3..-1, cube2 sits at 5..6): scale/center them into one
    # composition — bunny front-center, cubes flanking, fox NeRF behind
    scene = {"geometry": [
        {"center": [0.0, -0.6, 0.0], "scale": 12.0,
         "path": os.path.join(DATA, "geometry", "objs", "bunny.obj"),
         "type": "Mesh"},
        {"center": [2.6, -0.6, 2.3], "scale": 0.7,
         "path": os.path.join(DATA, "geometry", "objs", "cube1.obj"),
         "type": "Mesh"},
        {"center": [-8.0, -6.2, -5.5],
         "path": os.path.join(DATA, "geometry", "objs", "cube2.obj"),
         "type": "Mesh"},
        {"center": [-0.5, -0.7, -3.6], "path": snap, "type": "Nerf"},
    ]}
    scene_path = os.path.join(OUT, "geometry_scene_r5.json")
    with open(scene_path, "w") as f:
        json.dump(scene, f)
    tb = GeometryTestbed(scene_path)
    # distinct BRDFs so the GGX highlights read (metallic cube, rough
    # matte cube, dielectric bunny)
    tb.meshes[0].brdf.basecolor = np.array([0.65, 0.28, 0.2], np.float32)
    tb.meshes[0].brdf.roughness = 0.25
    tb.meshes[1].brdf.basecolor = np.array([0.3, 0.45, 0.8], np.float32)
    tb.meshes[1].brdf.metallic = 0.4
    tb.meshes[1].brdf.roughness = 0.15
    tb.meshes[2].brdf.basecolor = np.array([0.25, 0.6, 0.3], np.float32)
    tb.meshes[2].brdf.roughness = 0.6

    # frame on the MESH objects (a NeRF object's aabb is the whole
    # aabb_scale box, far larger than its visible content)
    aabbs = np.array([m.aabb for m in tb.meshes], np.float32)
    lo, hi = aabbs[:, 0].min(0), aabbs[:, 1].max(0)
    c = (lo + hi) / 2
    ext = float((hi - lo).max())
    eye = c + np.array([0.25, 0.4, 1.15]) * ext
    f = c - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, [0, 1, 0])
    r /= np.linalg.norm(r)
    cam = np.stack([r, np.cross(f, r), f, eye], axis=1).astype(np.float32)
    t0 = time.perf_counter()
    gw = int(os.environ.get("INGP_GEOM_W", "640"))
    gh = int(os.environ.get("INGP_GEOM_H", "512"))
    img = tb.render_frame(gw, gh, cam, focal_length=gw * 0.875)
    META["geometry"] = {
        "objects": [f"mesh:{len(tb.meshes)}", f"nerf:{len(tb.nerfs)}"],
        "render_s": round(time.perf_counter() - t0, 1)}
    print("geometry:", META["geometry"], flush=True)
    _save(img, "geometry_r5.png")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arms", nargs="*",
                    default=["sdf", "volume", "geometry"])
    ap.add_argument("--sdf-steps", type=int, default=2000)
    ap.add_argument("--volume-steps", type=int, default=3000)
    ap.add_argument("--geometry-nerf-steps", type=int, default=2048)
    args = ap.parse_args()
    os.makedirs(OUT, exist_ok=True)
    for arm in args.arms:
        if arm == "sdf":
            sdf_arm(args.sdf_steps)
        elif arm == "volume":
            volume_arm(args.volume_steps)
        elif arm == "geometry":
            geometry_arm(args.geometry_nerf_steps)
        with open(os.path.join(OUT, "mode_renders_r5.json"), "w") as f:
            json.dump(META, f, indent=1)
    print("done", flush=True)


if __name__ == "__main__":
    main()
