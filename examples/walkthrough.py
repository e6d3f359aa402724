#!/usr/bin/env python3
"""End-to-end walkthrough of every testbed mode (the reference ships this
as notebooks/instant_ngp.ipynb; here it's an executable script).

Runs small-scale versions of each workload against the reference data
assets and writes outputs under ./walkthrough_out. CPU-friendly sizes;
pass --full for the real thing on the GPU.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..", "walkthrough_out")
DATA = os.environ.get("INGP_DATA", "/root/reference/data")


def image_demo(full: bool):
    print("== image mode: fitting albert.exr ==")
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.images import read_image, write_image
    from instant_ngp_tpu.image import ImageTestbed

    img = read_image(os.path.join(DATA, "image", "albert.exr"))
    if not full:
        img = img[::4, ::4]
    cfg = load_network_config(find_network_config("base.json", mode="image"))
    if not full:
        cfg["encoding"]["log2_hashmap_size"] = 16
    tb = ImageTestbed(img, cfg)
    tb.train(200 if not full else 2000,
             batch_size=1 << (14 if not full else 18))
    print(f"   PSNR: {tb.psnr():.2f} dB")
    write_image(os.path.join(OUT, "image_fit.png"),
                tb.render(img.shape[1], img.shape[0]).astype(np.float32))


def nerf_demo(full: bool):
    print("== nerf mode: fox ==")
    from instant_ngp_tpu.testbed import Testbed

    tb = Testbed()
    tb.load_file(os.path.join(DATA, "nerf", "fox"))
    if not full:
        tb.impl.target_batch_size = 1 << 14
        tb.impl.rays_per_batch = 1 << 10
        tb.impl.n_march = 192
        tb.impl.max_samples_per_ray = 64
        tb.impl.density_samples_override = 1 << 17
    tb.train(512 if not full else 2000)
    print(f"   loss: {tb.loss:.5f}")
    from instant_ngp_tpu.data.images import write_image

    img = tb.impl.render_training_view(0, width=240, height=135)
    write_image(os.path.join(OUT, "nerf_view0.png"), img.astype(np.float32))
    tb.save_snapshot(os.path.join(OUT, "fox.ingp"))


def sdf_demo(full: bool):
    print("== sdf mode: armadillo ==")
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.images import write_image
    from instant_ngp_tpu.sdf import SdfTestbed

    cfg = load_network_config(find_network_config("base.json", mode="sdf"))
    cfg["optimizer"]["nested"]["nested"]["learning_rate"] = 2e-3
    tb = SdfTestbed(os.path.join(DATA, "sdf", "armadillo.obj"), cfg)
    tb.train(100 if not full else 2000,
             batch_size=1 << (14 if not full else 18))
    print(f"   IoU: {tb.calculate_iou(1 << 16):.3f}")
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.2]],
                   np.float32)
    write_image(os.path.join(OUT, "sdf_shade.png"),
                tb.render_frame(240, 240, cam).astype(np.float32))


def volume_demo(full: bool):
    print("== volume mode: synthetic blob ==")
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    from instant_ngp_tpu.data.images import write_image
    from instant_ngp_tpu.volume import VolumeTestbed

    g = np.mgrid[0:64, 0:64, 0:64].astype(np.float32) / 64 - 0.5
    dens = 8.0 * np.exp(-np.sum(g ** 2, 0) / 0.03)
    dens[dens < 0.01] = 0
    cfg = load_network_config(find_network_config("base.json",
                                                  mode="volume"))
    tb = VolumeTestbed(dens.astype(np.float32), cfg)
    # ~1500 steps before the predicted density approaches the GT
    # majorant (8.0) — below that, delta tracking keeps the blob nearly
    # transparent and the render reads as blank
    tb.train(1500 if not full else 3000,
             batch_size=1 << (14 if not full else 17))
    cam = np.array([[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, 1, -0.6]],
                   np.float32)
    write_image(os.path.join(OUT, "volume.png"),
                tb.render_frame(160, 160, cam).astype(np.float32))
    # GT delta-tracked render of the same view — the oracle the model
    # is trained against (volume_render_kernel_gt, testbed_volume.cu:280)
    write_image(os.path.join(OUT, "volume_gt.png"),
                tb.render_frame(160, 160, cam,
                                use_gt=True).astype(np.float32))


def geometry_demo(full: bool):
    print("== geometry mode: reference scene ==")
    from instant_ngp_tpu.data.images import write_image
    from instant_ngp_tpu.geometry import GeometryTestbed

    tb = GeometryTestbed(os.path.join(DATA, "geometry",
                                      "geometrypaths.json"))
    m = tb.meshes[0]
    c = (m.aabb[0] + m.aabb[1]) / 2
    ext = (m.aabb[1] - m.aabb[0]).max()
    eye = c + np.array([0.6, 0.7, 1.8]) * ext
    f = c - eye
    f /= np.linalg.norm(f)
    r = np.cross(f, [0, 1, 0])
    r /= np.linalg.norm(r)
    cam = np.stack([r, np.cross(f, r), f, eye], axis=1).astype(np.float32)
    write_image(os.path.join(OUT, "geometry.png"),
                tb.render_frame(240, 240, cam).astype(np.float32))


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--full", action="store_true")
    p.add_argument("--modes", nargs="*",
                   default=["image", "nerf", "sdf", "volume", "geometry"])
    args = p.parse_args()
    os.makedirs(OUT, exist_ok=True)
    t0 = time.time()
    for mode in args.modes:
        globals()[f"{mode}_demo"](args.full)
    print(f"walkthrough done in {time.time() - t0:.0f}s -> {OUT}")
