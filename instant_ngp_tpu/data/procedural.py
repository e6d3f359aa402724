"""Procedural scenes generated from a seed, so training runs need no
downloaded data.

The NeRF scene is a lambertian sphere (r=0.22 at the box centre) with an
octant-checker albedo and a smooth latitude band, raytraced analytically
over black from orbit cameras with headlight shading. Its ground truth
is noiseless, so a run can be held to an absolute PSNR.

- `make_scene` returns the in-memory `NerfDataset`.
- `write_scene` saves the same views as `transforms.json` plus EXR
  frames (linear, alpha-premultiplied), loadable by `load_nerf`,
  `Testbed.load_training_data` and `scripts/run.py --scene`.
- `make_image` renders one view as a linear RGBA image for image mode.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..common import srgb_to_linear
from .nerf_loader import FrameMetadata, Lens, NerfDataset

_CENTER = np.array([0.5, 0.5, 0.5], np.float32)
_PALETTE = np.array(
    [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9],
     [0.9, 0.9, 0.2], [0.9, 0.2, 0.9], [0.2, 0.9, 0.9],
     [0.95, 0.6, 0.2], [0.85, 0.85, 0.85]], np.float32)


def look_at(eye, center, up) -> np.ndarray:
    """(3, 4) NGP-space camera at `eye` looking at `center`."""
    f = center - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, up)
    r = r / np.linalg.norm(r)
    u = np.cross(f, r)
    return np.stack([r, u, f, eye], axis=1).astype(np.float32)


def raytrace_view(cam: np.ndarray, size: int, focal: float) -> np.ndarray:
    """Analytic ground truth of one (size x size) view: (H, W, 4) uint8
    sRGB with alpha = sphere coverage."""
    r = 0.22
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) + 0.5
    dirs = np.stack([(xx - size / 2) / focal, (yy - size / 2) / focal,
                     np.ones_like(xx)], -1)
    dirs = dirs @ cam[:3, :3].T
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    o = cam[:3, 3]
    oc = o - _CENTER
    b = np.einsum("hwc,c->hw", dirs, oc)
    disc = b * b - (oc @ oc - r * r)
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + dirs * t[..., None]
    n = (p - _CENTER) / r
    # octant checker albedo + smooth band so the target has both sharp
    # and smooth structure
    octant = ((n[..., 0] > 0).astype(int) + (n[..., 1] > 0).astype(int)
              * 2 + (n[..., 2] > 0).astype(int) * 4)
    band = 0.5 + 0.5 * np.sin(12.0 * np.arcsin(np.clip(n[..., 1],
                                                       -1, 1)))
    albedo = _PALETTE[octant] * (0.6 + 0.4 * band[..., None])
    lam = np.clip(-np.einsum("hwc,hwc->hw", n, dirs), 0.0, 1.0)
    shade = albedo * (0.25 + 0.75 * lam[..., None])
    srgb = np.where(shade <= 0.0031308, shade * 12.92,
                    1.055 * shade ** (1 / 2.4) - 0.055)
    img = np.zeros((size, size, 4), np.float32)
    img[..., :3] = np.where(hit[..., None], srgb, 0.0)
    img[..., 3] = hit.astype(np.float32)
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def orbit_cameras(n_cams: int, seed: int = 0) -> np.ndarray:
    """(n_cams, 3, 4) cameras on a ring around the box centre, each at a
    seeded random elevation."""
    rng = np.random.RandomState(seed)
    cams = []
    for i in range(n_cams):
        ang = i / n_cams * 2 * np.pi
        elev = 0.15 + 0.5 * rng.rand()
        eye = np.array([0.5 + 0.85 * np.cos(ang) * np.cos(elev),
                        0.5 + 0.85 * np.sin(elev),
                        0.5 + 0.85 * np.sin(ang) * np.cos(elev)],
                       np.float32)
        cams.append(look_at(eye, _CENTER, np.array([0, 1, 0], np.float32)))
    return np.stack(cams)


def make_scene(n_cams: int = 64, size: int = 400,
               seed: int = 0) -> NerfDataset:
    """The sphere scene as an in-memory LDR dataset, aabb_scale 1."""
    focal = size * 1.1
    cams = orbit_cameras(n_cams, seed)
    metas = [FrameMetadata((size, size), np.array([focal, focal], np.float32),
                           np.array([0.5, 0.5], np.float32),
                           np.zeros(4, np.float32), Lens())
             for _ in range(n_cams)]
    ds = NerfDataset(paths=[f"synth{i}" for i in range(n_cams)],
                     images=[raytrace_view(c, size, focal) for c in cams],
                     depths=[None] * n_cams, rays=[None] * n_cams,
                     metadata=metas, xforms_start=cams, xforms_end=cams)
    ds.aabb_scale = 1
    return ds


def linear_rgba(img: np.ndarray) -> np.ndarray:
    """uint8 sRGB RGBA -> float32 linear RGB premultiplied by alpha (the
    colour the trainer reads from an LDR frame)."""
    val = img.astype(np.float32) / 255.0
    out = val.copy()
    out[..., :3] = srgb_to_linear(val[..., :3]) * val[..., 3:4]
    return out


def write_scene(out_dir: str, n_cams: int = 64, size: int = 400,
                seed: int = 0) -> str:
    """Write the sphere scene as `transforms.json` + EXR frames under
    `out_dir`; returns the path of `transforms.json`."""
    from .exr import write_exr

    ds = make_scene(n_cams, size, seed)
    os.makedirs(os.path.join(out_dir, "frames"), exist_ok=True)
    frames = []
    for i, (img, cam) in enumerate(zip(ds.images, ds.xforms_start)):
        rel = f"frames/r_{i:03d}.exr"
        write_exr(os.path.join(out_dir, rel), linear_rgba(img))
        m = np.eye(4, dtype=np.float32)
        m[:3] = ds.ngp_matrix_to_nerf(cam)
        frames.append({"file_path": rel,
                       "transform_matrix": m.tolist()})
    meta = ds.metadata[0]
    path = os.path.join(out_dir, "transforms.json")
    with open(path, "w") as f:
        json.dump({"fl_x": float(meta.focal_length[0]),
                   "fl_y": float(meta.focal_length[1]),
                   "w": size, "h": size,
                   "aabb_scale": ds.aabb_scale,
                   "frames": frames}, f, indent=1)
    return path


def make_image(size: int = 1024, seed: int = 0) -> np.ndarray:
    """One (size x size) view of the sphere scene as linear float32 RGBA,
    for image-mode fitting."""
    cam = orbit_cameras(1, seed)[0]
    return linear_rgba(raytrace_view(cam, size, size * 1.1))


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="Write the procedural sphere scene (transforms.json + "
                    "EXR frames), or with --image one view as an EXR.")
    ap.add_argument("out", help="scene directory, or EXR path with --image")
    ap.add_argument("--views", type=int, default=64)
    ap.add_argument("--size", type=int, default=400)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--image", action="store_true")
    args = ap.parse_args(argv)
    if args.image:
        from .exr import write_exr

        write_exr(args.out, make_image(args.size, args.seed))
        print(args.out)
    else:
        print(write_scene(args.out, args.views, args.size, args.seed))


if __name__ == "__main__":
    main()
