"""Training-ray generation + occupancy-guided marching.

Replaces generate_training_samples_nerf (src/testbed_nerf.cu:679-838).
The CUDA design is two ragged passes with atomic compaction (SURVEY.md
§7 hard parts). Here, with static shapes throughout:

1. `generate_rays`: pick a training image and pixel per ray lane
   (uniform; error-CDF importance sampling plugs in later), build the ray
   through the per-image lens/rolling-shutter camera, clip to the aabb,
   jitter the start along the first step (matching `startt =
   advance_n_steps(tmin, cone, rand)`).

2. `march_rays`: evaluates occupancy at an ANALYTIC (R, K) candidate
   grid — every position the reference's sequential DDA march could
   visit is `from_stepping_space(s0 + k)`, so emissions are computed for
   all k in parallel with zero sequential dependence (see the function
   docstring for the equivalence argument). No scan, no unroll.

3. `compact_samples`: ray-major prefix-sum compaction of the masked
   stream into a flat (capacity,) sample buffer plus per-ray (base,
   count). Deterministic (unlike the reference's atomic ordering), static
   shapes, and the network then runs on a dense batch with zero padding
   waste — the static-shape analog of the reference's count-then-write.

Sample payload matches NerfCoordinate: warped position in [0,1]^3, warped
direction dir/2+0.5, warped dt (nerf_device.cuh:144-199).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import uv_to_ray, xform_with_rolling_shutter
from ..common import NERF_CASCADES
from .dataset import NerfTrainingData, read_rgba
from .march import (MAX_DEPTH, advance_n_steps, aabb_contains, calc_dt,
                    density_grid_occupied_at_comps, from_stepping_space,
                    mip_from_dt_comps, mip_from_pos, ray_intersect_aabb,
                    to_stepping_space, warp_direction, warp_dt,
                    warp_position)

# float32 camera math must not run in TF32 on GPUs
_HIGHEST = jax.lax.Precision.HIGHEST


class RayBatch(NamedTuple):
    origins: jax.Array       # (R, 3) unnormalized ray origins
    dirs: jax.Array          # (R, 3) normalized directions
    t_start: jax.Array       # (R,) jittered march start
    img_idx: jax.Array       # (R,) source image
    uv: jax.Array            # (R, 2) pixel position
    rgba: jax.Array          # (R, 4) premultiplied linear target
    valid: jax.Array         # (R,) lane validity (masked pixels excluded)


class SampleBatch(NamedTuple):
    """Compacted flat samples + per-ray segment table.

    Vector quantities are STRUCTURE-OF-ARRAYS tuples of (S,) components
    (no materialized (S, 3) buffers)."""

    positions: Tuple[jax.Array, ...]  # 3 x (S,) warped
    dirs: Tuple[jax.Array, ...]       # 3 x (S,) warped
    dts: jax.Array           # (S,) warped
    t_mid: jax.Array         # (S,) unwarped ray distance of the sample
    ray_id: jax.Array        # (S,) source ray lane of each sample
    ray_base: jax.Array      # (R,) first sample index of each ray
    ray_count: jax.Array     # (R,) number of samples of each ray
    n_samples: jax.Array     # () total valid samples (<= S)
    cand_slot: jax.Array     # (R, M) flat sample index of each candidate;
    #                          >= S means "no kept sample here"
    cand_src: jax.Array      # (S,) flat candidate index (r*M + k) of each
    #                          sample; == R*M for the invalid tail


def rotvec_matrix(r: jax.Array) -> jax.Array:
    """(..., 3) axis-angle -> (..., 3, 3) rotation, differentiable AT ZERO.

    Uses the unnormalized Rodrigues form R = I + a K + b K^2 with
    a = sin(t)/t, b = (1-cos(t))/t^2 and Taylor branches near t=0, so the
    gradient is finite at r = 0 (a naive norm() has a NaN gradient there
    — camera-pose offsets start at exactly zero)."""
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    zero = jnp.zeros_like(rx)
    K = jnp.stack([
        jnp.stack([zero, -rz, ry], -1),
        jnp.stack([rz, zero, -rx], -1),
        jnp.stack([-ry, rx, zero], -1)], -2)
    t2 = jnp.sum(r * r, axis=-1)[..., None, None]
    small = t2 < 1e-8
    safe_t2 = jnp.where(small, 1.0, t2)
    t = jnp.sqrt(safe_t2)
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(t) / t)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(t)) / safe_t2)
    eye = jnp.broadcast_to(jnp.eye(3), K.shape)
    return eye + a * K + b * jnp.matmul(K, K, precision=_HIGHEST)


def build_rays(data: NerfTrainingData, img_idx: jax.Array, uv: jax.Array,
               motionblur_time: jax.Array, lens_mode: int,
               cam: Optional[Dict[str, jax.Array]] = None,
               distortion_map: Optional[jax.Array] = None):
    """uv+image -> (origins, dirs_normalized, valid); DIFFERENTIABLE in the
    per-image camera offsets `cam` = {"pos" (N,3) translation offsets,
    "rot" (N,3) axis-angle offsets, "focal" (2,) log-ish focal offset}.

    This is the differentiable half of generate_training_samples_nerf's
    ray setup; camera-gradient training chain-rules through it (the
    reference instead hand-derives dL/d(cam) in
    compute_cam_gradient_train_nerf, testbed_nerf.cu:1163-1270)."""
    res = data.resolutions[img_idx]                        # (R, 2) (w, h)
    xform = xform_with_rolling_shutter(
        data.xforms_start[img_idx], data.xforms_end[img_idx],
        data.rolling_shutter[img_idx], uv, motionblur_time)
    focal = data.focal_lengths[img_idx]
    if cam is not None:
        rot = rotvec_matrix(cam["rot"][img_idx])           # (R, 3, 3)
        new_rot = jnp.einsum("...ij,...jk->...ik", rot, xform[..., :3, :3],
                             precision=_HIGHEST)
        new_t = (xform[..., :3, 3] + cam["pos"][img_idx])[..., None]
        xform = jnp.concatenate([new_rot, new_t], axis=-1)
        focal = focal * (1.0 + cam["focal"][None, :])

    origins, dirs_un, ray_ok = uv_to_ray(
        uv, res, focal, xform, screen_center=(0.5, 0.5),
        lens_mode=lens_mode, lens_params=data.lens_params[img_idx],
        distortion_map=distortion_map)
    dirs = dirs_un / jnp.linalg.norm(dirs_un, axis=-1, keepdims=True)
    return origins, dirs, ray_ok


def sample_rays(key: jax.Array, data: NerfTrainingData, n_rays: int,
                snap_to_pixel_centers: bool = False,
                error_cdfs: Optional[Dict[str, jax.Array]] = None):
    """Pick (img_idx, uv, motionblur_time) per lane — uniform, or error-map
    importance sampled when CDFs are provided (image_idx +
    nerf_random_image_pos_training, nerf_device.cuh:500-598: half the
    sample mass stays uniform, half follows the error CDFs)."""
    k_img, k_uv, k_mb, k_mix = jax.random.split(key, 4)
    n_images = data.n_images

    if error_cdfs is None:
        img_idx = jax.random.randint(k_img, (n_rays,), 0, n_images)
        uv = jax.random.uniform(k_uv, (n_rays, 2))
    else:
        u_img = jax.random.uniform(k_img, (n_rays,))
        img_uniform = (u_img * n_images).astype(jnp.int32) % n_images
        img_cdf = jnp.searchsorted(error_cdfs["cdf_img"],
                                   u_img).astype(jnp.int32)
        use_cdf = jax.random.uniform(k_mix, (n_rays,)) >= 0.5
        img_idx = jnp.clip(jnp.where(use_cdf, img_cdf, img_uniform),
                           0, n_images - 1)

        # 2D CDF pixel pick: row via cdf_y[img], column via
        # cdf_x_cond_y[img, row]; half the mass stays uniform
        ch, cw = error_cdfs["cdf_y"].shape[1], \
            error_cdfs["cdf_x_cond_y"].shape[2]
        u2 = jax.random.uniform(k_uv, (n_rays, 2))
        u_mix = jax.random.uniform(jax.random.fold_in(k_mix, 1),
                                   (n_rays, 2))
        row = jax.vmap(jnp.searchsorted)(error_cdfs["cdf_y"][img_idx],
                                         u2[:, 1])
        row = jnp.clip(row, 0, ch - 1)
        col = jax.vmap(jnp.searchsorted)(
            error_cdfs["cdf_x_cond_y"][img_idx, row], u2[:, 0])
        col = jnp.clip(col, 0, cw - 1)
        jitter = jax.random.uniform(jax.random.fold_in(k_uv, 1),
                                    (n_rays, 2))
        uv_cdf = jnp.stack([(col + jitter[:, 0]) / cw,
                            (row + jitter[:, 1]) / ch], -1)
        uv = jnp.where((u_mix < 0.5), u_mix * 2.0, uv_cdf)

    if snap_to_pixel_centers:
        res = data.resolutions[img_idx]
        uv = (jnp.floor(uv * res) + 0.5) / res
    motionblur_time = jax.random.uniform(k_mb, (n_rays,))
    return img_idx, uv, motionblur_time


def generate_rays(key: jax.Array, data: NerfTrainingData, n_rays: int,
                  aabb_min, aabb_max, cone_angle: float, lens_mode: int,
                  snap_to_pixel_centers: bool = False,
                  cam: Optional[Dict[str, jax.Array]] = None,
                  error_cdfs: Optional[Dict[str, jax.Array]] = None,
                  distortion_map: Optional[jax.Array] = None
                  ) -> RayBatch:
    """One ray per lane from a random (image, pixel)."""
    k_pick, k_t = jax.random.split(key)
    img_idx, uv, motionblur_time = sample_rays(
        k_pick, data, n_rays, snap_to_pixel_centers, error_cdfs)

    res = data.resolutions[img_idx]                        # (R, 2) (w, h)
    px = (uv * res).astype(jnp.int32)
    rgba = read_rgba(data.pixels, img_idx, px)
    valid = rgba[:, 0] >= 0.0  # hot-pink mask → skip lane

    origins, dirs, ray_ok = build_rays(data, img_idx, uv, motionblur_time,
                                       lens_mode, cam, distortion_map)
    valid = valid & ray_ok

    tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
    tmin = jnp.maximum(tmin, 0.0)
    valid = valid & (tmax >= tmin)

    # jitter start by a random fraction of one step (testbed_nerf.cu:781)
    t_start = advance_n_steps(tmin, cone_angle,
                              jax.random.uniform(k_t, (n_rays,)))
    return RayBatch(origins, dirs, t_start, img_idx, uv, rgba, valid), \
        motionblur_time


def march_rays(rays: RayBatch, bitfield: jax.Array, aabb_min, aabb_max,
               cone_angle: float, max_mip: int, n_march: int,
               max_samples_per_ray: int
               ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Occupancy-guided march over an ANALYTIC candidate grid.

    Returns (ts, dts, is_sample) each (R, n_march), time-ordered along
    the minor axis.

    Key insight: the reference's sequential DDA march
    (testbed_nerf.cu:679-838 via nerf_device.cuh:430-492) always lands on
    integer stepping-space coordinates — `advance_to_next_voxel` rounds
    its skip up to a whole number of cone steps. So the set of positions
    it EVER visits is exactly {from_stepping_space(s0 + k)}, and because
    the occupancy bitfield is max-pooled across mips (coarse empty =>
    fine empty), a candidate skipped by DDA would have tested empty at
    its own mip too. Evaluating occupancy at ALL candidates in parallel
    therefore emits the bit-identical sample set with ZERO sequential
    dependence: no scan, no unroll, no per-trip compile cost — one
    (R, K)-shaped vector computation plus one bitfield gather.
    """
    o, d = rays.origins, rays.dirs
    s0 = to_stepping_space(rays.t_start, cone_angle)               # (R,)
    k = jnp.arange(n_march, dtype=jnp.float32)                     # (M,)
    ts = from_stepping_space(s0[:, None] + k[None, :], cone_angle)  # (R,M)
    dts = calc_dt(ts, cone_angle)

    # component-separated (R, M) position planes (no minor-dim-3 buffer)
    pos = [o[:, c, None] + ts * d[:, c, None] for c in range(3)]
    inside = None
    for c in range(3):
        v = (pos[c] >= aabb_min[c]) & (pos[c] <= aabb_max[c])
        inside = v if inside is None else (inside & v)

    mip = jnp.clip(mip_from_dt_comps(dts, pos, max_mip), 0, max_mip)
    occupied = density_grid_occupied_at_comps(pos, bitfield, mip)

    emit = inside & occupied & rays.valid[:, None]
    # per-ray sample cap (reference NERF_STEPS): emissions beyond the cap
    # are masked — the scan stopped the lane at the same count
    n_cum = jnp.cumsum(emit.astype(jnp.int32), axis=1)
    emit = emit & (n_cum <= max_samples_per_ray)
    return ts, dts, emit


def compact_samples(rays: RayBatch, ts: jax.Array, dts: jax.Array,
                    emits: jax.Array, aabb_min, aabb_max,
                    capacity: int,
                    extra_dims: Optional[jax.Array] = None,
                    order: str = "ray",
                    cone_angle: Optional[float] = None) -> SampleBatch:
    """Prefix-sum compaction of the (R, n_march) candidate grid into
    (capacity,) flat buffers.

    order="ray" (training): ray-major, each ray's samples contiguous and
    time-ordered (the loss composite needs per-ray segments); when
    capacity truncates, whole late rays starve.
    order="depth" (rendering): depth-major — all rays' step k before any
    ray's step k+1 — so a query-budget capacity (the reference's 2M
    target_n_queries, testbed_nerf.cu:1697-1698) sheds the DEEP tail of
    every ray uniformly instead of starving late rays. base/count are
    not meaningful in this order (count still reports kept samples/ray).

    Random-access traffic is ONE t gather + ONE packed per-ray row
    gather on the compacted (capacity,) domain — the slot->candidate
    inversion itself is a SORT (dense passes, no scatter; see inline
    comment), and everything else (dt, positions, dirs, warps)
    is recomputed arithmetically from (ray_id, t), instead of
    scattering nine separate (R*M,) value planes. The per-ray origin+
    direction ride one (R, 8) row so a single gather fetches all
    six components; dt = calc_dt(t) replaces its gather."""
    n_rays, n_march = emits.shape
    e = emits.astype(jnp.int32)
    count = jnp.sum(e, axis=1)                                 # (R,)
    base = jnp.cumsum(count) - count                           # (R,)
    if order == "depth":
        eT = e.T.reshape(-1)
        rank = (jnp.cumsum(eT) - eT).reshape(n_march, n_rays).T
        base = jnp.zeros_like(base)
        count = jnp.sum((rank < capacity) & emits, axis=1)
    else:
        slot = jnp.cumsum(e, axis=1) - e                       # (R, M)
        rank = base[:, None] + slot
    flat_pos = jnp.where(emits, rank, capacity)
    flat_pos = jnp.minimum(flat_pos, capacity)                 # clamp tail

    # invert slot->candidate by SORT instead of scatter: XLA sort is
    # dense comparison passes, where the R*M-element scatter writes one
    # element per SOURCE candidate even for the ~88% non-emitting ones.
    # (Its cost on the GPU against an atomic-counter compaction is an
    # open measurement; see PERF.md.) Emitting candidates' keys are
    # exactly their compacted ranks (unique, < capacity), so after an
    # ascending key sort the first min(capacity, n) values ARE the
    # compacted source indices; tail slots keep the R*M sentinel.
    n = n_rays * n_march
    keys, vals = jax.lax.sort(
        (flat_pos.reshape(-1), jnp.arange(n, dtype=jnp.int32)), num_keys=1)
    m = min(capacity, n)
    src = jnp.full(capacity, n, jnp.int32)
    src = src.at[:m].set(jnp.where(keys[:m] < capacity, vals[:m], n))
    src_c = jnp.minimum(src, n - 1)

    ray_id = src_c // n_march                                  # (S,)
    t_flat = ts.reshape(-1)[src_c]
    if cone_angle is not None:
        # dt is a pure function of t: recompute instead of gathering
        # (bit-identical to the march's dts plane, one fewer S-gather)
        dt_flat = warp_dt(calc_dt(t_flat, cone_angle))
    else:
        dt_flat = warp_dt(dts.reshape(-1)[src_c])

    o, d = rays.origins, rays.dirs
    span = aabb_max - aabb_min
    # one (R, 8) row per ray: a single row gather per sample
    # fetches origin AND direction (vs six scalar gathers)
    od = jnp.concatenate([o, d, jnp.zeros((n_rays, 2), o.dtype)], axis=1)
    od_r = od[ray_id]                                          # (S, 8)
    o_r = [od_r[:, k] for k in range(3)]
    d_r = [od_r[:, 3 + k] for k in range(3)]
    positions = tuple((o_r[k] + t_flat * d_r[k] - aabb_min[k]) / span[k]
                      for k in range(3))
    dirs = tuple((d_r[k] + 1.0) * 0.5 for k in range(3))

    if order == "depth":
        n_samples = jnp.minimum(jnp.sum(e), capacity)
        base_c, count_c = base, count          # count = kept/ray; base 0
    else:
        n_samples = jnp.minimum(base[-1] + count[-1], capacity)
        # clip per-ray segments to the capacity
        base_c = jnp.minimum(base, capacity)
        count_c = jnp.minimum(count, capacity - base_c)
    return SampleBatch(positions, dirs, dt_flat, t_flat, ray_id,
                       base_c, count_c, n_samples, flat_pos, src)


def pad_samples_per_ray(samples: SampleBatch, values: jax.Array,
                        max_per_ray: int) -> Tuple[jax.Array, jax.Array]:
    """Gather flat per-sample `values` (S, C) into padded per-ray layout
    (R, max_per_ray, C) + mask (R, max_per_ray) for compositing."""
    r = samples.ray_base.shape[0]
    k = jnp.arange(max_per_ray)
    idx = samples.ray_base[:, None] + k[None, :]
    mask = k[None, :] < samples.ray_count[:, None]
    idx = jnp.where(mask, idx, 0)
    gathered = values[idx]
    return gathered, mask
