"""Ray-marching math: warps, cascaded grid addressing, cone stepping.

Vectorized jnp re-implementation of nerf_device.cuh:
- march constants (:24-42): 1024 steps/unit, sqrt(3) diagonal, 8 cascades;
- position/direction/dt warps (:265-313): positions map into [0,1]^3
  relative to the aabb, directions to dir/2+0.5, dt normalized between
  min and max cone step;
- cascaded occupancy-grid addressing (:316-356): Morton-indexed 128^3
  cells per mip; mip m covers the cube of side 2^m centered at 0.5;
- cone stepping (:369-447): dt = clamp(t * cone_angle, dt_min, dt_max)
  expressed through the exponential "stepping space" bijection
  to_stepping_space/from_stepping_space so stepping is analytic;
- DDA empty-space skipping (:430-492): advance to the next voxel border
  at the current mip.

Everything is branch-free (jnp.where) so it vectorizes over ray lanes on
the VPU; the only loops are fixed-trip-count scans in callers.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import (MAX_CONE_STEPSIZE, MIN_CONE_STEPSIZE, NERF_CASCADES,
                      NERF_GRID_N_CELLS, NERF_GRIDSIZE)

NERF_STEPS = 1024                      # finest steps per unit (nerf_device.cuh:28)
MAX_DEPTH = 16384.0                    # "infinity" depth sentinel
N_MAX_RANDOM_SAMPLES_PER_RAY = 16


# ---------------------------------------------------------------------------
# Morton encoding (z-order) for 128^3 grids
# ---------------------------------------------------------------------------

def _expand_bits(v: jax.Array) -> jax.Array:
    """Spread the low 10 bits of v so consecutive bits are 3 apart."""
    v = (v * np.uint32(0x00010001)) & np.uint32(0xFF0000FF)
    v = (v * np.uint32(0x00000101)) & np.uint32(0x0F00F00F)
    v = (v * np.uint32(0x00000011)) & np.uint32(0xC30C30C3)
    v = (v * np.uint32(0x00000005)) & np.uint32(0x49249249)
    return v


def morton3d(x: jax.Array, y: jax.Array, z: jax.Array) -> jax.Array:
    """Interleave 3x10-bit coords into a 30-bit Morton index (uint32)."""
    xx = _expand_bits(x.astype(jnp.uint32))
    yy = _expand_bits(y.astype(jnp.uint32))
    zz = _expand_bits(z.astype(jnp.uint32))
    return (xx | (yy << 1) | (zz << 2)).astype(jnp.int32)


def morton3d_invert(i: jax.Array) -> jax.Array:
    """Inverse of one interleaved axis: gather every 3rd bit of i."""
    x = i.astype(jnp.uint32) & np.uint32(0x49249249)
    x = (x | (x >> 2)) & np.uint32(0xC30C30C3)
    x = (x | (x >> 4)) & np.uint32(0x0F00F00F)
    x = (x | (x >> 8)) & np.uint32(0xFF0000FF)
    x = (x | (x >> 16)) & np.uint32(0x000003FF)
    return x.astype(jnp.int32)


def morton3d_coords(idx: jax.Array) -> Tuple[jax.Array, jax.Array, jax.Array]:
    return (morton3d_invert(idx), morton3d_invert(idx >> 1),
            morton3d_invert(idx >> 2))


# ---------------------------------------------------------------------------
# Warps (network input normalization)
# ---------------------------------------------------------------------------

def warp_position(pos: jax.Array, aabb_min, aabb_max) -> jax.Array:
    return (pos - aabb_min) / (aabb_max - aabb_min)


def unwarp_position(pos: jax.Array, aabb_min, aabb_max) -> jax.Array:
    return aabb_min + pos * (aabb_max - aabb_min)


def warp_direction(d: jax.Array) -> jax.Array:
    return (d + 1.0) * 0.5


def unwarp_direction(d: jax.Array) -> jax.Array:
    return d * 2.0 - 1.0


def warp_dt(dt: jax.Array) -> jax.Array:
    max_stepsize = MIN_CONE_STEPSIZE * (1 << (NERF_CASCADES - 1))
    return (dt - MIN_CONE_STEPSIZE) / (max_stepsize - MIN_CONE_STEPSIZE)


def unwarp_dt(dt: jax.Array) -> jax.Array:
    max_stepsize = MIN_CONE_STEPSIZE * (1 << (NERF_CASCADES - 1))
    return dt * (max_stepsize - MIN_CONE_STEPSIZE) + MIN_CONE_STEPSIZE


# ---------------------------------------------------------------------------
# Cascaded occupancy grid addressing
# ---------------------------------------------------------------------------

def cascaded_grid_idx_at(pos: jax.Array, mip: jax.Array
                         ) -> Tuple[jax.Array, jax.Array]:
    """(..., 3) pos, (...,) mip -> (morton idx within mip, valid mask)."""
    mip_scale = jnp.exp2(-mip.astype(jnp.float32))[..., None]
    p = (pos - 0.5) * mip_scale + 0.5
    i = jnp.floor(p * NERF_GRIDSIZE).astype(jnp.int32)
    valid = jnp.all((i >= 0) & (i < NERF_GRIDSIZE), axis=-1)
    i = jnp.clip(i, 0, NERF_GRIDSIZE - 1)
    return morton3d(i[..., 0], i[..., 1], i[..., 2]), valid


def grid_mip_offset(mip) -> jax.Array:
    return NERF_GRID_N_CELLS * mip


def density_grid_occupied_at(pos: jax.Array, bitfield: jax.Array,
                             mip: jax.Array) -> jax.Array:
    """bitfield: (NERF_CASCADES*128^3/8,) uint8. Returns bool (...,)."""
    idx, valid = cascaded_grid_idx_at(pos, mip)
    byte_idx = idx // 8 + grid_mip_offset(mip) // 8
    byte = bitfield[byte_idx]
    bit = (byte >> (idx % 8).astype(jnp.uint8)) & jnp.uint8(1)
    return valid & (bit != 0)


def cascaded_grid_at(pos: jax.Array, grid: jax.Array, mip: jax.Array
                     ) -> jax.Array:
    """grid: (NERF_CASCADES*128^3,) float density. 0 outside."""
    idx, valid = cascaded_grid_idx_at(pos, mip)
    return jnp.where(valid, grid[idx + grid_mip_offset(mip)], 0.0)


def mip_from_pos(pos: jax.Array, max_cascade: int) -> jax.Array:
    """Cascade whose cube [0.5 ± 2^(m-1)] contains pos (nerf_device.cuh:444)."""
    maxval = jnp.max(jnp.abs(pos - 0.5), axis=-1)
    _, exponent = jnp.frexp(maxval)
    return jnp.clip(exponent + 1, 0, max_cascade)


# Component-separated variants: callers that hold million-element (R, M)
# position planes per axis use these so no (..., 3)-minor-dim buffer is
# ever materialized.

def cascaded_grid_idx_at_comps(comps, mip: jax.Array
                               ) -> Tuple[jax.Array, jax.Array]:
    """comps: 3 arrays (...,); mip (...,). -> (morton idx, valid)."""
    mip_scale = jnp.exp2(-mip.astype(jnp.float32))
    ijk = []
    valid = None
    for c in comps:
        p = (c - 0.5) * mip_scale + 0.5
        i = jnp.floor(p * NERF_GRIDSIZE).astype(jnp.int32)
        v = (i >= 0) & (i < NERF_GRIDSIZE)
        valid = v if valid is None else (valid & v)
        ijk.append(jnp.clip(i, 0, NERF_GRIDSIZE - 1))
    return morton3d(ijk[0], ijk[1], ijk[2]), valid


def density_grid_occupied_at_comps(comps, bitfield: jax.Array,
                                   mip: jax.Array) -> jax.Array:
    idx, valid = cascaded_grid_idx_at_comps(comps, mip)
    byte_idx = idx // 8 + grid_mip_offset(mip) // 8
    # row-gather + lane select: one gather fetches a 128-byte row of
    # the bitfield (4096 voxels' occupancy) instead of one byte;
    # bit-identical to the byte gather
    n_bytes = bitfield.shape[0]
    if n_bytes % 128 == 0:
        rows = bitfield.reshape(-1, 128)[byte_idx // 128]
        lanes = jax.lax.broadcasted_iota(
            jnp.int32, (1,) * byte_idx.ndim + (128,), byte_idx.ndim)
        sel = lanes == (byte_idx % 128)[..., None]
        byte = jnp.max(jnp.where(sel, rows, jnp.uint8(0)), axis=-1)
    else:
        byte = bitfield[byte_idx]
    bit = (byte >> (idx % 8).astype(jnp.uint8)) & jnp.uint8(1)
    return valid & (bit != 0)


def mip_from_pos_comps(comps, max_cascade: int) -> jax.Array:
    maxval = jnp.maximum(jnp.maximum(jnp.abs(comps[0] - 0.5),
                                     jnp.abs(comps[1] - 0.5)),
                         jnp.abs(comps[2] - 0.5))
    _, exponent = jnp.frexp(maxval)
    return jnp.clip(exponent + 1, 0, max_cascade)


def mip_from_dt_comps(dt: jax.Array, comps, max_cascade: int) -> jax.Array:
    mip = mip_from_pos_comps(comps, max_cascade)
    d = dt * 2 * NERF_GRIDSIZE
    _, exponent = jnp.frexp(d)
    return jnp.where(d < 1.0, mip, jnp.clip(mip, exponent, max_cascade))


def mip_from_dt(dt: jax.Array, pos: jax.Array, max_cascade: int) -> jax.Array:
    """At least the mip whose cell size matches dt (nerf_device.cuh:454)."""
    mip = mip_from_pos(pos, max_cascade)
    d = dt * 2 * NERF_GRIDSIZE
    _, exponent = jnp.frexp(d)
    return jnp.where(d < 1.0, mip, jnp.clip(mip, exponent, max_cascade))


# ---------------------------------------------------------------------------
# Cone stepping (exponential step sizes via "stepping space")
# ---------------------------------------------------------------------------

def to_stepping_space(t: jax.Array, cone_angle: jax.Array) -> jax.Array:
    cone_angle = jnp.asarray(cone_angle, jnp.float32)
    uniform = cone_angle <= 1e-5
    c = jnp.where(uniform, 1e-2, cone_angle)  # dummy to avoid log(0)
    log1p_c = jnp.log1p(c)
    a = (jnp.log(MIN_CONE_STEPSIZE) - jnp.log(log1p_c)) / log1p_c
    b = (jnp.log(MAX_CONE_STEPSIZE) - jnp.log(log1p_c)) / log1p_c
    at = jnp.exp(a * log1p_c)
    bt = jnp.exp(b * log1p_c)
    t_safe = jnp.maximum(t, 1e-30)
    exp_region = jnp.log(t_safe) / log1p_c
    res = jnp.where(
        t <= at, (t - at) / MIN_CONE_STEPSIZE + a,
        jnp.where(t <= bt, exp_region, (t - bt) / MAX_CONE_STEPSIZE + b))
    return jnp.where(uniform, t / MIN_CONE_STEPSIZE, res)


def from_stepping_space(n: jax.Array, cone_angle: jax.Array) -> jax.Array:
    cone_angle = jnp.asarray(cone_angle, jnp.float32)
    uniform = cone_angle <= 1e-5
    c = jnp.where(uniform, 1e-2, cone_angle)
    log1p_c = jnp.log1p(c)
    a = (jnp.log(MIN_CONE_STEPSIZE) - jnp.log(log1p_c)) / log1p_c
    b = (jnp.log(MAX_CONE_STEPSIZE) - jnp.log(log1p_c)) / log1p_c
    at = jnp.exp(a * log1p_c)
    bt = jnp.exp(b * log1p_c)
    res = jnp.where(
        n <= a, (n - a) * MIN_CONE_STEPSIZE + at,
        jnp.where(n <= b, jnp.exp(jnp.clip(n, a, b) * log1p_c),
                  (n - b) * MAX_CONE_STEPSIZE + bt))
    return jnp.where(uniform, n * MIN_CONE_STEPSIZE, res)


def advance_n_steps(t: jax.Array, cone_angle, n) -> jax.Array:
    return from_stepping_space(to_stepping_space(t, cone_angle) + n,
                               cone_angle)


def calc_dt(t: jax.Array, cone_angle) -> jax.Array:
    return advance_n_steps(t, cone_angle, 1.0) - t


def distance_to_next_voxel(pos: jax.Array, dir: jax.Array, idir: jax.Array,
                           res: jax.Array) -> jax.Array:
    """DDA distance to the next voxel border at grid resolution res.

    Axes with ~zero direction never cross a border: their axis distance is
    +inf (the CUDA version gets this via 0*inf=NaN + fminf NaN semantics)."""
    p = res[..., None] * (pos - 0.5)
    sgn = jnp.sign(dir)
    t_axis = (jnp.floor(p + 0.5 + 0.5 * sgn) - p) * idir
    t_axis = jnp.where(jnp.abs(dir) < 1e-10, jnp.inf, t_axis)
    t = jnp.min(t_axis, axis=-1)
    return jnp.maximum(t / res, 0.0)


def advance_to_next_voxel(t: jax.Array, cone_angle, pos: jax.Array,
                          dir: jax.Array, idir: jax.Array, mip: jax.Array
                          ) -> jax.Array:
    """Skip to the next voxel border, stepping analytically in multiples of
    one step of the exponential stepping routine (nerf_device.cuh:430)."""
    res = jnp.ldexp(jnp.float32(NERF_GRIDSIZE), -mip.astype(jnp.int32))
    t_target = t + distance_to_next_voxel(pos, dir, idir, res)
    ts = to_stepping_space(t, cone_angle)
    ts_target = to_stepping_space(t_target, cone_angle)
    return from_stepping_space(
        ts + jnp.ceil(jnp.maximum(ts_target - ts, 0.5)), cone_angle)


# ---------------------------------------------------------------------------
# AABB intersection
# ---------------------------------------------------------------------------

def ray_intersect_aabb(o: jax.Array, d: jax.Array, aabb_min, aabb_max
                       ) -> Tuple[jax.Array, jax.Array]:
    """(tmin, tmax) of ray vs box; tmin > tmax means miss
    (bounding_box.cuh ray_intersect)."""
    idir = 1.0 / jnp.where(jnp.abs(d) < 1e-12, jnp.where(d < 0, -1e-12, 1e-12), d)
    t1 = (aabb_min - o) * idir
    t2 = (aabb_max - o) * idir
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return tmin, tmax


def aabb_contains(pos: jax.Array, aabb_min, aabb_max) -> jax.Array:
    return jnp.all((pos >= aabb_min) & (pos <= aabb_max), axis=-1)
