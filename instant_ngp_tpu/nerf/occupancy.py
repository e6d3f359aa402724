"""Cascaded occupancy grid: density EMA, bitfield, mip max-pooling.

JAX re-implementation of the reference density-grid machinery
(src/testbed_nerf.cu:74-332 kernels, update_density_grid_nerf :2271-2360,
update_density_grid_mean_and_bitfield :2363-2380):

- `density_grid`: (n_cascades * 128^3,) fp32, Morton-indexed per cascade.
  Negative values mark untrained (camera-unseen) cells.
- update step: sample candidate cells (¼ uniform over all cells + ¼ from
  currently-occupied cells after the warmup phase; ALL cells for the first
  256 steps — training_prep_nerf :2933-2946), query the density MLP at a
  jittered position inside each cell, splat `density * MIN_CONE_STEPSIZE`
  with a max-reduce, then per-cell `max(old * decay, new)` (the reference
  uses max-EMA, not a true EMA — ema_grid_samples_nerf :253).
- bitfield: bit = density > min(0.01, mean_density); mips above cascade 0
  are max-pools of the center 64^3 of the previous cascade
  (bitfield_max_pool :310 — note mip m's INNER half equals mip m-1).

All steps are pure jnp (scatter-max + reshape tricks); the whole update
jits into one program with no host sync. Multi-chip: the density query
shards over samples; the scatter-max and bitfield build are tiny and run
replicated (SURVEY.md §2.6).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import (MIN_CONE_STEPSIZE, NERF_CASCADES, NERF_GRID_N_CELLS,
                      NERF_GRIDSIZE, NERF_MIN_OPTICAL_THICKNESS)
from .march import morton3d, morton3d_coords

N_BITFIELD_BYTES = NERF_GRID_N_CELLS // 8 * NERF_CASCADES


def init_density_grid(n_cascades: int) -> jax.Array:
    return jnp.zeros(NERF_GRID_N_CELLS * n_cascades, jnp.float32)


def init_bitfield() -> jax.Array:
    return jnp.zeros(N_BITFIELD_BYTES, jnp.uint8)


def cell_positions(indices: jax.Array, key: jax.Array):
    """Jittered world position inside each grid cell, as a tuple of 3
    (N,) component arrays (no (N, 3) buffers).

    indices: (N,) flat grid indices (level * N_CELLS + morton).
    Mirrors generate_grid_samples_nerf_nonuniform's position math
    (testbed_nerf.cu:206-212)."""
    level = indices // NERF_GRID_N_CELLS
    pos_idx = indices % NERF_GRID_N_CELLS
    comps = morton3d_coords(pos_idx)
    mip_scale = jnp.exp2(level.astype(jnp.float32))
    keys = jax.random.split(key, 3)
    out = []
    for k, c in zip(keys, comps):
        jitter = jax.random.uniform(k, c.shape, jnp.float32)
        p = (c.astype(jnp.float32) + jitter) / NERF_GRIDSIZE - 0.5
        out.append(p * mip_scale + 0.5)
    return tuple(out)


def sample_cells(key: jax.Array, density_grid: jax.Array, step: jax.Array,
                 n_uniform: int, n_nonuniform: int, n_cascades: int
                 ) -> jax.Array:
    """Pick candidate cell indices: `n_uniform` cells regardless of state
    (threshold -0.01 skips only untrained) + `n_nonuniform` occupied cells.

    The reference uses a hash sequence with 10 rejection probes
    (testbed_nerf.cu:189-198); we keep the same probe-until-above-threshold
    structure with stateless uniform draws."""
    k1, k2 = jax.random.split(key)

    def probe(key, n, thresh, salt):
        # 10 probes per slot; keep the first index whose density > thresh
        keys = jax.random.fold_in(key, salt)
        idx = jax.random.randint(keys, (10, n), 0, NERF_GRID_N_CELLS)
        level = jax.random.randint(jax.random.fold_in(keys, 1), (n,),
                                   0, n_cascades)
        flat = idx + level[None, :] * NERF_GRID_N_CELLS
        ok = density_grid[flat] > thresh                     # (10, n)
        # first ok probe, else the last probe
        first = jnp.argmax(ok, axis=0)
        any_ok = jnp.any(ok, axis=0)
        pick = jnp.where(any_ok, first, 9)
        return flat[pick, jnp.arange(n)]

    if n_uniform == n_cascades * NERF_GRID_N_CELLS and n_nonuniform == 0:
        # warmup "all cells" pass: exact enumeration, like the reference's
        # density_grid_indices sweep (update_density_grid_nerf :2290-2300)
        # — sampling with replacement would cover only ~63% per pass and
        # burn 10x probe gathers on the hottest path
        return jnp.arange(n_uniform, dtype=jnp.int32)

    uni = probe(k1, n_uniform, -0.01, 0)
    non = probe(k2, n_nonuniform, NERF_MIN_OPTICAL_THICKNESS, 2)
    return jnp.concatenate([uni, non])


def splat_and_ema(density_grid: jax.Array, indices: jax.Array,
                  densities: jax.Array, decay: float = 0.95) -> jax.Array:
    """Max-splat optical thickness into cells, then max-EMA merge.

    densities: raw activated density at the sampled positions. The splat
    value is `density * MIN_CONE_STEPSIZE` (optical thickness of the
    smallest step — splat_grid_samples :222-235); merge keeps untrained
    (negative) cells negative (ema_grid_samples_nerf :253)."""
    optical = densities * MIN_CONE_STEPSIZE
    tmp = jnp.zeros_like(density_grid)
    tmp = tmp.at[indices].max(optical)
    return jnp.where(density_grid < 0.0, density_grid,
                     jnp.maximum(density_grid * decay, tmp))


def density_grid_mean(density_grid: jax.Array) -> jax.Array:
    """Mean of clamped density over the FIRST cascade only (the reference
    reduces n_elements = 128^3 — update_density_grid_mean_and_bitfield)."""
    first = density_grid[:NERF_GRID_N_CELLS]
    return jnp.mean(jnp.maximum(first, 0.0))


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(N, 8) bool -> (N,) uint8, bit j = bits[:, j]."""
    weights = (1 << np.arange(8)).astype(np.uint8)
    return jnp.sum(bits.astype(jnp.uint8) * weights[None, :], axis=-1,
                   dtype=jnp.uint8)


def _unpack_bits(bytes_: jax.Array) -> jax.Array:
    """(N,) uint8 -> (N, 8) bool."""
    shifts = np.arange(8).astype(np.uint8)
    return ((bytes_[:, None] >> shifts[None, :]) & 1).astype(bool)


def update_bitfield(density_grid: jax.Array, max_cascade: int) -> jax.Array:
    """density grid -> packed bitfield for all NERF_CASCADES mips.

    Threshold = min(0.01, mean density). Mips above max_cascade are zero.
    Mip m>=1 is a max-pool: the center 64^3 of mip m-1 collapses 2x2x2 →
    one cell of mip m, offset to the center of mip m's grid
    (bitfield_max_pool :310-331). Because Morton order makes the 8
    children of a cell contiguous, the max-pool is a reshape-any over
    groups of 8."""
    thresh = jnp.minimum(NERF_MIN_OPTICAL_THICKNESS,
                         density_grid_mean(density_grid))
    n_cells = NERF_GRID_N_CELLS
    occupied = density_grid > thresh                      # (C*n_cells,)

    # zero out cascades beyond max_cascade (grid_to_bitfield's
    # n_nonzero_elements cap)
    n_cascades_present = density_grid.shape[0] // n_cells
    levels = []
    level0 = occupied[:n_cells]
    levels.append(level0)

    prev = level0
    for m in range(1, NERF_CASCADES):
        if m < n_cascades_present and m <= max_cascade:
            base = occupied[m * n_cells:(m + 1) * n_cells]
        else:
            base = jnp.zeros(n_cells, bool)
        # max-pool of prev level: groups of 8 Morton-contiguous children
        pooled_inner = jnp.any(prev.reshape(-1, 8), axis=-1)  # (64^3,)
        # place the pooled 64^3 block at the center of this mip's grid
        # pooled 64^3 block sits at the center (coords +32) of this mip,
        # because mip m covers 2x the extent of mip m-1
        xi, yi, zi = morton3d_coords(jnp.arange(64 ** 3, dtype=jnp.int32))
        center_idx = morton3d(xi + NERF_GRIDSIZE // 4,
                              yi + NERF_GRIDSIZE // 4,
                              zi + NERF_GRIDSIZE // 4)
        level = base.at[center_idx].max(pooled_inner)
        levels.append(level)
        prev = level

    all_bits = jnp.concatenate(levels)
    return _pack_bits(all_bits.reshape(-1, 8))


def mark_untrained_cells(density_grid: jax.Array, visible: jax.Array
                         ) -> jax.Array:
    """visible: (C*128^3,) bool from camera-frustum tests. Unseen cells go
    to -1 (mark_untrained_density_grid :74-146)."""
    return jnp.where(visible, jnp.maximum(density_grid, 0.0), -1.0)
