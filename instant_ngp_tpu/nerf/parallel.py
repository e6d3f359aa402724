"""Multi-chip NeRF training: rays sharded over the data mesh axis.

The scaling design (SURVEY.md §2.6): parameters and the occupancy
bitfield replicate (hash table ≈ tens of MB); each chip generates,
marches, compacts, and backprops its own ray shard; gradients all-reduce
with one `pmean`; the optimizer update is computed replicated so
parameters stay bit-identical per chip. shard_map makes every collective
explicit — the only cross-chip traffic is the gradient psum and scalar
stat psums, both overlapped by XLA with the backward pass.

Rendering shards pixel tiles the same way (each chip renders every
n_devices-th tile); the framebuffer gathers on host.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .training import NerfTrainStepConfig, nerf_train_step


def make_sharded_train_step(model, optimizer, cfg: NerfTrainStepConfig,
                            aabb_min, aabb_max, mesh: Mesh,
                            axis: str = "data",
                            with_error_map: bool = False):
    """Returns step(state, data, bitfield, mean_density, keys, cam,
    error_cdfs, error_map, envmap, distortion) where `keys` is
    (n_devices, 2) uint32 PRNG keys, one per chip. cfg.n_rays is the
    PER-CHIP ray count; the effective batch is n_rays * n_devices.

    This is the SAME nerf_train_step as single-chip training — not a
    fork: `axis_name` makes the gradient pmean (and stat / error-map /
    aux-gradient psums) the only collectives, so every feature (camera/
    exposure/envmap/distortion optimization, error-map importance
    sampling, depth supervision) works sharded."""

    def local_step(state, data, bitfield, mean_density, keys, cam,
                   error_cdfs, error_map, envmap, distortion):
        return nerf_train_step(
            model, optimizer, cfg, aabb_min, aabb_max, state, data,
            bitfield, mean_density, keys[0], cam=cam,
            error_cdfs=error_cdfs, error_map=error_map, envmap=envmap,
            distortion=distortion, axis_name=axis)

    sharded = jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis), P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False)
    jitted = jax.jit(sharded, donate_argnums=(0,))

    def step(state, data, bitfield, mean_density, keys, cam=None,
             error_cdfs=None, error_map=None, envmap=None,
             distortion=None):
        return jitted(state, data, bitfield, mean_density, keys, cam,
                      error_cdfs, error_map, envmap, distortion)

    return step


def make_sharded_density_update(testbed, mesh: Mesh, axis: str = "data",
                                n_uniform: int = 0, n_nonuniform: int = 0):
    """Density-grid maintenance for the sharded loop: each chip evaluates
    a 1/n_devices shard of the sampled cells, results all-gather, and the
    EMA/bitfield update is computed replicated — the analog of the
    reference's compute-once + dirty-tracked broadcast
    (testbed.cu:5008-5048).

    Returns update(params, density_grid, rng, decay) -> (grid, bitfield,
    mean)."""
    n_dev = mesh.shape[axis]
    n_uni = -(-n_uniform // n_dev)
    n_non = -(-n_nonuniform // n_dev)
    body = testbed._density_update_body(n_uni, n_non, evaluate_only=True)

    def local_update(params, density_grid, rngs, decay):
        rng = jax.random.fold_in(rngs[0], jax.lax.axis_index(axis))
        idx, dens = body(params, density_grid, rng, decay)
        idx = jax.lax.all_gather(idx, axis, axis=0, tiled=True)
        dens = jax.lax.all_gather(dens, axis, axis=0, tiled=True)
        from .occupancy import (density_grid_mean, splat_and_ema,
                                update_bitfield)

        new_grid = splat_and_ema(density_grid, idx, dens, decay)
        bitfield = update_bitfield(new_grid, testbed.scene.max_cascade)
        mean = density_grid_mean(new_grid)
        return new_grid, bitfield, mean

    sharded = jax.shard_map(
        local_update, mesh=mesh,
        in_specs=(P(), P(), P(axis), P()),
        out_specs=(P(), P(), P()),
        check_vma=False)
    return jax.jit(sharded)


def make_sharded_render(model, render_cfg, aabb_min, aabb_max, mesh: Mesh,
                        axis: str = "data"):
    """Tiled frame rendering with pixel tiles sharded over chips."""
    from .render import render_tile

    def local_render(params, origins, dirs, bitfield, bg):
        return render_tile(model, render_cfg, params, origins[0], dirs[0],
                           bitfield, aabb_min, aabb_max, bg)

    sharded = jax.shard_map(
        lambda p, o, d, b, bg: jax.tree_util.tree_map(
            lambda x: x[None], local_render(p, o, d, b, bg)),
        mesh=mesh,
        in_specs=(P(), P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False)
    return jax.jit(sharded)
