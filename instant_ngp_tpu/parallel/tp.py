"""Tensor parallelism: level-sharded hash-grid encoding.

The hash table is ~all of a NeRF's parameters (T=2^19 rows x F per
level x L levels); everything else (two 64-wide MLPs) is KBs. The
natural tensor-parallel split is therefore BY LEVEL: each chip on
the `model` mesh axis owns L/tp levels' tables, computes its levels'
interpolated features, and one `all_gather` along the feature axis
assembles the (N, L*F) encoding before the replicated MLPs. The
backward pass reverses it automatically (all_gather transposes to
psum_scatter under shard_map autodiff), so each chip scatter-adds
gradients only into its own levels.

SPMD-uniform by construction: per-level constants (scale, resolution,
table size, hashed flag) are gathered from (L,) arrays at the traced
global level id `axis_index('model') * L/tp + j`, so every chip runs the
same compiled program — no per-shard specialization, no branches.

The reference has no tensor parallelism of any kind (SURVEY.md §2.6);
this is the "shard hash table rows for very large T" plan realized.
Memory note: the packed (L, Tmax, F) layout pads small dense levels to
the largest level's row count. For standard configs most levels already
sit at T rows, so padding costs <2x, and each chip stores only
(L/tp, Tmax, F).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.grid_encoding import _PRIMES, GridEncoding


class LevelShardedGrid:
    """Packs a GridEncoding's flat param vector into a (L, Tmax, F) table
    shardable over a mesh axis, and computes features for a contiguous
    level block with traced (non-static) level ids."""

    def __init__(self, enc: GridEncoding, n_shards: int):
        if enc.n_levels % n_shards != 0:
            raise ValueError(
                f"n_levels={enc.n_levels} not divisible by tp={n_shards}")
        self.enc = enc
        self.n_shards = n_shards
        self.levels_per_shard = enc.n_levels // n_shards
        self.max_rows = int(max(int(s) for s in enc._sizes))
        # per-level constants as device arrays, indexed by global level
        self.scales = jnp.asarray(np.asarray(enc._scales, np.float32))
        self.resolutions = jnp.asarray(
            np.asarray(enc._resolutions, np.int32))
        self.sizes = jnp.asarray(np.asarray(enc._sizes, np.int32))
        self.hashed = jnp.asarray(np.asarray(enc._hashed, bool))

    # -- host-side packing --------------------------------------------
    # Layout-aware: the flat vector is planar (the default) or
    # entry-interleaved in row mode;
    # level_params() abstracts that, and unpack writes the inverse.
    def pack(self, flat: jax.Array) -> jax.Array:
        """(n_params,) flat vector -> (L, Tmax, F), zero-padded rows."""
        out = np.zeros((self.enc.n_levels, self.max_rows,
                        self.enc.n_features_per_level), np.float32)
        flat = np.asarray(flat)
        for lvl in range(self.enc.n_levels):
            size = int(self.enc._sizes[lvl])
            out[lvl, :size] = np.asarray(self.enc.level_params(flat, lvl))
        return jnp.asarray(out)

    def unpack(self, table) -> jax.Array:
        f = self.enc.n_features_per_level
        w = self.enc._n_words
        table = np.asarray(table)
        flat = np.zeros(self.enc.n_params, np.float32)
        for lvl in range(self.enc.n_levels):
            size = int(self.enc._sizes[lvl])
            start = int(self.enc._offsets[lvl])
            if self.enc._row_mode:
                flat[start * f:(start + size) * f] = \
                    table[lvl, :size].reshape(-1)
            else:
                for k in range(f):
                    flat[k * w + start:k * w + start + size] = \
                        table[lvl, :size, k]
        return jnp.asarray(flat)

    # -- device-side level-uniform featurization ----------------------
    def _dynamic_level_features(self, table_row: jax.Array, lvl: jax.Array,
                                comps) -> jax.Array:
        """Features of ONE level with traced id `lvl`; table_row is that
        level's (Tmax, F) slice. comps: d component (N,) arrays."""
        enc = self.enc
        d = enc.n_dims
        scale = self.scales[lvl]
        res = self.resolutions[lvl]
        size = self.sizes[lvl]
        is_hashed = self.hashed[lvl]

        pos = [c * scale + 0.5 for c in comps]
        pos0 = [jnp.floor(p) for p in pos]
        w = [p - p0 for p, p0 in zip(pos, pos0)]
        if enc.interpolation == "Smoothstep":
            w = [wi * wi * (3.0 - 2.0 * wi) for wi in w]
        elif enc.interpolation == "Nearest":
            w = [jnp.round(wi) for wi in w]
        pos0 = [p0.astype(jnp.int32) for p0 in pos0]

        feats = 0.0
        for corner in range(1 << d):
            bits = [(corner >> dim) & 1 for dim in range(d)]
            coords = [p0 + b for p0, b in zip(pos0, bits)]
            # hashed index (XOR of prime-multiplied coords)
            h = coords[0].astype(jnp.uint32) * jnp.uint32(_PRIMES[0])
            for dim in range(1, d):
                h = h ^ (coords[dim].astype(jnp.uint32)
                         * jnp.uint32(_PRIMES[dim]))
            hashed_idx = (h % size.astype(jnp.uint32)).astype(jnp.int32)
            # dense index (clipped row-major); capped levels wrap
            cc = [jnp.clip(c, 0, res - 1) for c in coords]
            dense_idx = cc[0]
            stride = jnp.int32(1)
            for dim in range(1, d):
                stride = stride * res
                dense_idx = dense_idx + cc[dim] * stride
            dense_idx = dense_idx % size
            idx = jnp.where(is_hashed, hashed_idx, dense_idx)

            weight = 1.0
            for dim in range(d):
                weight = weight * jnp.where(bits[dim], w[dim], 1 - w[dim])
            feats = feats + table_row[idx] * weight[:, None]   # (N, F)
        return feats

    def local_features(self, table_local: jax.Array, comps,
                       axis: str = "model",
                       max_level: Optional[jax.Array] = None) -> jax.Array:
        """Inside shard_map: (L/tp, Tmax, F) local table -> this shard's
        (N, L/tp * F) features, then all_gather -> (N, L*F)."""
        shard = jax.lax.axis_index(axis)
        outs = []
        for j in range(self.levels_per_shard):
            lvl = shard * self.levels_per_shard + j
            f = self._dynamic_level_features(table_local[j], lvl, comps)
            if max_level is not None:
                f = f * (jnp.asarray(max_level) >= lvl).astype(f.dtype)
            outs.append(f)
        local = jnp.concatenate(outs, axis=-1)
        gathered = jax.lax.all_gather(local, axis, axis=1, tiled=True)
        return gathered.astype(self.enc.dtype)


def make_tp_train_step(model, optimizer, cfg, aabb_min, aabb_max,
                       mesh: Mesh, data_axis: str = "data",
                       model_axis: str = "model"):
    """Hybrid dp x tp NeRF train step: rays sharded over `data`, hash
    table level-sharded over `model`. state['params']['pos_encoding'] must
    be the packed (L, Tmax, F) table (see LevelShardedGrid.pack), laid
    out with NamedSharding P('model') on axis 0.

    Collectives per step:
      all_gather(features) on model      — forward
      psum_scatter(feature grads)        — backward (automatic transpose)
      psum(table grads) on data          — gradient DP reduction
      psum(other grads) on data x model  — replicated-param reduction
    """
    n_tp = mesh.shape[model_axis]
    sharded_enc = LevelShardedGrid(model.pos_encoding, n_tp)

    def local_step(state, data, bitfield, mean_density, keys):
        from ..nerf.sampler import (compact_samples, generate_rays,
                                    march_rays)
        from ..nerf.training import _srgb_to_linear, composite_loss

        key = keys[0]
        k_rays, k_bg = jax.random.split(key)
        rays, _ = generate_rays(k_rays, data, cfg.n_rays, aabb_min,
                                aabb_max, cfg.cone_angle, cfg.lens_mode,
                                cfg.snap_to_pixel_centers)
        ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                    cfg.cone_angle, cfg.max_mip,
                                    cfg.n_march, cfg.max_samples_per_ray)
        samples = compact_samples(rays, ts, dts, emits, aabb_min, aabb_max,
                                  cfg.sample_capacity)
        bg = _srgb_to_linear(jax.random.uniform(k_bg, (cfg.n_rays, 3))
                             if cfg.random_bg_color
                             else jnp.zeros((cfg.n_rays, 3)))
        exposure = data.exposures[rays.img_idx]

        def loss_fn(params):
            feats = sharded_enc.local_features(
                params["pos_encoding"], list(samples.positions),
                axis=model_axis)
            raw = model.apply_components(params, samples.positions,
                                         samples.dirs, pos_feats=feats)
            result = composite_loss(
                tuple(raw), samples, ts, dts, rays, bg,
                exposure, cfg.rgb_activation, cfg.density_activation,
                cfg.loss_type, mean_density, cfg.near_distance,
                cfg.train_in_linear_colors)
            return result.loss_for_grad, result

        (_, result), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state["params"])

        # table grads: already per-shard on model; reduce over data only.
        # everything else replicates: reduce over both axes.
        def reduce_grad(path_is_table, g):
            if path_is_table:
                return jax.lax.pmean(g, data_axis)
            return jax.lax.pmean(jax.lax.pmean(g, data_axis), model_axis)

        grads = {k: jax.tree_util.tree_map(
            partial(reduce_grad, k == "pos_encoding"), v)
            for k, v in grads.items()}

        from ..ops.trainer import default_l2_mask

        new_params, new_opt = optimizer.step(
            state["opt"], state["params"], grads,
            l2_mask=default_l2_mask(state["params"]))
        n_total = cfg.n_rays * mesh.shape[data_axis]
        stats = {
            "loss": jax.lax.psum(jnp.sum(result.per_ray_loss), data_axis)
            / n_total,
            "measured_batch_size": jax.lax.psum(result.measured_compacted,
                                                data_axis),
        }
        return {"params": new_params, "opt": new_opt}, stats

    param_specs = {
        "pos_encoding": P(model_axis),
    }

    def spec_for(path_key):
        return param_specs.get(path_key, P())

    def state_specs(state_tree):
        # params + optimizer slots mirror the table sharding
        def leaf_spec(path, leaf):
            keys = [getattr(p, "key", getattr(p, "name", None))
                    for p in path]
            return P(model_axis) if "pos_encoding" in keys else P()
        return jax.tree_util.tree_map_with_path(leaf_spec, state_tree)

    def build(state_example):
        specs = state_specs(state_example)
        sharded = jax.shard_map(
            local_step, mesh=mesh,
            in_specs=(specs, P(), P(), P(), P(data_axis)),
            out_specs=(specs, P()),
            check_vma=False)
        return jax.jit(sharded, donate_argnums=(0,)), specs

    return build, sharded_enc
