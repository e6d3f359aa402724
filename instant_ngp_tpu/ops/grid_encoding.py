"""Multiresolution hash/dense/tiled grid encoding (the heart of instant-ngp).

JAX re-implementation of tcnn's GridEncoding, which the reference
uses for every testbed (created via `create_encoding`; params auto-derived
at src/testbed.cu:3679-3723; coarse-to-fine masking via `set_max_level_gpu`,
src/testbed_nerf.cu:2796-2806).

Semantics kept from tcnn's encodings/grid.h:
- L levels; level l has scale  s_l = N_min * 2^(l * log2(b)) - 1  and
  resolution  r_l = ceil(s_l) + 1.
- A point x in [0,1]^d maps to  pos = x * s_l + 0.5; the 2^d surrounding
  corners are d-linearly interpolated.
- Per-level table size = min(r_l^d, 2^log2_hashmap_size), 8-aligned.
  Dense addressing when the level fits, else spatial hash
  (XOR of coords times primes {1, 2654435761, 805459861}).
- Tiled grids wrap coordinates; dense grids clamp.
- `max_level` masks levels above the given index to zero features (and
  hence zero gradient) for coarse-to-fine schedules.

The per-level loop is the semantic reference. The fused paths compute all
(level, corner) pairs in one flattened (N, L*2^d) axis and implement the
same contract with one gather over all levels; they differ only in how the
table is laid out and fetched (the default flat path, `row_gather`,
`packed`).
Corner and feature reductions are reshapes and sums, so they stay exact
float32 on every backend (no matmul that could run in TF32).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .encodings import Encoding

_PRIMES = np.array([1, 2654435761, 805459861], dtype=np.uint32)


def _level_sum(v: jax.Array, n_levels: int) -> jax.Array:
    """(N, L*K) -> (N, L): sum each level's K consecutive columns."""
    return v.reshape(v.shape[0], n_levels, -1).sum(axis=-1)


def _interleave(per_feat) -> jax.Array:
    """F arrays (N, L) -> (N, L*F) with level l feature k at column l*F+k
    (the encoding's output layout)."""
    return jnp.stack(per_feat, axis=-1).reshape(per_feat[0].shape[0], -1)


def _feature_cotangents(g: jax.Array, n_features: int):
    """(N, L*F) output cotangent -> F arrays (N, L); transpose of
    _interleave."""
    g = g.reshape(g.shape[0], -1, n_features)
    return [g[..., k] for k in range(n_features)]


def grid_scale(level: int, log2_per_level_scale: float, base_resolution: int) -> float:
    return float(np.exp2(level * log2_per_level_scale) * base_resolution - 1.0)


def grid_resolution(scale: float) -> int:
    return int(math.ceil(scale)) + 1


@dataclasses.dataclass
class GridEncoding(Encoding):
    """Functional grid encoding. Parameters are one flat fp32 vector.

    `packed` (planar layout only, even F): the forward gathers a DERIVED
    table whose f32 words bit-pack two features of an entry as bf16, so
    one gather serves a feature pair. Forward feature precision becomes
    bf16 — the reference's tcnn stores grid params in fp16 (__half)
    anyway — while gradients scatter-add into the fp32 master exactly
    (custom VJP below)."""

    n_dims: int
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    per_level_scale: float = 2.0
    grid_type: str = "Hash"           # Hash | Dense | Tiled
    interpolation: str = "Linear"     # Linear | Smoothstep | Nearest
    dtype: Any = jnp.float32
    packed: bool = False
    # ROW-GATHER mode (when F divides 128): the table is stored
    # ENTRY-INTERLEAVED (feature k of entry e at flat e*F + k) and every
    # fetch/deposit moves a whole 128-float row holding the entry; the F
    # features are lane-selected forward, and the backward deposits a
    # one-hot 128-float row per (sample, level, corner). Off (the
    # default, the flat path): the planar layout (feature k of entry e
    # at k*n_words + e) with one f32 gather and one element scatter-add
    # per feature (or one gather per bf16 feature pair with `packed`).
    # On an H100 the flat path trains base.json about 2x faster than
    # the row path (PERF.md, PR 1).
    row_gather: bool = False
    # stochastic-corner training encode: along this many RANDOMLY-chosen
    # axes per (sample, level) the interpolation is computed exactly
    # (both endpoints gathered and weighted); the rest are
    # Bernoulli-sampled. 0 = pure 1-corner estimator (2^d fewer
    # fetches, highest variance); d-1 = 2^(d-1) fetches, lowest
    # stochastic variance. Trades fetch count against estimator
    # noise — see _build_stochastic_call.
    stochastic_exact_axes: int = 0
    # with stochastic_exact_axes > 0: scatter the table gradient at ONE
    # fully-Bernoulli corner (weight 1) instead of at every enumerated
    # forward corner — still unbiased (the Bernoulli distribution IS the
    # d-linear weight), halving/quartering backward scatter-adds;
    # gradient noise is better tolerated than forward noise (Adam
    # momentum averages it across steps).
    stochastic_bwd: bool = False
    # sort + segment-merge duplicate backward deposits before the row
    # scatter (coarse dense levels are duplicate-heavy); row mode only,
    # off by default
    bwd_coalesce: bool = False

    def __post_init__(self):
        assert self.n_dims in (2, 3), "grid encoding supports 2D and 3D inputs"
        self.n_output_dims = self.n_levels * self.n_features_per_level
        log2_pls = math.log2(self.per_level_scale)
        hashmap_size = 1 << self.log2_hashmap_size

        offsets, sizes, scales, resolutions, hashed = [], [], [], [], []
        offset = 0
        for lvl in range(self.n_levels):
            s = grid_scale(lvl, log2_pls, self.base_resolution)
            r = grid_resolution(s)
            dense_size = r ** self.n_dims
            # 8-aligned per-level size, capped at the hash table size (tcnn)
            if self.grid_type == "Dense":
                size = dense_size
                use_hash = False
            elif self.grid_type == "Tiled":
                size = min(dense_size, hashmap_size)
                use_hash = False
            else:  # Hash
                size = min(dense_size, hashmap_size)
                use_hash = dense_size > hashmap_size
            size = (size + 7) // 8 * 8
            offsets.append(offset)
            sizes.append(size)
            scales.append(s)
            resolutions.append(r)
            hashed.append(use_hash)
            offset += size

        self._offsets = np.asarray(offsets, np.int64)
        self._sizes = np.asarray(sizes, np.int64)
        self._scales = np.asarray(scales, np.float64)
        self._resolutions = np.asarray(resolutions, np.int64)
        self._hashed = np.asarray(hashed, bool)
        # row-gather needs whole rows of F-interleaved features
        self._row_mode = bool(self.row_gather) \
            and 128 % self.n_features_per_level == 0
        if self.bwd_coalesce and not self._row_mode:
            raise ValueError("bwd_coalesce applies only to the row-gather "
                             "backward (row_gather=True)")
        self._row_chunk = 1 << 22  # rows per gather/scatter chunk (2 GB)
        # Parameter layout (n_params is layout-independent):
        # - planar (default, row_gather=False): feature k of entry e at
        #   params[k * n_words + e]; keeps per-feature views contiguous
        #   so the packed bf16-pair table (pack_params) is elementwise.
        # - row mode: INTERLEAVED like tcnn — feature k of entry e at
        #   params[e * F + k], so one 128-float row holds 128/F whole
        #   entries and one row gather fetches all F features of an
        #   entry (see row_gather).
        self._n_words = int(offset)
        self._total_params = int(offset) * self.n_features_per_level

        # corner offsets in {0,1}^d, shape (2^d, d)
        self._corners = np.stack(np.meshgrid(
            *([np.arange(2)] * self.n_dims), indexing="ij"),
            axis=-1).reshape(-1, self.n_dims).astype(np.int32)

        # one fused gather over all levels; per-level dense strides (L, d)
        strides = np.ones((self.n_levels, self.n_dims), np.int64)
        for lvl in range(self.n_levels):
            for dim in range(1, self.n_dims):
                strides[lvl, dim] = strides[lvl, dim - 1] \
                    * self._resolutions[lvl]
        self._strides = strides
        self.fused = True

    @classmethod
    def from_config(cls, n_dims: int, config: Dict[str, Any], dtype=jnp.float32
                    ) -> "GridEncoding":
        otype = config.get("otype", "HashGrid")
        gtype = {"HashGrid": "Hash", "DenseGrid": "Dense", "TiledGrid": "Tiled",
                 "Grid": config.get("type", "Hash")}[otype]
        n_levels = config.get("n_levels", 16)
        base_res = config.get("base_resolution", 16)
        if "per_level_scale" in config:
            pls = config["per_level_scale"]
        elif "desired_resolution" in config and n_levels > 1:
            pls = math.exp(math.log(config["desired_resolution"] / base_res)
                           / (n_levels - 1))
        else:
            pls = 2.0
        return cls(
            n_dims=n_dims,
            n_levels=n_levels,
            n_features_per_level=config.get("n_features_per_level", 2),
            log2_hashmap_size=config.get("log2_hashmap_size", 19),
            base_resolution=base_res,
            per_level_scale=pls,
            grid_type=gtype,
            interpolation=config.get("interpolation", "Linear"),
            dtype=dtype,
            stochastic_exact_axes=config.get("stochastic_exact_axes", 0),
            stochastic_bwd=config.get("stochastic_bwd", False),
            bwd_coalesce=config.get("bwd_coalesce", False),
        )

    # ------------------------------------------------------------------
    @property
    def n_params(self) -> int:
        return self._total_params

    @property
    def layout(self) -> str:
        """Flat-parameter permutation: 'interleaved' (row mode) or
        'planar'. Same vector length either way; convert_layout maps
        between them (snapshots record the tag)."""
        return "interleaved" if self._row_mode else "planar"

    def convert_layout(self, params: jax.Array, src: str) -> jax.Array:
        """Convert a flat params/moment vector from layout `src` to this
        encoding's current layout (used by snapshot load)."""
        if src == self.layout:
            return params
        f = self.n_features_per_level
        w = self._n_words
        if src == "planar":   # (F planes of w) -> entry-interleaved
            return jnp.stack([params[k * w:(k + 1) * w]
                              for k in range(f)], axis=1).reshape(-1)
        # interleaved -> planar
        m = params.reshape(w, f)
        return jnp.concatenate([m[:, k] for k in range(f)])

    def convert_state_layout(self, state, src: str,
                             keys=("pos_encoding", "encoding")):
        """Convert every grid-table leaf (params AND optimizer moments,
        identified by dict key) in a trainer-state pytree from layout
        `src` to the current layout. Used by snapshot load, so snapshots
        saved from a row-mode (interleaved) encoder load into the default
        planar one and back."""
        if src == self.layout:
            return state

        def walk(node, under_grid=False):
            if isinstance(node, dict):
                return {k: walk(v, under_grid or k in keys)
                        for k, v in node.items()}
            if under_grid and hasattr(node, "shape") \
                    and np.prod(node.shape) == self._total_params:
                return self.convert_layout(
                    jnp.asarray(node).reshape(-1), src)
            return node

        return walk(state)

    def init(self, key: jax.Array) -> jax.Array:
        # tcnn grid default init: U(-1e-4, 1e-4)
        return jax.random.uniform(key, (self._total_params,), jnp.float32,
                                  -1e-4, 1e-4)

    def level_params(self, params: jax.Array, level: int) -> jax.Array:
        """The (size_l, F) parameter slice of one level."""
        f = self.n_features_per_level
        start = int(self._offsets[level])
        size = int(self._sizes[level])
        if self._row_mode:   # interleaved: entries contiguous
            block = params[start * f:(start + size) * f]
            return block.reshape(size, f)
        w = self._n_words
        cols = [params[k * w + start:k * w + start + size]
                for k in range(f)]
        if isinstance(params, np.ndarray):
            return np.stack(cols, axis=-1)
        return jnp.stack(cols, axis=-1)

    def _level_indices(self, level: int, x: jax.Array) -> Tuple[jax.Array, jax.Array]:
        """Corner flat indices (N, 2^d) within the level and lerp weights (N, 2^d)."""
        s = jnp.asarray(self._scales[level], x.dtype)
        res = int(self._resolutions[level])
        pos = x * s + 0.5
        pos0 = jnp.floor(pos)
        w = pos - pos0
        if self.interpolation == "Smoothstep":
            w = w * w * (3.0 - 2.0 * w)
        elif self.interpolation == "Nearest":
            w = jnp.round(w)
        pos0 = pos0.astype(jnp.int32)

        corners = jnp.asarray(self._corners)                     # (C, d)
        coords = pos0[:, None, :] + corners[None, :, :]          # (N, C, d)

        if self._hashed[level]:
            primes = jnp.asarray(_PRIMES[:self.n_dims])
            h = (coords.astype(jnp.uint32) * primes[None, None, :])
            idx = h[..., 0]
            for dim in range(1, self.n_dims):
                idx = idx ^ h[..., dim]
            idx = (idx % jnp.uint32(int(self._sizes[level]))).astype(jnp.int32)
        else:
            if self.grid_type == "Tiled":
                coords = jnp.remainder(coords, res)
            else:
                coords = jnp.clip(coords, 0, res - 1)
            idx = coords[..., 0]
            stride = 1
            for dim in range(1, self.n_dims):
                stride *= res
                idx = idx + coords[..., dim] * stride
            if self.grid_type == "Tiled":
                # capped tiled levels wrap the linear index into the table
                idx = idx % jnp.int32(int(self._sizes[level]))

        cw = jnp.where(corners[None, :, :] == 1, w[:, None, :], 1.0 - w[:, None, :])
        weights = jnp.prod(cw, axis=-1)                          # (N, C)
        return idx, weights

    def apply(self, params: jax.Array, x: jax.Array,
              max_level: Optional[jax.Array] = None,
              rng: Optional[jax.Array] = None, **kwargs) -> jax.Array:
        """Encode x (..., d) in [0,1]^d -> (..., L*F) features.

        max_level: optional scalar; levels with index > max_level produce
        zeros (reference set_max_level_gpu coarse-to-fine masking).
        rng: training-only stochastic-corner mode (see apply_components).
        """
        if self.fused:
            return self._apply_fused(params, x, max_level, rng=rng)
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.n_dims).astype(jnp.float32)
        n = xf.shape[0]
        f = self.n_features_per_level

        outs = []
        for lvl in range(self.n_levels):
            idx, weights = self._level_indices(lvl, xf)
            table = self.level_params(params, lvl)               # (size, F)
            feats = table[idx]                                   # (N, C, F)
            out = jnp.sum(feats * weights[..., None], axis=1)    # (N, F)
            if max_level is not None:
                out = out * (jnp.asarray(max_level) >= lvl).astype(out.dtype)
            outs.append(out)
        result = jnp.concatenate(outs, axis=-1).astype(self.dtype)
        return result.reshape(*lead, self.n_output_dims)

    def _fused_constants(self):
        """Per-(level, corner) constant vectors of length L*C, cached.

        Everything is component-separated (x/y/z planes) over one
        flattened (level, corner) axis of length L*2^d, so no large
        intermediate carries a trailing axis of 3."""
        if getattr(self, "_fc", None) is not None:
            return self._fc
        L, d = self.n_levels, self.n_dims
        C = 2 ** d
        rep = lambda a: np.repeat(np.asarray(a), C)              # (L*C,)
        tile_corner = lambda k: np.tile(self._corners[:, k], L)  # (L*C,)
        fc = {
            "scale": rep(self._scales).astype(np.float32),
            "res": rep(self._resolutions).astype(np.int32),
            "size": rep(self._sizes).astype(np.uint32),
            "hashed": rep(self._hashed.astype(np.int32)),
            "offset": rep(self._offsets).astype(np.uint32),
            "corner": [tile_corner(k).astype(np.int32) for k in range(d)],
            "stride": [rep(self._strides[:, k]).astype(np.uint32)
                       for k in range(d)],
            "level_of": rep(np.arange(L)).astype(np.int32),
        }
        self._fc = fc
        return fc

    def _apply_fused(self, params: jax.Array, x: jax.Array,
                     max_level: Optional[jax.Array] = None,
                     rng: Optional[jax.Array] = None) -> jax.Array:
        lead = x.shape[:-1]
        xf = x.reshape(-1, self.n_dims).astype(jnp.float32)
        comps = [xf[:, k] for k in range(self.n_dims)]
        out = self.apply_components(params, comps, max_level, rng=rng)
        return out.reshape(*lead, self.n_output_dims)

    def _fused_parts(self, comps, max_level=None, need_grads=False):
        """Shared index/weight math of the fused path: returns
        (entry (N, LC) int32, weight (N, LC) f32, aux). With need_grads,
        aux carries per-axis data for the hand-derived input gradient:
        w_sel[k] (corner-selected lerp weights) and dwsel_dx[k] =
        d w_sel_k / d x_k (sign x interpolant' x scale)."""
        d = self.n_dims
        fc = self._fused_constants()
        scale = jnp.asarray(fc["scale"])[None, :]                # (1, LC)
        weight = None
        idx_hash = None
        idx_dense = None
        w_sels = []
        dwsel_dx = []
        for k in range(d):
            pos_k = comps[k].astype(jnp.float32)[:, None] * scale + 0.5
            pos0_k = jnp.floor(pos_k)
            w_raw = pos_k - pos0_k
            if self.interpolation == "Smoothstep":
                w_k = w_raw * w_raw * (3.0 - 2.0 * w_raw)
                dw_k = 6.0 * w_raw * (1.0 - w_raw)
            elif self.interpolation == "Nearest":
                w_k = jnp.round(w_raw)
                dw_k = jnp.zeros_like(w_raw)
            else:
                w_k = w_raw
                dw_k = jnp.ones_like(w_raw)
            coord_k = pos0_k.astype(jnp.int32) \
                + jnp.asarray(fc["corner"][k])[None, :]
            res = jnp.asarray(fc["res"])[None, :]
            if self.grid_type == "Tiled":
                dense_k = jnp.remainder(coord_k, res)
            else:
                dense_k = jnp.clip(coord_k, 0, res - 1)
            term_dense = dense_k.astype(jnp.uint32) \
                * jnp.asarray(fc["stride"][k])[None, :]
            idx_dense = term_dense if idx_dense is None \
                else idx_dense + term_dense
            term_hash = coord_k.astype(jnp.uint32) * np.uint32(_PRIMES[k])
            idx_hash = term_hash if idx_hash is None \
                else idx_hash ^ term_hash
            sel = jnp.asarray(fc["corner"][k])[None, :] == 1
            w_sel = jnp.where(sel, w_k, 1.0 - w_k)
            weight = w_sel if weight is None else weight * w_sel
            if need_grads:
                sign = jnp.where(sel, 1.0, -1.0)
                w_sels.append(w_sel)
                dwsel_dx.append(sign * dw_k * scale)

        size = jnp.asarray(fc["size"])[None, :]
        hashed = jnp.asarray(fc["hashed"])[None, :]
        idx = jnp.where(hashed == 1, idx_hash % size, idx_dense % size)
        entry = (jnp.asarray(fc["offset"])[None, :] + idx).astype(jnp.int32)

        if max_level is not None:
            lvl = jnp.asarray(fc["level_of"])[None, :]
            weight = weight * (jnp.asarray(max_level) >= lvl)
        return entry, weight, {"w_sel": w_sels, "dwsel_dx": dwsel_dx}

    # ---- bf16-pair packing (see class docstring) ----

    def pack_params(self, params: jax.Array) -> jax.Array:
        """(total,) f32 master -> (total/2,) f32 words. Feature PAIR p of
        entry e lives at word [p*n_words + e], bit-packing features 2p
        (high) and 2p+1 (low) as bf16. Works for any even F (the
        reference fork's NeRF config uses L=8, F=4).

        Planar layout makes every feature view a contiguous slice, so
        this is pure elementwise work (no stride-2 gathers)."""
        w = self._n_words
        words = []
        for p in range(self.n_features_per_level // 2):
            f0 = params[(2 * p) * w:(2 * p + 1) * w].astype(jnp.bfloat16)
            f1 = params[(2 * p + 1) * w:(2 * p + 2) * w].astype(jnp.bfloat16)
            hi = jax.lax.bitcast_convert_type(
                f0, jnp.uint16).astype(jnp.uint32)
            lo = jax.lax.bitcast_convert_type(
                f1, jnp.uint16).astype(jnp.uint32)
            words.append(
                jax.lax.bitcast_convert_type((hi << 16) | lo, jnp.float32))
        return words[0] if len(words) == 1 else jnp.concatenate(words)

    def _gather_pair_words(self, params: jax.Array, entry: jax.Array):
        """Gather the packed bf16-pair words of every feature pair at
        `entry`: returns a list of F//2 arrays shaped like entry."""
        f = self.n_features_per_level
        packed = self.pack_params(params)
        return [packed[p * self._n_words + entry] for p in range(f // 2)]

    # ---- row-gather fast path (see row_gather docstring) ----

    def _row_table(self, params: jax.Array) -> jax.Array:
        """(total,) interleaved master -> (rows, 128) view, padded to a
        whole number of rows (the pad is one dense elementwise copy)."""
        total = params.shape[0]
        pad = (-total) % 128
        if pad:
            params = jnp.pad(params, (0, pad))
        return params.reshape(-1, 128)

    def _row_gather_features(self, params: jax.Array, entry: jax.Array):
        """entry (any shape, global ENTRY index) -> list of F f32 arrays
        shaped like entry. One row gather per entry fetches the
        128-float row holding it; the F features are lane-selected from
        the row.

        Large batches run the chunks under lax.map: the row payload is
        128x the selected features, so letting XLA hoist independent
        chunk gathers would materialize ALL (chunk, 128) buffers at once;
        lax.map pins peak memory to one chunk."""
        f = self.n_features_per_level
        epr = 128 // f
        table = self._row_table(params)
        flat = entry.reshape(-1)
        n = flat.shape[0]
        chunk = self._row_chunk
        lanes = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)

        def select(e):
            rows = table[e // epr]                              # (c, 128)
            off = ((e % epr) * f)[:, None]
            return jnp.stack(
                [jnp.sum(jnp.where(lanes == off + k, rows, 0.0), axis=-1)
                 for k in range(f)])                            # (F, c)

        if n <= chunk:
            feats = select(flat)                                # (F, n)
        else:
            n_chunks = (n + chunk - 1) // chunk
            pad = n_chunks * chunk - n
            ec = jnp.pad(flat, (0, pad)).reshape(n_chunks, chunk)
            out = jax.lax.map(select, ec)                 # (nc, F, chunk)
            feats = jnp.transpose(out, (1, 0, 2)).reshape(f, -1)[:, :n]
        return [feats[k].reshape(entry.shape) for k in range(f)]

    def _coalesce_deposits(self, flat: jax.Array, gflat):
        """Sort deposits by entry and merge duplicate runs (segmented
        Hillis-Steele scan — dense shifts only, valid because keys are
        sorted), pointing merged-away lanes at an out-of-bounds
        sentinel so the scatter drops them. Duplication is heavy on the
        coarse dense levels (2^18 samples deposit into 4k entries).
        Gated by `bwd_coalesce`."""
        n = flat.shape[0]
        sorted_all = jax.lax.sort((flat, *gflat), num_keys=1)
        e_s, segs = sorted_all[0], list(sorted_all[1:])
        shift = 1
        while shift < n:
            same = jnp.concatenate(
                [jnp.zeros(shift, bool), e_s[shift:] == e_s[:-shift]])
            segs = [s + jnp.where(
                same, jnp.concatenate(
                    [jnp.zeros(shift, s.dtype), s[:-shift]]), 0.0)
                for s in segs]
            shift *= 2
        is_end = jnp.concatenate([e_s[:-1] != e_s[1:],
                                  jnp.ones(1, bool)])
        sentinel = jnp.int32(self._total_params)  # row >= table rows
        e_dep = jnp.where(is_end, e_s, sentinel)
        return e_dep, [jnp.where(is_end, s, 0.0) for s in segs]

    def _row_scatter_add(self, acc2d: jax.Array, entry: jax.Array, gs):
        """Accumulate per-feature gradients gs (list of F arrays shaped
        like entry) at `entry` into the (rows, 128) accumulator: each
        entry deposits ONE one-hot 128-float row carrying all F feature
        grads. Chunks run under fori_loop so one (chunk, 128) update
        buffer exists at a time."""
        f = self.n_features_per_level
        epr = 128 // f
        flat = entry.reshape(-1)
        gflat = [g.reshape(-1) for g in gs]
        if self.bwd_coalesce:
            flat, gflat = self._coalesce_deposits(flat, gflat)
        n = flat.shape[0]
        chunk = self._row_chunk
        lanes = jax.lax.broadcasted_iota(jnp.int32, (1, 128), 1)

        def deposit(acc, e, gks):
            off = ((e % epr) * f)[:, None]
            rows = None
            for k in range(f):
                r = jnp.where(lanes == off + k, gks[k][:, None], 0.0)
                rows = r if rows is None else rows + r
            # drop: coalesced deposits point merged lanes out of bounds
            return acc.at[e // epr].add(rows, mode="drop")

        if n <= chunk:
            return deposit(acc2d, flat, gflat)
        n_chunks = (n + chunk - 1) // chunk
        pad = n_chunks * chunk - n
        ec = jnp.pad(flat, (0, pad)).reshape(n_chunks, chunk)
        # zero-padded gradients make the tail updates no-op row adds
        gc = [jnp.pad(g, (0, pad)).reshape(n_chunks, chunk) for g in gflat]

        def body(i, acc):
            return deposit(acc, ec[i], [g[i] for g in gc])

        return jax.lax.fori_loop(0, n_chunks, body, acc2d)

    def _row_acc_init(self) -> jax.Array:
        rows = (self._total_params + 127) // 128
        return jnp.zeros((rows, 128), jnp.float32)

    def _row_acc_finish(self, acc2d: jax.Array) -> jax.Array:
        return acc2d.reshape(-1)[:self._total_params]

    def _fetch_feats(self, params: jax.Array, entry: jax.Array):
        """List of F f32 feature arrays at `entry`. Row mode: one row
        gather per entry (f32 precision). Planar packed: one bf16-pair
        word per two features. Planar flat: one f32 gather per feature."""
        f = self.n_features_per_level
        if self._row_mode:
            return self._row_gather_features(params, entry)
        if not (self.packed and f % 2 == 0):
            return [params[k * self._n_words + entry] for k in range(f)]
        words = self._gather_pair_words(params, entry)
        feats = []
        for w in words:
            v0, v1 = self.unpack_words(w)
            feats += [v0, v1]
        return feats

    @staticmethod
    def unpack_words(words: jax.Array):
        """packed f32 words -> (feat0, feat1) f32 arrays, same shape."""
        w = jax.lax.bitcast_convert_type(words, jnp.uint32)
        f0 = jax.lax.bitcast_convert_type(
            (w >> 16).astype(jnp.uint16), jnp.bfloat16)
        f1 = jax.lax.bitcast_convert_type(
            w.astype(jnp.uint16), jnp.bfloat16)
        return f0.astype(jnp.float32), f1.astype(jnp.float32)

    def _corner_cotangents(self, g: jax.Array):
        """(N, L*F) output cotangent -> F arrays (N, L*C): each level's
        feature cotangent broadcast to its C corners."""
        c = 2 ** self.n_dims
        return [jnp.repeat(gk, c, axis=1)
                for gk in _feature_cotangents(g.astype(jnp.float32),
                                              self.n_features_per_level)]

    def _input_grads(self, aux, dweight, comps, max_level):
        """Hand-derived d-linear input gradient (camera optimization,
        Normals rendering, mesh refinement):
        dx_k = sum_lc dweight * (dw_sel_k/dx_k) * prod_{j!=k} w_sel_j."""
        d = self.n_dims
        w_sel = aux["w_sel"]
        dcomps = []
        for k in range(d):
            pe = None                                        # prod except k
            for j in range(d):
                if j == k:
                    continue
                pe = w_sel[j] if pe is None else pe * w_sel[j]
            if pe is None:
                pe = jnp.ones_like(dweight)
            if max_level is not None:
                # weight carried the coarse-to-fine mask; replicate it
                lvl = jnp.asarray(self._fused_constants()["level_of"])
                pe = pe * (jnp.asarray(max_level) >= lvl[None, :])
            dx = jnp.sum(dweight * aux["dwsel_dx"][k] * pe, axis=1)
            dcomps.append(dx.astype(comps[k].dtype))
        return tuple(dcomps)

    def _build_packed_call(self):
        """custom-VJP fused encode with one gather per (sample, level,
        corner, feature pair). Gradients: exact fp32 scatter-add into
        the master for the table; hand-derived d-linear spatial gradient
        for the inputs."""
        f = self.n_features_per_level
        L = self.n_levels

        def fwd_impl(params, comps, max_level):
            entry, weight, _ = self._fused_parts(comps, max_level)
            words_all = self._gather_pair_words(params, entry)
            per_feat = []
            for p in range(f // 2):
                v0, v1 = self.unpack_words(words_all[p])     # (N, LC)
                per_feat += [_level_sum(v0 * weight, L),
                             _level_sum(v1 * weight, L)]
            return _interleave(per_feat), tuple(words_all)

        @jax.custom_vjp
        def call(params, comps, max_level):
            return fwd_impl(params, comps, max_level)[0]

        def call_fwd(params, comps, max_level):
            out, words = fwd_impl(params, comps, max_level)
            return out, (params.shape[0], comps, max_level, words)

        def call_bwd(res, g):
            n_params, comps, max_level, words_all = res
            entry, weight, aux = self._fused_parts(comps, max_level,
                                                   need_grads=True)
            gks = self._corner_cotangents(g)                 # F x (N, LC)

            # table gradient: dL/dvals = g_k * weight, scatter-added at
            # the master's per-feature planes (exact fp32); and
            # dweight = sum_k g_k * vals_k for the input gradient
            flat = entry.reshape(-1)
            dweight = None
            dparams = jnp.zeros(n_params, jnp.float32)
            for p in range(f // 2):
                g0, g1 = gks[2 * p], gks[2 * p + 1]
                dparams = dparams.at[(2 * p) * self._n_words
                                     + flat].add(
                    (g0 * weight).reshape(-1))
                dparams = dparams.at[(2 * p + 1) * self._n_words
                                     + flat].add(
                    (g1 * weight).reshape(-1))
                v0, v1 = self.unpack_words(words_all[p])
                dw = g0 * v0 + g1 * v1                       # (N, LC)
                dweight = dw if dweight is None else dweight + dw
            dml = None if max_level is None else jnp.zeros_like(max_level)
            return (dparams, self._input_grads(aux, dweight, comps,
                                               max_level), dml)

        call.defvjp(call_fwd, call_bwd)
        return call

    def _build_row_call(self):
        """Exact d-linear encode on the row-gather path: custom VJP with
        one row gather per (sample, level, corner) in BOTH directions —
        the forward lane-selects all F features from the gathered row
        (full f32 precision), the backward deposits all F feature grads
        as one one-hot row scatter-add. Input gradients are the same
        hand-derived d-linear terms as the packed path."""
        L = self.n_levels

        def fwd_impl(params, comps, max_level):
            entry, weight, _ = self._fused_parts(comps, max_level)
            feats = self._row_gather_features(params, entry)  # F x (N,LC)
            out = _interleave([_level_sum(v * weight, L) for v in feats])
            return out, tuple(feats)

        @jax.custom_vjp
        def call(params, comps, max_level):
            return fwd_impl(params, comps, max_level)[0]

        def call_fwd(params, comps, max_level):
            out, feats = fwd_impl(params, comps, max_level)
            return out, (comps, max_level, feats)

        def call_bwd(res, g):
            comps, max_level, feats = res
            entry, weight, aux = self._fused_parts(comps, max_level,
                                                   need_grads=True)
            gks, dweight = [], None
            for gk, v in zip(self._corner_cotangents(g), feats):
                gks.append(gk * weight)
                dweight = gk * v if dweight is None else dweight + gk * v
            dparams = self._row_acc_finish(self._row_scatter_add(
                self._row_acc_init(), entry, gks))
            dml = None if max_level is None else jnp.zeros_like(max_level)
            return (dparams, self._input_grads(aux, dweight, comps,
                                               max_level), dml)

        call.defvjp(call_fwd, call_bwd)
        return call

    # ---- stochastic-corner training mode ----

    def _stoch_constants(self):
        """Per-LEVEL constants (length L) for the stochastic path, cached."""
        if getattr(self, "_sc", None) is not None:
            return self._sc
        L, d = self.n_levels, self.n_dims
        sc = {
            "scale": self._scales.astype(np.float32),
            "res": self._resolutions.astype(np.int32),
            "size": self._sizes.astype(np.uint32),
            "hashed": self._hashed.astype(np.int32),
            "offset": self._offsets.astype(np.uint32),
            "stride": [self._strides[:, k].astype(np.uint32)
                       for k in range(d)],
            "level_of": np.arange(L, dtype=np.int32),
        }
        self._sc = sc
        return sc

    def _build_stochastic_call(self, j_exact: int):
        """custom-VJP encode that samples corners per (sample, level)
        with probability equal to the d-linear weight — an unbiased
        estimator of the d-linear interpolation with up to 2^d fewer
        table gathers and scatter-adds.

        `j_exact` (config default: stochastic_exact_axes) trades
        fetches for variance: along j randomly-chosen axes the
        interpolation is computed EXACTLY (both endpoints enumerated and
        weighted), the remaining d-j axes are Bernoulli-sampled — 2^j
        fetches per (sample, level) instead of 2^d. j=0 is the
        original 1-corner estimator (callers tolerant of extra variance
        — e.g. the density-grid EMA-max prep, which already samples one
        random position per cell — pass exact_axes=0 to halve their
        fetches).

        Training-only: the backward returns ZERO input gradients (callers
        that need dL/dx — camera/distortion optimization, Normals — must
        use the exact path). Table gradients scatter-add the output
        cotangent times the corner weight, whose expectation is the exact
        d-linearly weighted gradient."""
        sc = self._stoch_constants()
        d = self.n_dims
        assert 0 <= j_exact < d

        res_arr = np.asarray(sc["res"])[None, :]

        def _terms(coord_k, k):
            """coord (N, L) int32 -> (dense term, hash term) uint32."""
            if self.grid_type == "Tiled":
                dense_k = jnp.remainder(coord_k, res_arr)
            else:
                dense_k = jnp.clip(coord_k, 0, res_arr - 1)
            term_dense = dense_k.astype(jnp.uint32) \
                * jnp.asarray(sc["stride"][k])[None, :]
            term_hash = coord_k.astype(jnp.uint32) * np.uint32(_PRIMES[k])
            return term_dense, term_hash

        def parts(comps, rng):
            """-> list of (entry (N, L) int32, weight (N, L) f32|None).

            weight None means 1 (pure Bernoulli corner)."""
            scale = jnp.asarray(sc["scale"])[None, :]            # (1, L)
            keys = jax.random.split(rng, d + 1)
            pos0, w, bern = [], [], []
            for k in range(d):
                pos_k = comps[k].astype(jnp.float32)[:, None] * scale + 0.5
                pos0_k = jnp.floor(pos_k)
                w_raw = pos_k - pos0_k
                if self.interpolation == "Smoothstep":
                    w_k = w_raw * w_raw * (3.0 - 2.0 * w_raw)
                elif self.interpolation == "Nearest":
                    w_k = jnp.round(w_raw)
                else:
                    w_k = w_raw
                u_k = jax.random.uniform(keys[k], w_k.shape)
                pos0.append(pos0_k.astype(jnp.int32))
                w.append(w_k)
                bern.append((u_k < w_k).astype(jnp.int32))

            size = jnp.asarray(sc["size"])[None, :]
            hashed = jnp.asarray(sc["hashed"])[None, :]
            offset = jnp.asarray(sc["offset"])[None, :]

            def entry_from_bits(bits):
                idx_dense = None
                idx_hash = None
                for k in range(d):
                    td, th = _terms(pos0[k] + bits[k], k)
                    idx_dense = td if idx_dense is None else idx_dense + td
                    idx_hash = th if idx_hash is None else idx_hash ^ th
                idx = jnp.where(hashed == 1, idx_hash % size,
                                idx_dense % size)
                return (offset + idx).astype(jnp.int32)

            if j_exact == 0:
                e = entry_from_bits(bern)
                return [(e, None)], e

            # choose which axes are exact, per (sample, level): pick a
            # uniformly random axis a; j=1 -> a is exact; j=2 (d=3) ->
            # a is the Bernoulli axis, the other two are exact
            a = jax.random.randint(keys[d], bern[0].shape, 0, d)
            out = []
            n_enum = 1 << j_exact
            for combo in range(n_enum):
                bits, weight = [], None
                for k in range(d):
                    if j_exact == 1:
                        exact_k = (a == k)
                        # the single exact axis takes enum bit combo&1
                        e_bit = combo & 1
                    else:                      # j == d-1 == 2
                        exact_k = (a != k)
                        # enum bits assigned to exact axes in cyclic
                        # order after the stochastic axis a
                        off_k = (k - a - 1) % d  # 0 or 1 for exact axes
                        e_bit = (combo >> 1) & 1
                        e_bit = jnp.where(off_k == 0, combo & 1, e_bit)
                    eb = jnp.asarray(e_bit, jnp.int32)
                    bit_k = jnp.where(exact_k, eb, bern[k])
                    w_sel = jnp.where(eb == 1, w[k], 1.0 - w[k])
                    w_k = jnp.where(exact_k, w_sel, 1.0)
                    bits.append(bit_k)
                    weight = w_k if weight is None else weight * w_k
                out.append((entry_from_bits(bits), weight))
            bwd_entry = entry_from_bits(bern) if self.stochastic_bwd \
                else None
            return out, bwd_entry

        def fwd_impl(params, comps, rng, max_level):
            F = self.n_features_per_level
            pairs, bwd_entry = parts(comps, rng)
            mask = None
            if max_level is not None:
                lvl = jnp.asarray(sc["level_of"])[None, :]
                mask = (jnp.asarray(max_level) >= lvl).astype(jnp.float32)
            acc = [None] * F
            for entry, weight in pairs:
                feats = self._fetch_feats(params, entry)         # F x (N, L)
                scale = weight if mask is None else (
                    mask if weight is None else weight * mask)
                for k in range(F):
                    v = feats[k] if scale is None else feats[k] * scale
                    acc[k] = v if acc[k] is None else acc[k] + v
            out = _interleave(acc)
            if self.stochastic_bwd and bwd_entry is not None:
                scatter_pairs = [(bwd_entry, None)]
            else:
                scatter_pairs = pairs
            return out, scatter_pairs

        @jax.custom_vjp
        def call(params, comps, rng, max_level):
            return fwd_impl(params, comps, rng, max_level)[0]

        def call_fwd(params, comps, rng, max_level):
            out, pairs = fwd_impl(params, comps, rng, max_level)
            return out, (params.shape[0], pairs, max_level, comps)

        def call_bwd(res, g):
            F = self.n_features_per_level
            n_params, pairs, max_level, comps = res
            base_gks = _feature_cotangents(g.astype(jnp.float32), F)
            if max_level is not None:
                lvl = jnp.asarray(sc["level_of"])[None, :]
                mask = (jnp.asarray(max_level) >= lvl).astype(jnp.float32)
                base_gks = [gk * mask for gk in base_gks]        # (N, L)
            if self._row_mode:
                # one one-hot row deposit per (sample, level) corner
                # carries all F feature grads
                acc = self._row_acc_init()
                for entry, weight in pairs:
                    gs = [gk if weight is None else gk * weight
                          for gk in base_gks]
                    acc = self._row_scatter_add(acc, entry, gs)
                dparams = self._row_acc_finish(acc)
            else:
                dparams = jnp.zeros(n_params, jnp.float32)
                for entry, weight in pairs:
                    flat = entry.reshape(-1)
                    for k in range(F):
                        gk = base_gks[k] if weight is None \
                            else base_gks[k] * weight
                        dparams = dparams.at[
                            k * self._n_words + flat].add(gk.reshape(-1))
            dcomps = tuple(jnp.zeros_like(c) for c in comps)
            dml = None if max_level is None else jnp.zeros_like(max_level)
            return dparams, dcomps, None, dml

        call.defvjp(call_fwd, call_bwd)
        return call

    def apply_components(self, params: jax.Array, comps,
                         max_level: Optional[jax.Array] = None,
                         rng: Optional[jax.Array] = None,
                         exact_axes: Optional[int] = None) -> jax.Array:
        """All levels+corners in one flattened (N, L*2^d) axis; corners
        and features reduce by reshape and sum.

        `comps`: list of d arrays (N,) — component-separated input keeps
        every large intermediate's trailing dim at L*C instead of 3.

        `rng`: when given (training only), use the stochastic-corner
        estimator — one fetch per (sample, level, enumerated corner)
        instead of per 2^d corners — see _build_stochastic_call.

        `exact_axes`: per-call override of stochastic_exact_axes (only
        meaningful with rng) — variance-tolerant callers pass 0."""
        f = self.n_features_per_level
        if rng is not None:
            j = int(getattr(self, "stochastic_exact_axes", 0)) \
                if exact_axes is None else int(exact_axes)
            if getattr(self, "_stoch_calls", None) is None:
                self._stoch_calls = {}
            if j not in self._stoch_calls:
                self._stoch_calls[j] = self._build_stochastic_call(j)
            ml = None if max_level is None \
                else jnp.asarray(max_level, jnp.float32)
            out = self._stoch_calls[j](params, tuple(comps), rng, ml)
            return out.astype(self.dtype)
        if self._row_mode:
            if getattr(self, "_row_call", None) is None:
                self._row_call = self._build_row_call()
            ml = None if max_level is None \
                else jnp.asarray(max_level, jnp.float32)
            out = self._row_call(params, tuple(comps), ml)
            return out.astype(self.dtype)
        if self.packed and f % 2 == 0:
            if getattr(self, "_packed_call", None) is None:
                self._packed_call = self._build_packed_call()
            ml = None if max_level is None \
                else jnp.asarray(max_level, jnp.float32)
            out = self._packed_call(params, tuple(comps), ml)
            return out.astype(self.dtype)

        # flat path: one f32 gather per (sample, level, corner, feature);
        # autodiff gives the table gradient as a scatter-add
        entry, weight, _ = self._fused_parts(comps, max_level)
        out = _interleave([_level_sum(v * weight, self.n_levels)
                           for v in self._fetch_feats(params, entry)])
        return out.astype(self.dtype)

    def level_stats(self, params: jax.Array):
        """Per-level parameter statistics (the reference's LevelStats /
        gather_histograms diagnostics, testbed.h:370-384, testbed.cu:1719-
        1747): list of dicts with min/max/mean/sigma/fraczero/count."""
        params = np.asarray(params)
        stats = []
        for lvl in range(self.n_levels):
            t = np.asarray(self.level_params(params, lvl)).ravel()
            nz = t[t != 0.0]
            n = t.size
            stats.append({
                "min": float(t.min()) if n else 0.0,
                "max": float(t.max()) if n else 0.0,
                "mean": float(t.mean()) if n else 0.0,
                "sigma": float(t.std()) if n else 0.0,
                "fraczero": float(1.0 - nz.size / n) if n else 0.0,
                "count": int(n),
            })
        return stats
