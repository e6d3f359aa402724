"""NerfNetwork: hash-grid density model + view-dependent RGB head.

Re-implements include/neural-graphics-primitives/nerf_network.h:31-503:
- density path: pos in [0,1]^3 → pos_encoding (HashGrid) → density MLP
  with 16 raw outputs; channel 0 is the (pre-activation) density;
- color path: warped dir (+ optional extra latent dims) → dir_encoding
  (SH degree 4 ‖ Identity composite) → concat(density outputs, dir feats)
  → RGB MLP → 3 raw outputs;
- full output layout: [rgb0, rgb1, rgb2, density] (4 channels), all
  PRE-activation — the composite/loss code applies rgb/density
  activations, matching network_to_rgb/network_to_density
  (nerf_device.cuh:230-262);
- `density()` fast path evaluates only the density half (used by the
  occupancy-grid update and marching cubes).

Design: both MLPs are bf16 matmuls with fp32 accumulation; the hash
encoding is fp32 (table gathers + lerp fuse into the first matmul's
producers). Params are one pytree: {"pos_encoding", "density_net",
"dir_encoding", "rgb_net"}.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp

from ..ops.encodings import create_encoding
from ..ops.factory import derive_grid_config
from ..ops.mlp import MLP


class NerfNetwork:
    def __init__(self, n_pos_dims: int, n_dir_dims: int, n_extra_dims: int,
                 encoding_config: Dict[str, Any],
                 dir_encoding_config: Dict[str, Any],
                 network_config: Dict[str, Any],
                 rgb_network_config: Dict[str, Any],
                 desired_resolution: float = 2048.0,
                 aabb_scale: float = 1.0,
                 compute_dtype=jnp.bfloat16):
        self.n_pos_dims = n_pos_dims
        self.n_dir_dims = n_dir_dims
        self.n_extra_dims = n_extra_dims

        enc_cfg = derive_grid_config(encoding_config, n_pos_dims,
                                     desired_resolution, aabb_scale)
        self.pos_encoding = create_encoding(n_pos_dims, enc_cfg)
        self.resolved_encoding_config = enc_cfg

        # dir encoding consumes dir + extra dims (Composite SH+Identity)
        self.dir_encoding = create_encoding(n_dir_dims + n_extra_dims,
                                            dir_encoding_config)

        n_density_out = int(network_config.get("n_output_dims", 16))
        self.density_net = MLP.from_config(
            self.pos_encoding.n_output_dims, n_density_out, network_config,
            compute_dtype=compute_dtype)
        self.rgb_net = MLP.from_config(
            n_density_out + self.dir_encoding.n_output_dims, 3,
            rgb_network_config, compute_dtype=compute_dtype)
        self.n_density_out = n_density_out

    # ------------------------------------------------------------------
    @property
    def n_params(self) -> int:
        return (self.pos_encoding.n_params + self.dir_encoding.n_params
                + self.density_net.n_params + self.rgb_net.n_params)

    def init(self, key: jax.Array) -> Dict[str, Any]:
        k1, k2, k3, k4 = jax.random.split(key, 4)
        return {
            "pos_encoding": self.pos_encoding.init(k1),
            "density_net": self.density_net.init(k2),
            "dir_encoding": self.dir_encoding.init(k3),
            "rgb_net": self.rgb_net.init(k4),
        }

    # ------------------------------------------------------------------
    def density_forward(self, params, pos: jax.Array,
                        max_level: Optional[jax.Array] = None) -> jax.Array:
        """pos (..., 3) warped → raw density-net outputs (..., 16)."""
        feats = self.pos_encoding.apply(params["pos_encoding"], pos,
                                        max_level=max_level)
        return self.density_net.apply(params["density_net"], feats)

    def density(self, params, pos: jax.Array,
                max_level: Optional[jax.Array] = None) -> jax.Array:
        """Raw (pre-activation) density, channel 0 (..., )."""
        return self.density_forward(params, pos, max_level)[..., 0]

    def apply(self, params, pos: jax.Array, dir_warped: jax.Array,
              extra: Optional[jax.Array] = None,
              max_level: Optional[jax.Array] = None) -> jax.Array:
        """Full forward: (..., 4) raw [r, g, b, density]."""
        density_out = self.density_forward(params, pos, max_level)
        dir_in = dir_warped
        if self.n_extra_dims:
            if extra is None:
                raise ValueError("model expects extra dims")
            dir_in = jnp.concatenate([dir_warped, extra], axis=-1)
        dir_feats = self.dir_encoding.apply(params["dir_encoding"], dir_in)
        rgb_in = jnp.concatenate(
            [density_out.astype(jnp.float32),
             dir_feats.astype(jnp.float32)], axis=-1)
        rgb = self.rgb_net.apply(params["rgb_net"], rgb_in)
        return jnp.concatenate([rgb, density_out[..., :1]], axis=-1)

    def apply_components(self, params, pos_comps, dir_comps,
                         extra: Optional[jax.Array] = None,
                         max_level: Optional[jax.Array] = None,
                         pos_feats: Optional[jax.Array] = None,
                         encode_rng: Optional[jax.Array] = None):
        """Structure-of-arrays forward: pos/dir as lists of 3 (N,) arrays.

        Returns (rgb_raw (N, 3-as-channels...), density_raw (N,)) — i.e. a
        tuple (r, g, b, sigma) of (N,) arrays, avoiding any big (N, 3/4)
        result buffer.

        pos_feats: optional precomputed position features (the tensor-
        parallel path computes them with a level-sharded table and
        all-gathers before the MLPs — parallel/tp.py).

        encode_rng: when given (training only) the grid encoding runs in
        stochastic-corner mode — one sampled corner per (sample, level)
        instead of 2^d, an unbiased estimator with 8x fewer table
        gathers and scatter-adds. Callers needing
        dL/d(pos) must leave it None."""
        if pos_feats is not None:
            feats = pos_feats
        elif encode_rng is not None and hasattr(self.pos_encoding,
                                                "apply_components"):
            feats = self.pos_encoding.apply_components(
                params["pos_encoding"], pos_comps, max_level=max_level,
                rng=encode_rng)
        elif hasattr(self.pos_encoding, "apply_components"):
            feats = self.pos_encoding.apply_components(
                params["pos_encoding"], pos_comps, max_level=max_level)
        else:
            feats = self.pos_encoding.apply(
                params["pos_encoding"], jnp.stack(pos_comps, -1),
                max_level=max_level)
        density_out = self.density_net.apply(params["density_net"], feats)

        dir_enc = self.dir_encoding
        # the shipped dir encodings are SH or Composite(SH, Identity)
        from ..ops.encodings import CompositeEncoding

        if isinstance(dir_enc, CompositeEncoding) and self.n_extra_dims:
            sh = dir_enc.nested[0]
            sh_out = sh.apply_components(None, dir_comps) \
                if hasattr(sh, "apply_components") else \
                sh.apply(None, jnp.stack(dir_comps, -1))
            rest = dir_enc.nested[1].apply(None, extra)
            dir_feats = jnp.concatenate([sh_out, rest], axis=-1)
        elif hasattr(dir_enc, "apply_components"):
            dir_feats = dir_enc.apply_components(params["dir_encoding"],
                                                 dir_comps)
        else:
            dir_feats = dir_enc.apply(params["dir_encoding"],
                                      jnp.stack(dir_comps, -1))
        rgb_in = jnp.concatenate(
            [density_out.astype(jnp.float32),
             dir_feats.astype(jnp.float32)], axis=-1)
        rgb = self.rgb_net.apply(params["rgb_net"], rgb_in)
        return (rgb[..., 0], rgb[..., 1], rgb[..., 2], density_out[..., 0])


@dataclasses.dataclass
class NerfActivations:
    """rgb/density output activations (nerf.h:151-153 + the HDR override in
    load_nerf_post, testbed_nerf.cu:2152)."""

    rgb: str = "Logistic"          # Exponential when dataset is HDR
    density: str = "Exponential"


def network_to_rgb(raw: jax.Array, activation: str) -> jax.Array:
    from ..ops.mlp import apply_activation

    if activation == "Exponential":
        return jnp.exp(jnp.clip(raw, -10.0, 10.0))  # reference clamps exp
    return apply_activation(activation, raw)


def network_to_rgb_derivative(raw: jax.Array, activation: str) -> jax.Array:
    if activation == "Exponential":
        return jnp.exp(jnp.clip(raw, -10.0, 10.0))
    from ..ops.mlp import activation_derivative

    return activation_derivative(activation, raw)


def network_to_density(raw: jax.Array, activation: str) -> jax.Array:
    # note: the density exp is UNclamped in the reference; only its
    # derivative clamps (nerf_device.cuh:234-253)
    from ..ops.mlp import apply_activation

    return apply_activation(activation, raw)


def network_to_density_derivative(raw: jax.Array, activation: str
                                  ) -> jax.Array:
    if activation == "Exponential":
        return jnp.exp(jnp.clip(raw, -15.0, 15.0))
    from ..ops.mlp import activation_derivative

    return activation_derivative(activation, raw)
