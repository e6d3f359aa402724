"""Input encodings: Identity, Frequency, SphericalHarmonics, OneBlob,
TriangleWave, Composite, and the grid family (via grid_encoding.py).

JAX re-implementations of the tcnn encodings the reference
instantiates through `create_encoding` (src/testbed.cu:3816-3825) and its
JSON configs (configs/nerf/base.json:35-48, configs/image/oneblob.json,
configs/sdf/takikawa.json, ...). All encodings are functional:
`init(key) -> params` (None when untrainable), `apply(params, x) -> feats`
with x of shape (..., n_dims) in [0, 1].
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


class Encoding:
    """Base interface. n_dims: input dims consumed; n_output_dims: features."""

    n_dims: int
    n_output_dims: int

    @property
    def n_params(self) -> int:
        return 0

    def init(self, key: jax.Array):
        return None

    def apply(self, params, x: jax.Array, **kwargs) -> jax.Array:
        raise NotImplementedError


@dataclasses.dataclass
class IdentityEncoding(Encoding):
    """tcnn Identity: out = x * scale + offset."""

    n_dims: int
    scale: float = 1.0
    offset: float = 0.0

    def __post_init__(self):
        self.n_output_dims = self.n_dims

    def apply(self, params, x, **kwargs):
        return x * self.scale + self.offset


@dataclasses.dataclass
class FrequencyEncoding(Encoding):
    """NeRF positional encoding: [sin, cos](x * pi * 2^k) per dim per octave.

    Matches tcnn Frequency (used by configs/nerf/frequency.json).
    Output layout: per input dim, per frequency, (sin, cos).
    """

    n_dims: int
    n_frequencies: int = 12

    def __post_init__(self):
        self.n_output_dims = self.n_dims * self.n_frequencies * 2

    def apply(self, params, x, **kwargs):
        freqs = (2.0 ** jnp.arange(self.n_frequencies, dtype=x.dtype)) * jnp.pi
        ang = x[..., :, None] * freqs  # (..., n_dims, n_freq)
        feats = jnp.stack([jnp.sin(ang), jnp.cos(ang)], axis=-1)
        return feats.reshape(*x.shape[:-1], self.n_output_dims)


# Real spherical harmonics coefficients exactly as evaluated by tcnn's
# sh_enc (hard-coded polynomial expansion, degrees 1..4 cover all shipped
# configs: configs/nerf/base.json uses degree 4).
def _sh_basis(degree: int, d: jax.Array) -> jax.Array:
    return _sh_basis_components(degree, d[..., 0], d[..., 1], d[..., 2])


def _sh_basis_components(degree: int, x, y, z) -> jax.Array:
    x2, y2, z2 = x * x, y * y, z * z
    out = [jnp.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        out += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if degree >= 3:
        xy, yz, xz = x * y, y * z, x * z
        out += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * z2 - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * x2 - 0.54627421529603959 * y2,
        ]
    if degree >= 4:
        out += [
            0.59004358992664352 * y * (-3.0 * x2 + y2),
            2.8906114426405538 * x * y * z,
            0.45704579946446572 * y * (1.0 - 5.0 * z2),
            0.3731763325901154 * z * (5.0 * z2 - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * z2),
            1.4453057213202769 * z * (x2 - y2),
            0.59004358992664352 * x * (-x2 + 3.0 * y2),
        ]
    if degree >= 5:
        out += [
            2.5033429417967046 * x * y * (x2 - y2),
            -1.7701307697799304 * y * z * (-3.0 * x2 + y2),
            0.94617469575756008 * x * y * (7.0 * z2 - 1.0),
            -0.66904654355728921 * y * z * (7.0 * z2 - 3.0),
            0.10578554691520431 * (35.0 * z2 * z2 - 30.0 * z2 + 3.0),
            -0.66904654355728921 * x * z * (7.0 * z2 - 3.0),
            0.47308734787878004 * (x2 - y2) * (7.0 * z2 - 1.0),
            -1.7701307697799304 * x * z * (x2 - 3.0 * y2),
            0.62583573544917614 * (x2 * (x2 - 3.0 * y2) - y2 * (3.0 * x2 - y2)),
        ]
    if degree >= 6:
        raise NotImplementedError("SH degree > 5 not implemented")
    return jnp.stack(out, axis=-1)


@dataclasses.dataclass
class SphericalHarmonicsEncoding(Encoding):
    """tcnn SphericalHarmonics: input is a direction warped to [0,1]^3
    (dir/2 + 0.5, cf. nerf_device.cuh warp_direction); unwarps internally."""

    n_dims: int = 3
    degree: int = 4

    def __post_init__(self):
        assert self.n_dims == 3
        self.n_output_dims = self.degree * self.degree

    def apply(self, params, x, **kwargs):
        d = x * 2.0 - 1.0
        return _sh_basis(self.degree, d)

    def apply_components(self, params, comps, **kwargs):
        """Component-separated variant (avoids (N, 3) buffers)."""
        x, y, z = (c * 2.0 - 1.0 for c in comps[:3])
        return _sh_basis_components(self.degree, x, y, z)


def _quartic_cdf(x: jax.Array, inv_radius: float) -> jax.Array:
    """CDF of tcnn's quartic kernel with support [-radius, radius]."""
    u = jnp.clip(x * inv_radius, -1.0, 1.0)
    # kernel k(u) = 15/16 (1-u^2)^2 on [-1,1]; cdf = 1/2 + 15/16(u - 2u^3/3 + u^5/5)
    return 0.5 + 0.9375 * (u - (2.0 / 3.0) * u ** 3 + 0.2 * u ** 5)


@dataclasses.dataclass
class OneBlobEncoding(Encoding):
    """tcnn OneBlob (from neural importance sampling): per input dim, the
    mass of a quartic kernel centered at x falling in each of n_bins bins."""

    n_dims: int
    n_bins: int = 16

    def __post_init__(self):
        self.n_output_dims = self.n_dims * self.n_bins

    def apply(self, params, x, **kwargs):
        edges = jnp.arange(self.n_bins + 1, dtype=x.dtype) / self.n_bins
        inv_radius = 0.5 * self.n_bins  # kernel radius = 2 bin widths
        cdf = _quartic_cdf(edges - x[..., :, None], inv_radius)
        feats = cdf[..., 1:] - cdf[..., :-1]
        return feats.reshape(*x.shape[:-1], self.n_output_dims)


@dataclasses.dataclass
class TriangleWaveEncoding(Encoding):
    """tcnn TriangleWave: cheap positional encoding via triangle waves at
    doubling frequencies (used by FullyFusedMLP-era NRC configs)."""

    n_dims: int
    n_frequencies: int = 12

    def __post_init__(self):
        self.n_output_dims = self.n_dims * self.n_frequencies

    def apply(self, params, x, **kwargs):
        freqs = 2.0 ** jnp.arange(self.n_frequencies, dtype=x.dtype)
        v = x[..., :, None] * freqs - 0.5
        frac = v - jnp.floor(v)
        tri = jnp.abs(frac * 2.0 - 1.0) * 2.0 - 1.0
        return tri.reshape(*x.shape[:-1], self.n_output_dims)


class CompositeEncoding(Encoding):
    """tcnn Composite: applies nested encodings to consecutive input slices
    (configs/nerf/base.json dir_encoding: SH on 3 dims + Identity on rest)."""

    def __init__(self, n_dims: int, nested: Sequence[Encoding]):
        self.n_dims = n_dims
        self.nested = list(nested)
        self.n_output_dims = sum(e.n_output_dims for e in self.nested)

    @property
    def n_params(self) -> int:
        return sum(e.n_params for e in self.nested)

    def init(self, key):
        keys = jax.random.split(key, max(len(self.nested), 1))
        params = [e.init(k) for e, k in zip(self.nested, keys)]
        return params if any(p is not None for p in params) else None

    def apply(self, params, x, **kwargs):
        if params is None:
            params = [None] * len(self.nested)
        outs, start = [], 0
        for enc, p in zip(self.nested, params):
            outs.append(enc.apply(p, x[..., start:start + enc.n_dims], **kwargs))
            start += enc.n_dims
        return jnp.concatenate(outs, axis=-1)


def create_encoding(n_dims: int, config: Dict[str, Any],
                    dtype=jnp.float32) -> Encoding:
    """Factory mirroring tcnn::create_encoding (reference calls at
    src/testbed.cu:3816-3825; nerf_network.h:82-98)."""
    otype = config.get("otype", "HashGrid")
    if otype in ("HashGrid", "DenseGrid", "TiledGrid", "Grid"):
        from .grid_encoding import GridEncoding

        return GridEncoding.from_config(n_dims, config, dtype=dtype)
    if otype == "Identity":
        return IdentityEncoding(n_dims, scale=config.get("scale", 1.0),
                                offset=config.get("offset", 0.0))
    if otype == "Frequency":
        return FrequencyEncoding(n_dims, config.get("n_frequencies", 12))
    if otype == "SphericalHarmonics":
        return SphericalHarmonicsEncoding(n_dims, config.get("degree", 4))
    if otype == "OneBlob":
        return OneBlobEncoding(n_dims, config.get("n_bins", 16))
    if otype == "TriangleWave":
        return TriangleWaveEncoding(n_dims, config.get("n_frequencies", 12))
    if otype == "Composite":
        nested_cfgs: List[Dict[str, Any]] = config["nested"]
        nested, remaining = [], n_dims
        for sub in nested_cfgs:
            nd = sub.get("n_dims_to_encode", remaining)
            nested.append(create_encoding(nd, sub, dtype=dtype))
            remaining -= nd
        return CompositeEncoding(n_dims, nested)
    raise ValueError(f"unknown encoding otype: {otype}")
