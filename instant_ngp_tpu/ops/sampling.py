"""Low-discrepancy and pseudo-random sample generation, vectorized.

Covers the QMC sampler family the reference exposes as ERandomMode
{Random, Halton, Sobol, Stratified} (src/testbed_image.cu:39-74, selected
in train_image :225-244) and the per-spp pixel jitter
(ld_random_pixel_offset, random_val.cuh:313-322).

The Sobol path is Burley's hash-shuffled, Owen-scrambled Sobol sequence
[Burley 2019, JCGT 9(4)] — the same published algorithm the reference's
random_val.cuh:160-291 uses — re-expressed as branch-free vectorized jnp
over uint32 lanes (32 XOR-select steps, no data-dependent
control flow). Direction-number tables are the published constants from
that paper (dims 0-4).

Pseudo-random generation uses stateless `jax.random` (threefry) rather
than pcg32: this design never replays an RNG stream (SURVEY.md §7
"RNG parity"), so counter-based keys are strictly better here.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Sobol direction numbers, dims 0-4 (Burley 2019, Listing 3; public domain).
_SOBOL_DIRECTIONS = np.array([
    [0x80000000, 0x40000000, 0x20000000, 0x10000000,
     0x08000000, 0x04000000, 0x02000000, 0x01000000,
     0x00800000, 0x00400000, 0x00200000, 0x00100000,
     0x00080000, 0x00040000, 0x00020000, 0x00010000,
     0x00008000, 0x00004000, 0x00002000, 0x00001000,
     0x00000800, 0x00000400, 0x00000200, 0x00000100,
     0x00000080, 0x00000040, 0x00000020, 0x00000010,
     0x00000008, 0x00000004, 0x00000002, 0x00000001],
    [0x80000000, 0xc0000000, 0xa0000000, 0xf0000000,
     0x88000000, 0xcc000000, 0xaa000000, 0xff000000,
     0x80800000, 0xc0c00000, 0xa0a00000, 0xf0f00000,
     0x88880000, 0xcccc0000, 0xaaaa0000, 0xffff0000,
     0x80008000, 0xc000c000, 0xa000a000, 0xf000f000,
     0x88008800, 0xcc00cc00, 0xaa00aa00, 0xff00ff00,
     0x80808080, 0xc0c0c0c0, 0xa0a0a0a0, 0xf0f0f0f0,
     0x88888888, 0xcccccccc, 0xaaaaaaaa, 0xffffffff],
    [0x80000000, 0xc0000000, 0x60000000, 0x90000000,
     0xe8000000, 0x5c000000, 0x8e000000, 0xc5000000,
     0x68800000, 0x9cc00000, 0xee600000, 0x55900000,
     0x80680000, 0xc09c0000, 0x60ee0000, 0x90550000,
     0xe8808000, 0x5cc0c000, 0x8e606000, 0xc5909000,
     0x6868e800, 0x9c9c5c00, 0xeeee8e00, 0x5555c500,
     0x8000e880, 0xc0005cc0, 0x60008e60, 0x9000c590,
     0xe8006868, 0x5c009c9c, 0x8e00eeee, 0xc5005555],
    [0x80000000, 0xc0000000, 0x20000000, 0x50000000,
     0xf8000000, 0x74000000, 0xa2000000, 0x93000000,
     0xd8800000, 0x25400000, 0x59e00000, 0xe6d00000,
     0x78080000, 0xb40c0000, 0x82020000, 0xc3050000,
     0x208f8000, 0x51474000, 0xfbea2000, 0x75d93000,
     0xa0858800, 0x914e5400, 0xdbe79e00, 0x25db6d00,
     0x58800080, 0xe54000c0, 0x79e00020, 0xb6d00050,
     0x800800f8, 0xc00c0074, 0x200200a2, 0x50050093],
    [0x80000000, 0x40000000, 0x20000000, 0xb0000000,
     0xf8000000, 0xdc000000, 0x7a000000, 0x9d000000,
     0x5a800000, 0x2fc00000, 0xa1600000, 0xf0b00000,
     0xda880000, 0x6fc40000, 0x81620000, 0x40bb0000,
     0x22878000, 0xb3c9c000, 0xfb65a000, 0xddb2d000,
     0x78022800, 0x9c0b3c00, 0x5a0fb600, 0x2d0ddb00,
     0xa2878080, 0xf3c9c040, 0xdb65a020, 0x6db2d0b0,
     0x800228f8, 0x400b3cdc, 0x200fb67a, 0xb00ddb9d],
], dtype=np.uint32)

_U32_TO_UNIT = np.float32(1.0 / (1 << 32))


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def sobol(index: jax.Array, dim: int) -> jax.Array:
    """Raw Sobol sample (uint32) for each index; vectorized over index."""
    idx = _u32(index)
    x = jnp.zeros_like(idx)
    dirs = _SOBOL_DIRECTIONS[dim]
    for bit in range(32):
        mask = (idx >> np.uint32(bit)) & np.uint32(1)
        x = x ^ (mask * np.uint32(dirs[bit]))
    return x


def _reverse_bits(x: jax.Array) -> jax.Array:
    x = ((x & np.uint32(0xAAAAAAAA)) >> 1) | ((x & np.uint32(0x55555555)) << 1)
    x = ((x & np.uint32(0xCCCCCCCC)) >> 2) | ((x & np.uint32(0x33333333)) << 2)
    x = ((x & np.uint32(0xF0F0F0F0)) >> 4) | ((x & np.uint32(0x0F0F0F0F)) << 4)
    x = ((x & np.uint32(0xFF00FF00)) >> 8) | ((x & np.uint32(0x00FF00FF)) << 8)
    return (x >> 16) | (x << 16)


def _laine_karras_permutation(x: jax.Array, seed) -> jax.Array:
    x = x + _u32(seed)
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x = x ^ (x * np.uint32(c))
    return x


def _nested_uniform_scramble(x: jax.Array, seed) -> jax.Array:
    return _reverse_bits(_laine_karras_permutation(_reverse_bits(x), seed))


def _hash_combine(seed: int, v: int) -> np.uint32:
    seed = np.uint32(seed)
    v = np.uint32(v)
    return np.uint32(seed ^ (v + np.uint32((int(seed) << 6) & 0xFFFFFFFF)
                             + np.uint32(int(seed) >> 2)))


def ld_samples(index: jax.Array, seed: int, n_dims: int = 2) -> jax.Array:
    """Shuffled, Owen-scrambled Sobol points in [0,1)^n_dims.

    index: (N,) int array of global sample indices. Returns (N, n_dims)
    float32. Equivalent of the reference's ld_random_val_{2,4}d."""
    shuffled = _nested_uniform_scramble(_u32(index), np.uint32(seed))
    dims = []
    for d in range(n_dims):
        x = sobol(shuffled, d)
        x = _nested_uniform_scramble(x, _hash_combine(seed, d))
        dims.append(x.astype(jnp.float32) * _U32_TO_UNIT)
    return jnp.stack(dims, axis=-1)


def halton(index: jax.Array, base: int, n_digits: int = 0) -> jax.Array:
    """Radical inverse of index in the given base, vectorized.

    n_digits=0 picks enough digits for 2^32 indices automatically."""
    if n_digits == 0:
        n_digits = int(np.ceil(32 / np.log2(base)))
    idx = jnp.asarray(index, jnp.uint32)
    result = jnp.zeros(idx.shape, jnp.float32)
    f = jnp.float32(1.0)
    for _ in range(n_digits):
        f = f / base
        result = result + f * (idx % base).astype(jnp.float32)
        idx = idx // base
    return result


def halton23(index: jax.Array) -> jax.Array:
    """(N,) indices -> (N, 2) Halton base-2/3 points (halton23_kernel)."""
    return jnp.stack([halton(index, 2), halton(index, 3)], axis=-1)


def stratify2(samples: jax.Array, log2_batch_size: int) -> jax.Array:
    """Stratify (N, 2) uniform samples over a sqrt(B) x sqrt(B) grid.

    Matches stratify2_kernel (src/testbed_image.cu:61-76): batch position i
    maps to cell (i mod s, i div s) with s = 2^(log2_batch_size/2); only
    valid for even log2 batch sizes."""
    log2_size = log2_batch_size // 2
    size = 1 << log2_size
    n = samples.shape[0]
    i = jnp.arange(n, dtype=jnp.uint32) & np.uint32((1 << log2_batch_size) - 1)
    cx = (i & np.uint32(size - 1)).astype(jnp.float32)
    cy = (i >> np.uint32(log2_size)).astype(jnp.float32)
    inv = jnp.float32(1.0 / size)
    return jnp.stack([samples[:, 0] * inv + cx * inv,
                      samples[:, 1] * inv + cy * inv], axis=-1)


def generate_2d_samples(mode: str, n: int, step: int, seed: int,
                        key: jax.Array = None) -> jax.Array:
    """Dispatch matching ERandomMode (train_image, testbed_image.cu:225-244).

    mode: Random | Halton | Sobol | Stratified. `step` advances the global
    QMC index by n per training step, as the reference does with
    base_idx = batch_size * training_step."""
    if mode == "Halton":
        return halton23(jnp.arange(n, dtype=jnp.uint32) + np.uint32(n * step))
    if mode == "Sobol":
        return ld_samples(jnp.arange(n, dtype=jnp.uint32) + np.uint32(n * step),
                          seed, 2)
    if key is None:
        key = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    samples = jax.random.uniform(key, (n, 2), jnp.float32)
    if mode == "Stratified":
        log2 = int(np.log2(n))
        if (1 << log2) == n and log2 % 2 == 0:
            samples = stratify2(samples, log2)
        # non-pot / non-square batches silently fall back to Random,
        # matching the reference's warning-and-skip behavior
    return samples


def ld_pixel_offset(spp: int, seed: int = 0xDEADBEEF) -> jax.Array:
    """Per-spp subpixel jitter (random_val.cuh:313-322): 0.5 - ld(0) + ld(spp)."""
    base = ld_samples(jnp.array([0, spp], dtype=jnp.uint32), seed, 2)
    return 0.5 - base[0] + base[1]
