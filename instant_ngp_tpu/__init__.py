"""instant_ngp_tpu — neural graphics primitives in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
fnysalehi/instant-ngp-rendering (a fork of NVIDIA instant-ngp adding a
multi-object "Geometry" scene mode). The compute path is JAX; host-side
irregular work (BVH queries, image decode) is C++ behind ctypes with numpy
fallbacks.

Layer map (cf. SURVEY.md §1):
  ops/       — encodings (hash grid, SH, frequency, ...), MLPs, losses,
               nested optimizers, trainer            (reference L0/L1: tiny-cuda-nn)
  nerf/      — occupancy grid, sampler, composite loss, wavefront renderer
               (reference L5: src/testbed_nerf.cu)
  image/     — 2D image fitting                      (src/testbed_image.cu)
  sdf/       — SDF fitting + sphere tracing          (src/testbed_sdf.cu)
  volume/    — volumetric path-traced fitting        (src/testbed_volume.cu)
  geometry/  — multi-object BVH scene mode (fork)    (src/testbed_geometry.cu)
  geom/      — triangle/Geometry BVH, octree, marching cubes (reference L2)
  data/      — dataset loaders, EXR/PNG/bin IO, snapshots,
               procedural scenes                     (reference L3)
  parallel/  — mesh/sharding helpers, multi-chip training    (reference §2.6)
  testbed.py — pyngp-compatible facade               (src/python_api.cu)
"""

import os as _os

import jax as _jax

__version__ = "0.1.0"


def compile_cache_dir():
    """Where this package keeps JAX's persistent compilation cache, or None
    when JAX_COMPILATION_CACHE_DIR is set (JAX then uses that directory
    itself). The default is fixed per checkout: `<checkout>/.jax_cache`."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return _os.path.join(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__))), ".jax_cache")


# Persistent compilation cache: the big jitted programs (the NeRF train
# step) are reused across processes.
_cache_dir = compile_cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
