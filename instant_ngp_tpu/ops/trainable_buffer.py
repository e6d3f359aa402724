"""TrainableBuffer: an N-dim trainable tensor treated as a model.

Re-implements include/neural-graphics-primitives/trainable_buffer.cuh:
the reference wraps raw tensors (4-channel 2D envmap, 2-channel 32x32
lens-distortion map) in the Network interface so a tcnn Trainer can
optimize them (reset_network wiring: envmap src/testbed.cu:3850-3865,
distortion :3781-3792). Here it pairs a plain jnp array with an
Optimizer; gradients arrive from the NeRF loss autodiff.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .optimizers import Optimizer, create_optimizer


class TrainableBuffer:
    def __init__(self, shape: Sequence[int],
                 optimizer_config: Dict[str, Any],
                 init_value: Optional[np.ndarray] = None):
        self.shape = tuple(shape)
        self.optimizer = create_optimizer(optimizer_config)
        params = (jnp.asarray(init_value, jnp.float32)
                  if init_value is not None
                  else jnp.zeros(self.shape, jnp.float32))
        assert params.shape == self.shape
        self.state = {"params": params, "opt": self.optimizer.init(params)}

    @property
    def params(self) -> jax.Array:
        return self.state["params"]

    def inference_params(self) -> jax.Array:
        return self.optimizer.inference_params(self.state["opt"],
                                               self.state["params"])

    def step(self, gradient: jax.Array) -> None:
        # jitted + cached: the Adam update is ~10 small elementwise ops;
        # eager dispatch would pay per-op latency every training step
        if not hasattr(self, "_step_fn"):
            self._step_fn = jax.jit(
                lambda st, g: self.optimizer.step(st["opt"], st["params"],
                                                  g))
        new_params, new_opt = self._step_fn(self.state, gradient)
        self.state = {"params": new_params, "opt": new_opt}


def bilerp_2d(grid: jax.Array, uv: jax.Array) -> jax.Array:
    """Differentiable bilinear sample of (H, W, C) at uv in [0,1]^2
    (Buffer2DView::at_lerp semantics)."""
    h, w = grid.shape[:2]
    pos = uv * jnp.asarray([w, h], jnp.float32) - 0.5
    pos = jnp.clip(pos, 0.0, jnp.asarray([w - 1.001, h - 1.001]))
    p0 = jnp.floor(pos).astype(jnp.int32)
    frac = pos - p0
    x0, y0 = p0[..., 0], p0[..., 1]
    fx, fy = frac[..., 0:1], frac[..., 1:2]
    v00 = grid[y0, x0]
    v10 = grid[y0, jnp.minimum(x0 + 1, w - 1)]
    v01 = grid[jnp.minimum(y0 + 1, h - 1), x0]
    v11 = grid[jnp.minimum(y0 + 1, h - 1), jnp.minimum(x0 + 1, w - 1)]
    return ((1 - fx) * (1 - fy) * v00 + fx * (1 - fy) * v10
            + (1 - fx) * fy * v01 + fx * fy * v11)


def read_envmap(envmap: jax.Array, dirs: jax.Array) -> jax.Array:
    """Lat-long environment map lookup (envmap.cuh read_envmap):
    dirs (..., 3) normalized -> (..., 4) RGBA, differentiable for the
    envmap-training gradient deposit."""
    theta = jnp.arcsin(jnp.clip(dirs[..., 1], -1.0, 1.0))   # elevation
    phi = jnp.arctan2(dirs[..., 0], dirs[..., 2])
    uv = jnp.stack([phi / (2 * jnp.pi) + 0.5,
                    theta / jnp.pi + 0.5], axis=-1)
    return bilerp_2d(envmap, uv)
