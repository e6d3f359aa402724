"""Trainer: the tcnn `Trainer<float, T, T>` equivalent.

Reference semantics (SURVEY.md §2.1; calls at src/testbed_nerf.cu:2877,
src/testbed.cu:3846):
- owns fp32 master params (and, via the Ema optimizer wrapper, a smoothed
  copy used for inference/rendering);
- `training_step(inputs, targets)` runs fwd + bwd + optimizer update and
  returns the scalar loss;
- supports a *custom gradient* path where the caller supplies
  dL/d(network output) directly (the NeRF composite loss does this —
  src/testbed_nerf.cu:2808-2877);
- mixed precision with a constant loss scale (testbed.h:386-390). Here we
  compute in bf16 with fp32 accumulation: bf16 shares fp32's exponent range,
  so scaling is mathematically a no-op under autodiff; we keep the
  `loss_scale` knob for fp16-emulation parity tests, applying it inside the
  gradient computation and dividing it back out before the optimizer step
  exactly as the reference does.

The train step is a pure jitted function over a state pytree, so it shards
with jit/shard_map unchanged (SURVEY.md §2.6).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable, Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from ..common import DEFAULT_LOSS_SCALE
from .optimizers import Optimizer


def default_l2_mask(params) -> Any:
    """tcnn applies Adam l2_reg to network matrix weights only, never to
    encoding tables/feature grids. Our param pytrees use the convention
    {"encoding": ..., "net": [...]} (NetworkWithInputEncoding) or plain
    lists of matrices (bare MLP)."""
    if isinstance(params, dict):
        return {k: jax.tree_util.tree_map(
            lambda _, k=k: "encoding" not in k, v)
                if not isinstance(v, dict) else default_l2_mask(v)
                for k, v in params.items()}
    return jax.tree_util.tree_map(lambda _: True, params)


class Trainer:
    """Pairs a model (init/apply/n_params) with an Optimizer and a loss.

    State layout (a pytree; checkpointable as-is):
      {"params": <fp32 master>, "opt": <optimizer state incl. optional ema>}
    """

    def __init__(self, model, optimizer: Optimizer,
                 loss_fn: Optional[Callable] = None, seed: int = 1337,
                 loss_scale: float = 1.0):
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        self.seed = seed
        self.loss_scale = float(loss_scale)
        self._jitted_step = None

    # -- state ----------------------------------------------------------
    def init_state(self, key: Optional[jax.Array] = None) -> Dict[str, Any]:
        if key is None:
            key = jax.random.PRNGKey(self.seed)
        params = self.model.init(key)
        return {"params": params, "opt": self.optimizer.init(params)}

    def n_params(self) -> int:
        return self.model.n_params

    # -- core step (pure function; jit/pjit-able) -----------------------
    def _loss(self, params, inputs, targets, encode_rng=None):
        if encode_rng is not None:
            pred = self.model.apply(params, inputs, encode_rng=encode_rng)
        else:
            pred = self.model.apply(params, inputs)
        return self.loss_fn(pred, targets)

    def train_step(self, state: Dict[str, Any], inputs: jax.Array,
                   targets: jax.Array,
                   encode_rng: Optional[jax.Array] = None
                   ) -> Tuple[Dict[str, Any], jax.Array]:
        """One standard step: fwd, bwd, optimizer update. Pure function.

        encode_rng: opt-in stochastic-corner grid encoding (unbiased,
        2^d fewer table gathers and scatter-adds; see GridEncoding).
        """
        scale = self.loss_scale

        def scaled_loss(p):
            return self._loss(p, inputs, targets, encode_rng) * scale

        loss, grads = jax.value_and_grad(scaled_loss)(state["params"])
        if scale != 1.0:
            grads = jax.tree_util.tree_map(lambda g: g / scale, grads)
            loss = loss / scale
        l2_mask = default_l2_mask(state["params"])
        new_params, new_opt = self.optimizer.step(
            state["opt"], state["params"], grads, l2_mask=l2_mask)
        return {"params": new_params, "opt": new_opt}, loss

    def train_step_custom_gradient(
            self, state: Dict[str, Any], inputs: jax.Array,
            dL_doutput: jax.Array, loss_value: jax.Array,
            apply_fn: Optional[Callable] = None
    ) -> Tuple[Dict[str, Any], jax.Array]:
        """Custom-gradient step: caller supplies dL/d(model output).

        Mirrors the reference NeRF path where compute_loss_kernel produces
        the output gradient analytically and Trainer::training_step only
        back-propagates it (src/testbed_nerf.cu:2808-2877). `dL_doutput`
        must already include any loss scaling the caller wants divided out
        here (we divide by self.loss_scale to match)."""
        apply_fn = apply_fn or self.model.apply

        def forward(p):
            return apply_fn(p, inputs)

        _, vjp = jax.vjp(forward, state["params"])
        (grads,) = vjp(dL_doutput)
        if self.loss_scale != 1.0:
            grads = jax.tree_util.tree_map(
                lambda g: g / self.loss_scale, grads)
        l2_mask = default_l2_mask(state["params"])
        new_params, new_opt = self.optimizer.step(
            state["opt"], state["params"], grads, l2_mask=l2_mask)
        return {"params": new_params, "opt": new_opt}, loss_value

    # -- convenience (stateful, auto-jit) -------------------------------
    def training_step(self, state, inputs, targets, encode_rng=None):
        """Jitted wrapper around train_step (compiled once per shape)."""
        if self._jitted_step is None:
            self._jitted_step = jax.jit(self.train_step)
        return self._jitted_step(state, inputs, targets, encode_rng)

    def inference_params(self, state):
        """Params for rendering: the EMA copy when present (reference uses
        the Ema optimizer's smoothed weights for inference)."""
        return self.optimizer.inference_params(state["opt"], state["params"])
