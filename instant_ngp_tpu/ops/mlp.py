"""MLPs and encoding+network composition.

Replaces tcnn's FullyFusedMLP / CutlassMLP (reference `create_network`,
src/testbed.cu:3726-3825; 64-wide fp16 fully-fused kernels). Here the MLP
is a chain of bf16 matmuls with fp32 accumulation (preferred_element_type)
over large batches, which XLA hands to the GPU's GEMM libraries; a fused
kernel is worth writing only once a trace shows the MLPs' share
(SURVEY.md §7).

Like tcnn's fully-fused MLP, these MLPs have NO biases.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .encodings import Encoding


def apply_activation(name: str, x: jax.Array) -> jax.Array:
    """tcnn activation set (reference nerf.h:151-153 uses Exponential/Logistic)."""
    if name in ("None", None, "none"):
        return x
    if name == "ReLU":
        return jnp.maximum(x, 0.0)
    if name == "Logistic":
        return jax.nn.sigmoid(x)
    if name == "Exponential":
        return jnp.exp(x)
    if name == "Sine":
        return jnp.sin(x)
    if name == "Squareplus":
        return 0.5 * (x + jnp.sqrt(x * x + 4.0))
    if name == "Softplus":
        return jax.nn.softplus(x)
    if name == "Tanh":
        return jnp.tanh(x)
    raise ValueError(f"unknown activation: {name}")


def activation_derivative(name: str, x: jax.Array) -> jax.Array:
    """d(activation)/dx evaluated at pre-activation x (for analytic backwards)."""
    if name in ("None", None, "none"):
        return jnp.ones_like(x)
    if name == "ReLU":
        return (x > 0).astype(x.dtype)
    if name == "Logistic":
        s = jax.nn.sigmoid(x)
        return s * (1.0 - s)
    if name == "Exponential":
        return jnp.exp(x)
    if name == "Sine":
        return jnp.cos(x)
    raise ValueError(f"unknown activation derivative: {name}")


@dataclasses.dataclass
class MLP:
    """Bias-free MLP: input -> [n_neurons]*n_hidden_layers -> output.

    n_hidden_layers counts hidden matmuls as tcnn does: 0 means a single
    input->output matrix (configs/nerf/base_0layer.json ablation).
    Compute dtype bf16 (stand-in for tcnn's fp16 `network_precision_t`),
    master params fp32, accumulation fp32. A float32 compute dtype runs
    the matmuls at full float32 precision (no TF32).
    """

    n_input_dims: int
    n_output_dims: int
    n_neurons: int = 64
    n_hidden_layers: int = 1
    activation: str = "ReLU"
    output_activation: str = "None"
    compute_dtype: Any = jnp.bfloat16

    @classmethod
    def from_config(cls, n_input_dims: int, n_output_dims: int,
                    config: Dict[str, Any], **kw) -> "MLP":
        return cls(
            n_input_dims=n_input_dims,
            n_output_dims=n_output_dims,
            n_neurons=config.get("n_neurons", 64),
            n_hidden_layers=config.get("n_hidden_layers", 1),
            activation=config.get("activation", "ReLU"),
            output_activation=config.get("output_activation", "None"),
            **kw,
        )

    @property
    def layer_dims(self) -> List[Any]:
        if self.n_hidden_layers == 0:
            return [(self.n_input_dims, self.n_output_dims)]
        dims = [(self.n_input_dims, self.n_neurons)]
        dims += [(self.n_neurons, self.n_neurons)] * (self.n_hidden_layers - 1)
        dims += [(self.n_neurons, self.n_output_dims)]
        return dims

    @property
    def n_params(self) -> int:
        return sum(i * o for i, o in self.layer_dims)

    def init(self, key: jax.Array) -> List[jax.Array]:
        """Xavier-uniform init (tcnn default for fully-fused networks)."""
        params = []
        for (fan_in, fan_out), k in zip(self.layer_dims,
                                        jax.random.split(key, len(self.layer_dims))):
            bound = float(np.sqrt(6.0 / (fan_in + fan_out)))
            params.append(jax.random.uniform(k, (fan_in, fan_out), jnp.float32,
                                             -bound, bound))
        return params

    def apply(self, params: Sequence[jax.Array], x: jax.Array) -> jax.Array:
        """x (..., n_input_dims) -> (..., n_output_dims), fp32 out."""
        h = x.astype(self.compute_dtype)
        n_layers = len(params)
        precision = (jax.lax.Precision.HIGHEST
                     if jnp.dtype(self.compute_dtype) == jnp.float32
                     else None)
        for i, w in enumerate(params):
            h = jnp.dot(h, w.astype(self.compute_dtype), precision=precision,
                        preferred_element_type=jnp.float32)
            if i + 1 < n_layers:
                h = apply_activation(self.activation, h).astype(self.compute_dtype)
        return apply_activation(self.output_activation, h)


class NetworkWithInputEncoding:
    """encoding |> MLP — tcnn NetworkWithInputEncoding
    (reference src/testbed.cu:3816-3825 for image/sdf/volume modes)."""

    def __init__(self, encoding: Encoding, network: MLP):
        self.encoding = encoding
        self.network = network
        assert network.n_input_dims == encoding.n_output_dims

    @property
    def n_params(self) -> int:
        return self.encoding.n_params + self.network.n_params

    def init(self, key: jax.Array) -> Dict[str, Any]:
        k_enc, k_net = jax.random.split(key)
        return {"encoding": self.encoding.init(k_enc),
                "net": self.network.init(k_net)}

    def apply(self, params: Dict[str, Any], x: jax.Array,
              max_level: Optional[jax.Array] = None,
              encode_rng: Optional[jax.Array] = None) -> jax.Array:
        """encode_rng: training-only stochastic-corner grid sampling
        (unbiased, 2^d fewer table gathers and scatter-adds — see
        GridEncoding). Ignored by encodings without an rng mode."""
        if encode_rng is not None and hasattr(self.encoding, "pack_params"):
            feats = self.encoding.apply(params["encoding"], x,
                                        max_level=max_level, rng=encode_rng)
        else:
            feats = self.encoding.apply(params["encoding"], x,
                                        max_level=max_level)
        return self.network.apply(params["net"], feats)
