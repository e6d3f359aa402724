import jax
import jax.numpy as jnp
import numpy as np
import pytest

from instant_ngp_tpu.common import LossType
from instant_ngp_tpu.ops.losses import create_loss, loss_and_gradient
from instant_ngp_tpu.ops.mlp import MLP, NetworkWithInputEncoding, apply_activation
from instant_ngp_tpu.ops.encodings import create_encoding
from instant_ngp_tpu.ops.optimizers import create_optimizer


def test_mlp_shapes_and_layers():
    mlp = MLP(n_input_dims=32, n_output_dims=4, n_neurons=64, n_hidden_layers=2)
    assert [w for w in mlp.layer_dims] == [(32, 64), (64, 64), (64, 4)]
    params = mlp.init(jax.random.PRNGKey(0))
    out = mlp.apply(params, jnp.ones((8, 32)))
    assert out.shape == (8, 4) and out.dtype == jnp.float32


def test_mlp_zero_hidden_layers():
    mlp = MLP(n_input_dims=8, n_output_dims=3, n_hidden_layers=0)
    params = mlp.init(jax.random.PRNGKey(0))
    assert len(params) == 1 and params[0].shape == (8, 3)
    out = mlp.apply(params, jnp.ones((4, 8)))
    # single linear layer: exact matmul (fp32 vs bf16 tolerance)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(jnp.ones((4, 8)) @ params[0]),
                               rtol=2e-2, atol=1e-3)


def test_network_with_input_encoding():
    enc = create_encoding(2, {"otype": "HashGrid", "n_levels": 4,
                              "n_features_per_level": 2,
                              "log2_hashmap_size": 10, "base_resolution": 4})
    mlp = MLP(n_input_dims=enc.n_output_dims, n_output_dims=3, n_hidden_layers=2)
    model = NetworkWithInputEncoding(enc, mlp)
    params = model.init(jax.random.PRNGKey(0))
    out = model.apply(params, jax.random.uniform(jax.random.PRNGKey(1), (16, 2)))
    assert out.shape == (16, 3)
    # gradient flows into both encoding and net
    g = jax.grad(lambda p: jnp.sum(model.apply(p, jnp.full((4, 2), 0.3)) ** 2))(params)
    assert float(jnp.abs(g["encoding"]).sum()) > 0
    assert all(float(jnp.abs(w).sum()) > 0 for w in g["net"])


# MAPE/SMAPE/RelativeL2 reference gradients deliberately treat the
# prediction-dependent denominator as constant (nerf_device.cuh:82-145),
# so only the remaining losses are true derivatives of their loss values.
_TRUE_DERIVATIVE_LOSSES = [LossType.L2, LossType.L1, LossType.Huber, LossType.LogL1]


@pytest.mark.parametrize("lt", _TRUE_DERIVATIVE_LOSSES)
def test_loss_gradients_match_autodiff(lt):
    target = jnp.array([0.2, 0.5, 0.9])
    pred = jnp.array([0.3, 0.4, 0.95])
    loss, grad = loss_and_gradient(lt, target, pred)
    auto = jax.grad(lambda p: jnp.sum(loss_and_gradient(lt, target, p)[0]))(pred)
    np.testing.assert_allclose(np.asarray(grad), np.asarray(auto), rtol=1e-5)


def test_relative_losses_constant_denominator():
    """The reference formulas: grad = d(loss)/d(pred) with denom frozen."""
    t = jnp.array([0.5]); p = jnp.array([0.8])
    loss, grad = loss_and_gradient(LossType.RelativeL2, t, p)
    np.testing.assert_allclose(np.asarray(grad), 2 * 0.3 / (0.64 + 1e-2), rtol=1e-6)
    loss, grad = loss_and_gradient(LossType.Mape, t, p)
    np.testing.assert_allclose(np.asarray(grad), 1.0 / (0.8 + 1e-2), rtol=1e-6)
    loss, grad = loss_and_gradient(LossType.Smape, t, p)
    np.testing.assert_allclose(np.asarray(grad), 1.0 / (0.5 * 1.3 + 1e-2), rtol=1e-6)


def test_huber_reference_normalization():
    """Huber(0.1)/5 matches L2 near zero (reference nerf_device.cuh:606-611)."""
    t = jnp.array([0.5]); p = jnp.array([0.51])
    h, _ = loss_and_gradient(LossType.Huber, t, p)
    l2, _ = loss_and_gradient(LossType.L2, t, p)
    np.testing.assert_allclose(np.asarray(h), np.asarray(l2), rtol=1e-5)


def test_create_loss_mean():
    loss_fn = create_loss({"otype": "L2"})
    assert float(loss_fn(jnp.array([1.0, 2.0]), jnp.array([0.0, 0.0]))) == 2.5


def test_adam_single_step_formula():
    opt = create_optimizer({"otype": "Adam", "learning_rate": 1e-2,
                            "beta1": 0.9, "beta2": 0.99, "epsilon": 1e-15})
    params = {"w": jnp.array([1.0, 2.0])}
    grads = {"w": jnp.array([0.1, -0.2])}
    state = opt.init(params)
    new_params, state = opt.step(state, params, grads)
    # bias-corrected adam first step: update = lr * g/|g| = lr * sign(g)
    np.testing.assert_allclose(np.asarray(new_params["w"]),
                               [1.0 - 1e-2, 2.0 + 1e-2], rtol=1e-6)
    assert int(state["step"]) == 1


def test_exponential_decay_schedule():
    opt = create_optimizer({
        "otype": "ExponentialDecay", "decay_start": 100, "decay_interval": 50,
        "decay_base": 0.5,
        "nested": {"otype": "Adam", "learning_rate": 1.0}})
    assert float(opt.learning_rate(0)) == 1.0
    assert float(opt.learning_rate(99)) == 1.0
    assert float(opt.learning_rate(100)) == 0.5
    assert float(opt.learning_rate(149)) == 0.5
    assert float(opt.learning_rate(150)) == 0.25


def test_ema_wrapper_inference_params():
    cfg = {"otype": "Ema", "decay": 0.5,
           "nested": {"otype": "Adam", "learning_rate": 0.0}}
    opt = create_optimizer(cfg)
    params = {"w": jnp.array([1.0])}
    state = opt.init(params)
    # lr 0 -> params never change; ema stays at params
    new_params, state = opt.step(state, params, {"w": jnp.array([1.0])})
    np.testing.assert_allclose(np.asarray(opt.inference_params(state, new_params)["w"]), [1.0])
    # now jump params manually and check ema lags
    state2 = dict(state, ema={"w": jnp.array([0.0])})
    jumped = {"w": jnp.array([2.0])}
    _, state3 = opt.step(state2, jumped, {"w": jnp.array([0.0])})
    np.testing.assert_allclose(np.asarray(state3["ema"]["w"]), [1.0])  # 0.5*0 + 0.5*2


def test_l2_reg_mask():
    opt = create_optimizer({"otype": "Adam", "learning_rate": 1e-2,
                            "l2_reg": 1.0})
    params = {"net": jnp.array([1.0]), "enc": jnp.array([1.0])}
    zero_g = {"net": jnp.array([0.0]), "enc": jnp.array([0.0])}
    mask = {"net": True, "enc": False}
    state = opt.init(params)
    new_params, _ = opt.step(state, params, zero_g, l2_mask=mask)
    assert float(new_params["net"][0]) < 1.0      # decayed
    assert float(new_params["enc"][0]) == 1.0     # untouched


def test_nested_reference_config_parses():
    """The shipped NeRF config carries the reference's optimizer block:
    Ema(0.95) over ExponentialDecay(0.33 from step 20000) over Adam."""
    from instant_ngp_tpu.config import (find_network_config,
                                        load_network_config)
    cfg = load_network_config(find_network_config("base.json",
                                                  mode="nerf"))
    opt = create_optimizer(cfg["optimizer"])
    assert opt.base_learning_rate == 1e-2
    assert opt._ema is not None and opt._decay is not None
    assert float(opt.learning_rate(20000)) == pytest.approx(1e-2 * 0.33)


def test_update_hyperparams():
    opt = create_optimizer({"otype": "Ema", "decay": 0.95, "nested": {
        "otype": "Adam", "learning_rate": 1e-2}})
    opt.update_hyperparams({"nested": {"learning_rate": 5e-3}})
    assert opt.base_learning_rate == 5e-3
