"""WavefrontRenderer (early-out, NerfTracer::trace semantics) must
reproduce render_tile (single-dispatch, capacity-bound) on the same
rays: both composite the identical candidate set with the identical
transmittance math, so any difference beyond float rounding is a bug
in the packing, the round loop, or the alive bookkeeping."""

import sys, os

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
from test_nerf_training import CFG, make_dataset

from instant_ngp_tpu.nerf.testbed_nerf import NerfTestbed


def _trained_testbed():
    tb = NerfTestbed(make_dataset(), CFG, compute_dtype=jnp.float32)
    tb.target_batch_size = 1 << 12
    tb.rays_per_batch = 1 << 10
    tb.n_march = 96
    tb.max_samples_per_ray = 64
    tb.density_samples_override = 1 << 12
    tb.train(64)
    return tb


def test_wavefront_matches_render_tile():
    tb = _trained_testbed()
    cam = np.asarray(tb.data.xforms_start[0])
    kwargs = dict(focal_length=40.0, min_transmittance=1e-4,
                  background_color=(0.1, 0.2, 0.3), tile=256)

    tb.render_wavefront = True
    wf = tb.render_frame(16, 16, cam, **kwargs)
    tb.render_wavefront = False
    tb._render_fns = {}
    ref = tb.render_frame(16, 16, cam, **kwargs)

    assert np.isfinite(wf).all()
    # something was actually rendered (nonzero density along some ray;
    # the toy scene trains slowly so the bar is low — parity is the
    # real assertion)
    assert wf[..., 3].max() > 0.005
    np.testing.assert_allclose(wf, ref, rtol=1e-4, atol=1e-5)


def test_wavefront_depth_and_ao_modes_match():
    tb = _trained_testbed()
    cam = np.asarray(tb.data.xforms_start[1])
    for mode in ("Depth", "AO"):
        tb.render_wavefront = True
        tb._render_fns = {}
        wf = tb.render_frame(8, 8, cam, focal_length=40.0,
                             render_mode=mode, tile=64)
        tb.render_wavefront = False
        tb._render_fns = {}
        ref = tb.render_frame(8, 8, cam, focal_length=40.0,
                              render_mode=mode, tile=64)
        np.testing.assert_allclose(wf, ref, rtol=1e-4, atol=1e-5,
                                   err_msg=f"mode {mode}")


def test_wavefront_early_out_skips_dead_rays():
    """With an opaque scene the wavefront must evaluate fewer samples
    than rays x max_samples_per_ray (the whole point), and rays that
    miss the box must cost zero rounds."""
    from instant_ngp_tpu.nerf.render import RenderConfig, WavefrontRenderer

    tb = _trained_testbed()
    cfg = RenderConfig(
        n_rays=256, n_march=96, max_samples_per_ray=64,
        sample_capacity=256 * 64, cone_angle=0.0, max_mip=0,
        rgb_activation=tb.scene.rgb_activation,
        density_activation=tb.scene.density_activation,
        min_transmittance=1e-2)
    wr = WavefrontRenderer(tb.model, cfg, tb.scene.aabb_min,
                           tb.scene.aabb_max, chunk=16)
    params = tb.inference_params()

    # all rays miss the aabb: zero rounds, zero evaluations
    o = jnp.full((256, 3), 5.0)
    d = jnp.tile(jnp.asarray([[1.0, 0.0, 0.0]]), (256, 1))
    out = wr.render(params, o, d, tb.bitfield, jnp.zeros((256, 3)))
    assert int(out["n_samples"]) == 0
    np.testing.assert_allclose(np.asarray(out["alpha"]), 0.0)


def test_default_render_budget_keeps_every_sample():
    """The default per-ray render cap is the march's own candidate count,
    so a ray that crosses the whole occupied cube keeps all of its
    samples (a fixed cap of 512 used to cut the diagonal's deep tail)."""
    from instant_ngp_tpu.nerf.occupancy import init_bitfield

    tb = NerfTestbed(make_dataset(), CFG)
    tb.n_march = 1024
    wr = tb._get_render_fn(256, "Shade", 1e-4).__self__
    assert wr.cfg.max_samples_per_ray == tb.n_march

    d = jnp.tile(jnp.asarray([[1.0, 1.0, 1.0]]) / np.sqrt(3.0), (4, 1))
    o = jnp.asarray(tb.scene.aabb_min)[None] - 0.05 + 0.01 * jnp.arange(
        4.0)[:, None] * jnp.asarray([[1.0, -1.0, 0.0]])
    full = jnp.full_like(init_bitfield(), 255)
    _, ok, n_cand, valid = wr._prep(o, d, full)
    assert bool(valid.all())
    assert int(n_cand.min()) > 512
    np.testing.assert_array_equal(np.asarray(ok).sum(1), np.asarray(n_cand))


def test_wavefront_budget_smaller_than_chunk():
    """Regression (round-4 crash): a march budget smaller than the depth
    chunk K must render, not crash dynamic_slice — and must still match
    render_tile on the same (budget-truncated) candidate set. Also
    covers a non-chunk-multiple budget, whose clamped tail window used
    to double-composite."""
    from instant_ngp_tpu.nerf.render import RenderConfig, WavefrontRenderer
    from instant_ngp_tpu.nerf.render import render_tile

    tb = _trained_testbed()
    cam = np.asarray(tb.data.xforms_start[0])
    from instant_ngp_tpu.nerf.render import camera_rays_for_frame
    o, d = camera_rays_for_frame(8, 8, (40.0, 40.0), cam[:3])
    params = tb.inference_params()
    bg = jnp.full((64, 3), 0.25)

    for budget in (16, 24):  # < chunk, and non-multiple of chunk
        cfg = RenderConfig(
            n_rays=64, n_march=96, max_samples_per_ray=budget,
            sample_capacity=64 * budget,
            cone_angle=tb.scene.cone_angle_constant,
            max_mip=tb.scene.max_cascade,
            rgb_activation=tb.scene.rgb_activation,
            density_activation=tb.scene.density_activation,
            min_transmittance=1e-4)
        wr = WavefrontRenderer(tb.model, cfg, tb.scene.aabb_min,
                               tb.scene.aabb_max, chunk=32)
        wf = wr.render(params, o, d, tb.bitfield, bg)
        ref = render_tile(tb.model, cfg, params, o, d, tb.bitfield,
                          jnp.asarray(tb.scene.aabb_min),
                          jnp.asarray(tb.scene.aabb_max), bg)
        np.testing.assert_allclose(
            np.asarray(wf["rgb"]), np.asarray(ref["rgb"]),
            rtol=1e-4, atol=1e-5, err_msg=f"budget {budget}")
        np.testing.assert_allclose(
            np.asarray(wf["alpha"]), np.asarray(ref["alpha"]),
            rtol=1e-4, atol=1e-5, err_msg=f"budget {budget}")
