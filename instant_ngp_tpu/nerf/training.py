"""NeRF training step: volumetric composite loss + gradient, fully jitted.

Re-implements compute_loss_kernel_train_nerf (src/testbed_nerf.cu:841-1160)
and the train_nerf_step orchestration (:2683-2930) with static shapes:

- The reference runs inference over uncompacted samples, derives
  dL/d(mlp_out) ANALYTICALLY in a kernel, then calls the trainer with a
  custom gradient. Here the composite is expressed as a differentiable
  masked computation over the (R, M) march CANDIDATE grid and autodiff
  produces exactly that analytic gradient (chain rule through
  alpha = 1-exp(-sigma dt) and the transmittance prefix products), with
  the same early-termination (T < 1e-4) masking — samples past the
  cutoff get zero gradient, mirroring compaction. The network's flat
  outputs route onto the candidate grid with one element scatter per
  channel; mask/dt/t are march outputs already living there, so no
  padded (R, K) relayout (or its gather/scatter transposes) exists.
- `axis_name` turns the same function into the data-parallel step: the
  gradient pmean (and stat/error-map psums) are the only collectives
  (SURVEY.md §2.6) — nerf/parallel.py wraps THIS function in shard_map,
  no forked step logic.
- Reference regularizer semantics are reproduced as loss terms whose
  gradients equal the hand-added ones: output_l2_reg on exponential RGB
  outputs, L1 density reg when mean density is low, near-plane density
  penalty (:1058-1115).
- Loss normalization matches: per-ray channel-mean loss averaged over the
  ray-batch lane count.
- Background composite: random background color (sRGB-warped), applied
  only to rays that composited ALL their samples (:997-1003).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import NERF_MIN_OPTICAL_THICKNESS
from ..ops.losses import loss_and_gradient, LossType
from .dataset import NerfTrainingData
from .model import (NerfNetwork, network_to_density, network_to_rgb)
from .sampler import (RayBatch, SampleBatch, compact_samples, generate_rays,
                      march_rays)

EPSILON = 1e-4  # training transmittance cutoff (testbed_nerf.cu:905)


def _linear_to_srgb(x):
    return jnp.where(x <= 0.0031308, 12.92 * x,
                     1.055 * jnp.maximum(x, 1e-12) ** (1.0 / 2.4) - 0.055)


def _srgb_to_linear(x):
    return jnp.where(x <= 0.04045, x / 12.92,
                     ((jnp.maximum(x, 0.0) + 0.055) / 1.055) ** 2.4)


class CompositeResult(NamedTuple):
    loss_for_grad: jax.Array      # scalar; autodiff target
    per_ray_loss: jax.Array       # (R,) reported loss per lane
    measured_compacted: jax.Array  # () samples surviving T-cutoff
    rgb_rays: Any                 # 3 x (R,) composited color channels
    depth_rays: jax.Array         # (R,)


def composite_loss(raw_channels, samples: SampleBatch,
                   ts: jax.Array, dts: jax.Array,
                   rays: RayBatch, bg_color: jax.Array,
                   exposure: jax.Array,
                   rgb_activation: str, density_activation: str,
                   loss_type: LossType, mean_density: jax.Array,
                   near_distance: float,
                   train_in_linear_colors: bool = False,
                   depth_target: Optional[jax.Array] = None,
                   depth_supervision_lambda: float = 0.0,
                   depth_loss_type: LossType = LossType.L1,
                   disable_regularizers: bool = False,
                   ) -> CompositeResult:
    """Composite directly in the (R, M) CANDIDATE domain.

    raw_channels: 4 pre-activation FLAT (S,) arrays (r, g, b, sigma) —
    the network's outputs on the compacted sample batch. They are routed
    back onto the candidate grid with ONE element scatter per channel
    (S elements each); the mask, dt and t already live there as march
    outputs, so the six (R, K) pad-gathers of the padded-layout design
    (and their scatter transposes in the backward) disappear.

    ts/dts: (R, M) march candidate times / RAW step sizes.
    bg_color: (R, 3) LINEAR-space random/fixed background (reference
    applies srgb_to_linear to the random color; caller does that).
    exposure: (R, 3) log2-exposure of each ray's source image."""
    raw_flat = raw_channels
    R, M = samples.cand_slot.shape
    S = raw_flat[0].shape[0]
    n_lanes = R
    kept = samples.cand_slot < S                                # (R, M)

    def to_cand(v):
        plane = jnp.zeros(R * M + 1, v.dtype).at[samples.cand_src].set(
            v, mode="drop")
        return plane[:R * M].reshape(R, M)

    raw_r, raw_g, raw_b, raw_sigma = [to_cand(c) for c in raw_flat]
    mask = kept
    t_padded = ts

    rgb_ch = [network_to_rgb(c, rgb_activation)
              for c in (raw_r, raw_g, raw_b)]                   # 3x (R,M)
    sigma = network_to_density(raw_sigma, density_activation)
    dt = dts
    alpha = jnp.where(mask, 1.0 - jnp.exp(-sigma * dt), 0.0)

    # transmittance BEFORE each sample: exclusive prefix product
    one_minus = 1.0 - alpha
    t_prefix = jnp.cumprod(one_minus, axis=-1)
    T_before = jnp.concatenate(
        [jnp.ones((n_lanes, 1), alpha.dtype), t_prefix[:, :-1]], axis=-1)

    # training early-out: stop compositing once T < EPSILON — those
    # samples are dropped from loss AND gradient (compaction semantics)
    alive = mask & (T_before >= EPSILON)
    weight = jnp.where(alive, alpha * T_before, 0.0)

    ray_ch = [jnp.sum(weight * c, axis=1) for c in rgb_ch]      # 3x (R,)
    depth_ray = jnp.sum(weight * t_padded, axis=1)
    T_final = 1.0 - jnp.sum(weight, axis=1)                     # residual

    # background + target color (compute_loss_kernel :957-996). In sRGB
    # mode (default) the network's composited color lives in sRGB space,
    # so the background must be sRGB-warped before compositing.
    exp_ch = [jnp.exp2(exposure[:, k]) for k in range(3)]
    tex_ch = [rays.rgba[:, k] for k in range(3)]                # premult
    a = rays.rgba[:, 3]
    bg_ch = [bg_color[:, k] for k in range(3)]
    if train_in_linear_colors:
        bg_net = bg_ch
        target_ch = [e * t + (1.0 - a) * b
                     for e, t, b in zip(exp_ch, tex_ch, bg_ch)]
    else:
        bg_net = [_linear_to_srgb(b) for b in bg_ch]
        safe_a = jnp.maximum(a, 1e-8)
        target_ch = [
            jnp.where(a > 0,
                      _linear_to_srgb(e * jnp.where(a > 0, t / safe_a, 0.0))
                      * a + (1.0 - a) * bn, bn)
            for e, t, bn in zip(exp_ch, tex_ch, bg_net)]

    # a ray is "finished" if no sample was cut by the epsilon early-out;
    # only finished rays composite the background (:997-1003)
    n_alive = jnp.sum(alive, axis=1)
    n_valid = jnp.sum(mask, axis=1)
    finished = n_alive == n_valid
    bgw = jnp.where(finished, T_final, 0.0)
    ray_ch = [c + bgw * bn for c, bn in zip(ray_ch, bg_net)]

    lane_valid = rays.valid & (n_valid > 0)
    loss_sum = 0.0
    for tgt, pred in zip(target_ch, ray_ch):
        l, _ = loss_and_gradient(loss_type, tgt, pred)
        loss_sum = loss_sum + l
    per_ray_loss = jnp.where(lane_valid, loss_sum / 3.0, 0.0)
    loss_main = jnp.sum(per_ray_loss) / n_lanes

    # depth supervision (:1013-1015, gradient at :1106)
    loss_depth = 0.0
    if depth_supervision_lambda > 0.0 and depth_target is not None:
        target_depth = depth_target
        d_elem, _ = loss_and_gradient(depth_loss_type,
                                      target_depth, depth_ray)
        has_depth = lane_valid & (target_depth > 0)
        loss_depth = depth_supervision_lambda * jnp.sum(
            jnp.where(has_depth, d_elem, 0.0)) / n_lanes

    # ---- regularizers with reference-equal gradients (:1058-1115) ----
    reg = 0.0
    if disable_regularizers:
        return CompositeResult(loss_main + loss_depth, per_ray_loss,
                               jnp.sum(n_alive), ray_ch, depth_ray)
    if rgb_activation == "Exponential":
        # grad += max(0, 1e-4 * out): loss term 0.5e-4 * relu(out)^2
        for c in (raw_r, raw_g, raw_b):
            reg = reg + 1e-4 * 0.5 * jnp.sum(
                jnp.where(alive, jnp.maximum(c, 0.0) ** 2, 0.0)) / n_lanes
    # L1 density reg when the scene is still mostly empty: grad is
    # -1e-4 for raw < 0  →  loss term 1e-4 * relu(-raw)
    l1_on = mean_density < NERF_MIN_OPTICAL_THICKNESS
    reg = reg + jnp.where(l1_on, 1e-4, 0.0) * jnp.sum(
        jnp.where(alive, jnp.maximum(-raw_sigma, 0.0), 0.0)) / n_lanes
    # near-plane density penalty: constant +1e-4 gradient on raw density
    # for samples closer than near_distance (and raw > -10)
    if near_distance > 0.0:
        near_mask = alive & (t_padded < near_distance) & (raw_sigma > -10.0)
        reg = reg + 1e-4 * jnp.sum(jnp.where(near_mask, raw_sigma, 0.0)) \
            / n_lanes

    loss_for_grad = loss_main + loss_depth + reg
    return CompositeResult(loss_for_grad, per_ray_loss,
                           jnp.sum(n_alive), ray_ch, depth_ray)


class NerfTrainStepConfig(NamedTuple):
    """Static (trace-time) knobs of the train step."""

    n_rays: int
    n_march: int
    max_samples_per_ray: int
    sample_capacity: int
    lens_mode: int
    cone_angle: float
    max_mip: int
    rgb_activation: str
    density_activation: str
    loss_type: Any
    near_distance: float
    train_in_linear_colors: bool = False
    random_bg_color: bool = True
    snap_to_pixel_centers: bool = False
    depth_supervision_lambda: float = 0.0
    max_level_rand_training: bool = False
    optimize_camera: bool = False      # extrinsics+focal gradient outputs
    optimize_exposure: bool = False
    optimize_extra_dims: bool = False  # per-image latent gradient outputs
    use_error_map: bool = False        # importance sampling + accumulation
    error_map_res: Any = (0, 0)        # (W_c, H_c) of the error map
    # one sampled grid corner per (sample, level) instead of 2^d — an
    # unbiased estimator that cuts encode gathers and scatter-adds 8x.
    # Auto-disabled when camera or
    # distortion optimization needs dL/d(pos) through the encoding.
    stochastic_corners: bool = False
    # ablation knob (PSNR-decay bisect): drop the output-L2 / density-L1
    # / near-plane regularizer terms from the loss
    disable_regularizers: bool = False


def nerf_train_step(model: NerfNetwork, optimizer, cfg: NerfTrainStepConfig,
                    aabb_min, aabb_max,
                    state: Dict[str, Any], data: NerfTrainingData,
                    bitfield: jax.Array, mean_density: jax.Array,
                    key: jax.Array,
                    cam: Optional[Dict[str, jax.Array]] = None,
                    error_cdfs: Optional[Dict[str, jax.Array]] = None,
                    error_map: Optional[jax.Array] = None,
                    envmap: Optional[jax.Array] = None,
                    distortion: Optional[jax.Array] = None,
                    axis_name: Optional[str] = None,
                    ) -> Tuple[Dict[str, Any], Dict[str, jax.Array]]:
    """One full NeRF training step (pure function; jit with model/optimizer/
    cfg closed over statically).

    cam: optional per-image camera offsets {"pos","rot","focal"}; when
    cfg.optimize_camera, their gradients come back in stats (host Adam
    applies them every n_steps_between_cam_updates, mirroring
    testbed_nerf.cu:2601-2680). Exposure gradients likewise.
    error_map: (n_images, Hc*Wc) running error accumulator; per-ray loss
    deposits bilinearly (compute_loss_kernel :1028-1054)."""
    k_rays, k_bg, k_enc = jax.random.split(key, 3)

    from .sampler import build_rays

    rays, motionblur_time = generate_rays(
        k_rays, data, cfg.n_rays, aabb_min, aabb_max, cfg.cone_angle,
        cfg.lens_mode, cfg.snap_to_pixel_centers, cam=cam,
        error_cdfs=error_cdfs if cfg.use_error_map else None,
        distortion_map=distortion)
    ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                cfg.cone_angle, cfg.max_mip, cfg.n_march,
                                cfg.max_samples_per_ray)
    samples = compact_samples(rays, ts, dts, emits, aabb_min, aabb_max,
                              cfg.sample_capacity,
                              cone_angle=cfg.cone_angle)

    if cfg.random_bg_color:
        bg = jax.random.uniform(k_bg, (cfg.n_rays, 3))
    else:
        bg = jnp.zeros((cfg.n_rays, 3))
    bg = _srgb_to_linear(bg)

    sample_img = rays.img_idx[samples.ray_id] \
        if data.extra_dims is not None else None

    depth_target = None
    if cfg.depth_supervision_lambda > 0 and data.depths is not None:
        res = data.resolutions[rays.img_idx]               # (R, 2) (w, h)
        px = (rays.uv * res).astype(jnp.int32)
        x = jnp.clip(px[..., 0], 0, data.depths.shape[2] - 1)
        y = jnp.clip(px[..., 1], 0, data.depths.shape[1] - 1)
        depth_target = data.depths[rays.img_idx, y, x]

    base_exposure = data.exposures

    # every differentiable auxiliary variable rides in one dict so a
    # single extra argnum covers cam / exposure / envmap / distortion
    aux_vars: Dict[str, Any] = {}
    if cfg.optimize_camera and cam is not None:
        aux_vars["cam"] = cam
    if cfg.optimize_exposure:
        aux_vars["exposure"] = base_exposure
    if cfg.optimize_extra_dims and data.extra_dims is not None:
        # per-image learnable latents (reference trains them with a
        # per-image VarAdam(1e-4) every step, testbed_nerf.cu:2577-2598
        # + compute_extra_dims_gradient_train_nerf :1271; here the
        # gradient rides stats and the host Adam applies it on the same
        # 16-step cadence as the camera variables — the async-dispatch
        # adaptation used for all host-optimized variables)
        aux_vars["extra"] = data.extra_dims
    if envmap is not None:
        aux_vars["envmap"] = envmap
    if distortion is not None:
        aux_vars["distortion"] = distortion

    span = aabb_max - aabb_min

    def loss_fn(params, aux):
        rebuild = ("cam" in aux) or ("distortion" in aux)
        if rebuild:
            # rebuild rays differentiably in the camera offsets and/or
            # distortion map; sample distances t stay fixed (same
            # linearization the reference's analytic backward uses)
            origins, dirs, _ = build_rays(
                data, rays.img_idx, rays.uv, motionblur_time,
                cfg.lens_mode, aux.get("cam"),
                distortion_map=aux.get("distortion"))
            positions = tuple(
                (origins[samples.ray_id, k]
                 + samples.t_mid * dirs[samples.ray_id, k]
                 - aabb_min[k]) / span[k]
                for k in range(3))
            dirs_warped = tuple(
                (dirs[samples.ray_id, k] + 1.0) * 0.5 for k in range(3))
        else:
            positions, dirs_warped = samples.positions, samples.dirs
        extra_flat = None
        if sample_img is not None:
            # per-sample latent: gather via the sample's source image
            extra_flat = aux.get("extra", data.extra_dims)[sample_img]
        enc_rng = k_enc if (cfg.stochastic_corners and not rebuild) else None
        raw = model.apply_components(params, positions, dirs_warped,
                                     extra_flat, encode_rng=enc_rng)
        exposure = aux.get("exposure", base_exposure)[rays.img_idx]

        bg_used = bg
        if "envmap" in aux:
            # composite the envmap behind the random background
            # (compute_loss_kernel :960-966)
            from ..ops.trainable_buffer import read_envmap

            env = read_envmap(aux["envmap"], rays.dirs)
            bg_used = env[..., :3] + bg * (1.0 - env[..., 3:4])
        result = composite_loss(
            tuple(raw), samples, ts, dts, rays, bg_used, exposure,
            cfg.rgb_activation, cfg.density_activation, cfg.loss_type,
            mean_density, cfg.near_distance, cfg.train_in_linear_colors,
            depth_target, cfg.depth_supervision_lambda,
            disable_regularizers=cfg.disable_regularizers)
        return result.loss_for_grad, result

    (loss_val, result), (grads, aux_grads) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(state["params"], aux_vars)

    if axis_name is not None:
        # data-parallel: gradients all-reduce across devices BEFORE the
        # optimizer so parameters stay bit-identical per chip
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.pmean(g, axis_name), grads)
        aux_grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, axis_name), aux_grads)

    from ..ops.trainer import default_l2_mask

    new_params, new_opt = optimizer.step(
        state["opt"], state["params"], grads,
        l2_mask=default_l2_mask(state["params"]))
    new_state = {"params": new_params, "opt": new_opt}

    stats = {
        # reference: loss_output[i] = mean_loss / n_rays, summed on host
        "loss": jnp.sum(result.per_ray_loss) / cfg.n_rays,
        "measured_batch_size": result.measured_compacted,
        "measured_batch_size_before_compaction": samples.n_samples,
        "n_rays": jnp.sum(rays.valid.astype(jnp.int32)),
    }
    if axis_name is not None:
        n_dev = jax.lax.psum(1, axis_name)
        stats = {
            "loss": jax.lax.psum(stats["loss"], axis_name) / n_dev,
            "measured_batch_size": jax.lax.psum(
                stats["measured_batch_size"], axis_name),
            "measured_batch_size_before_compaction": jax.lax.psum(
                stats["measured_batch_size_before_compaction"], axis_name),
            "n_rays": jax.lax.psum(stats["n_rays"], axis_name),
        }
    # one fused (4,) stats vector so the host's 16-step sync is a SINGLE
    # D2H readback instead of four scalar round trips
    stats["fused"] = jnp.stack([
        stats["loss"].astype(jnp.float32),
        stats["measured_batch_size"].astype(jnp.float32),
        stats["measured_batch_size_before_compaction"].astype(jnp.float32),
        stats["n_rays"].astype(jnp.float32)])
    if "cam" in aux_grads:
        stats["cam_gradient"] = aux_grads["cam"]
    if "exposure" in aux_grads:
        stats["exposure_gradient"] = aux_grads["exposure"]
    if "extra" in aux_grads:
        stats["extra_dims_gradient"] = aux_grads["extra"]
    if "envmap" in aux_grads:
        stats["envmap_gradient"] = aux_grads["envmap"]
    if "distortion" in aux_grads:
        stats["distortion_gradient"] = aux_grads["distortion"]

    if cfg.use_error_map and error_map is not None:
        # bilinear deposit of per-ray mean loss into the error map
        cw, ch = cfg.error_map_res
        pos = jnp.clip(rays.uv * jnp.asarray([cw, ch], jnp.float32) - 0.5,
                       0.0, jnp.asarray([cw - 1.001, ch - 1.001]))
        p0 = pos.astype(jnp.int32)
        w = pos - p0
        val = result.per_ray_loss
        flat_img = rays.img_idx * (cw * ch)

        def deposit(acc, dx, dy, weight):
            idx = flat_img + (p0[:, 1] + dy) * cw + (p0[:, 0] + dx)
            return acc.at[idx].add(weight * val)

        delta = jnp.zeros(error_map.size, error_map.dtype)
        delta = deposit(delta, 0, 0, (1 - w[:, 0]) * (1 - w[:, 1]))
        delta = deposit(delta, 1, 0, w[:, 0] * (1 - w[:, 1]))
        delta = deposit(delta, 0, 1, (1 - w[:, 0]) * w[:, 1])
        delta = deposit(delta, 1, 1, w[:, 0] * w[:, 1])
        if axis_name is not None:
            delta = jax.lax.psum(delta, axis_name)
        em = error_map.reshape(-1) + delta
        stats["error_map"] = em.reshape(error_map.shape)

    return new_state, stats
