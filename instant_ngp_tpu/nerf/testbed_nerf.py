"""NeRF testbed: orchestrates data, model, occupancy grid, training.

The JAX equivalent of the reference's NeRF half of `Testbed`
(train_nerf, testbed_nerf.cu:2448-2681; training_prep_nerf :2933-2946;
load_nerf_post invariants :2151-2239). Host logic here is thin: everything
per-step runs as two jitted programs (density-grid maintenance + train
step), with only the adaptive ray-batch feedback crossing the host
boundary — mirroring NerfCounters::update_after_training (:2422-2446) but
bucketed to powers of two so recompiles stay bounded.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..common import (NERF_GRID_N_CELLS, TestbedMode)
from ..ops.losses import LossType, loss_type_from_string
from ..ops.optimizers import create_optimizer
from .dataset import (NerfSceneConfig, NerfTrainingData, pack_training_data,
                      scene_config_from_dataset)
from .march import MAX_DEPTH
from .model import NerfNetwork
from .occupancy import (cell_positions, density_grid_mean, init_bitfield,
                        init_density_grid, mark_untrained_cells, sample_cells,
                        splat_and_ema, update_bitfield)
from .training import NerfTrainStepConfig, nerf_train_step
from .visibility import compute_visible_cells


class NerfTestbed:
    mode = TestbedMode.Nerf

    def __init__(self, dataset, network_config: Dict[str, Any],
                 seed: int = 1337, compute_dtype=jnp.bfloat16,
                 mesh=None, mesh_axis: str = "data"):
        """mesh: optional jax.sharding.Mesh — when given, the SAME
        training loop runs data-parallel: rays shard over `mesh_axis`,
        params replicate, gradients/stats all-reduce across devices
        (nerf/parallel.py wraps the identical nerf_train_step; host
        cadence — prep every 16, adaptive rays, camera/exposure host
        Adam, error-map CDFs — is shared, not forked)."""
        from ..data.nerf_loader import NerfDataset

        assert isinstance(dataset, NerfDataset)
        self.dataset = dataset
        self.config = network_config
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self._n_shards = int(mesh.shape[mesh_axis]) if mesh is not None \
            else 1
        self.scene: NerfSceneConfig = scene_config_from_dataset(dataset)
        self.data: NerfTrainingData = pack_training_data(dataset)

        self.model = NerfNetwork(
            n_pos_dims=3, n_dir_dims=3,
            n_extra_dims=self.scene.n_extra_dims,
            encoding_config=network_config["encoding"],
            dir_encoding_config=network_config.get(
                "dir_encoding", {"otype": "SphericalHarmonics", "degree": 4}),
            network_config=network_config["network"],
            rgb_network_config=network_config.get(
                "rgb_network", network_config["network"]),
            desired_resolution=2048.0,
            aabb_scale=self.scene.aabb_scale,
            compute_dtype=compute_dtype)

        self.optimizer = create_optimizer(network_config["optimizer"])
        self.loss_type = loss_type_from_string(
            network_config.get("loss", {}).get("otype", "L2"))

        key = jax.random.PRNGKey(seed)
        params = self.model.init(key)
        self.state = {"params": params, "opt": self.optimizer.init(params)}

        n_cascades = self.scene.max_cascade + 1
        self.density_grid = init_density_grid(n_cascades)
        self.bitfield = init_bitfield()
        self.mean_density = jnp.zeros(())
        self.density_grid_ema_step = 0

        self.training_step = 0
        self.seed = seed
        self.loss_scalar = float("nan")

        # adaptive ray batching (nerf.h:35; bucketed powers of two)
        self.target_batch_size = 1 << 18
        self.rays_per_batch = 1 << 12
        self.adapt_ray_batch = True  # off: pin the bucket (no recompiles)
        self.measured_batch_size = 0
        self.measured_batch_size_before_compaction = 0

        # march shape knobs (static per compile). The reference caps
        # samples per ray at NERF_STEPS=1024; unit-cube (cone 0) scenes
        # genuinely need hundreds of samples to cross an object, and a
        # low cap truncates rays mid-scene (-> fog artifacts).
        # n_march is auto-tightened to the scene's true worst-case
        # stepping span (every candidate costs a bitfield gather + a
        # lane in the march/compact/composite planes, so candidate
        # count is ~linear cost).
        self.n_march = self._derive_n_march()
        self.max_samples_per_ray = 1024
        # render-path network-query budget per tile dispatch (reference
        # target_n_queries, testbed_nerf.cu:1697-1698)
        self.render_query_budget = 2 << 20
        # per-ray sample cap at render time (None = min(march cap,
        # n_march), which never binds: a ray emits at most n_march
        # samples). A smaller cap truncates the DEEP tail of a ray's
        # samples and silently sheds far content from renders.
        self.render_max_samples_per_ray: Optional[int] = None
        # early-out wavefront renderer for Shade/Depth/AO (dead rays are
        # never evaluated — NerfTracer::trace semantics); off falls back
        # to the single-dispatch capacity-bound render_tile
        self.render_wavefront = True
        # render with the training-path stochastic-corner (j=1) encode:
        # ~4x fewer table fetches per sample on the eval render;
        # per-spp-pass keys average the estimator noise exactly
        # like subpixel jitter. Off = the reference-exact d-linear path.
        self.render_stochastic_corners = False
        # generation capacity = multiplier * target batch (the reference
        # sizes its uncompacted buffers at 16x target, testbed_nerf.cu:2685,
        # but pads the COMPACTED batch to the target with fill_rollover —
        # the network only ever runs on ~1x target). The network here runs
        # on the full static capacity, so the multiplier is pure waste:
        # keep it small and let the adaptive ray batch hold generation
        # near the target; overflow rays drop like the reference's.
        # Every per-sample cost (encode gather, MLP, scatter) scales with
        # the STATIC capacity, so 1x = the reference's effective network
        # batch (fill_rollover pads the compacted batch to ~1x target).
        self.sample_capacity_multiplier = 1

        # stochastic-corner grid encoding during training: unbiased
        # 1-of-2^d corner sampling, 8x fewer table gathers and
        # scatter-adds. Exact d-linear encode is
        # used automatically whenever camera/distortion optimization
        # needs spatial input gradients, and always at render time.
        self.stochastic_corners = True
        # coarse-to-fine variance schedule: after this step the training
        # encode switches to the exact d-linear path (None = never).
        # With the base config's axis-exact forward + stochastic
        # backward (stochastic_exact_axes=1 + stochastic_bwd, see
        # ops/grid_encoding.py) the cheap estimator already matches
        # exact-encode quality (synthetic scene @3000 steps: 26.91 dB
        # all-stochastic vs 26.45 switching at 1024 — the pure 1-corner
        # j=0 estimator, by contrast, plateaus ~4 dB low), so the
        # default never switches. Set a step for j=0-style configs.
        # Overridable from the config zoo ("stochastic_corners_until"
        # inside the encoding dict) so snapshots preserve the schedule.
        self.stochastic_corners_until: Optional[int] = network_config.get(
            "encoding", {}).get("stochastic_corners_until", None)

        # density-update sample counts; None = reference cadence
        # (all cells for the first 256 steps, then 1/4 + 1/4)
        self.density_samples_override = None
        # adaptation of the warmup cadence: the reference sweeps ALL
        # grid cells every prep for the first 256 steps
        # (training_prep_nerf :2933-2946). Here the number of full-grid
        # sweeps is capped (ROADMAP 2.9); later preps use the steady-state
        # 1/4-uniform + 1/4-occupied sampling, whose max-EMA converges to
        # the same bitfield within a few passes.
        self.warmup_full_grid_preps = 4

        # >1 fuses K (train + density-update) iterations into ONE jitted
        # lax.scan program — one dispatch per block instead of one per
        # step. Camera/
        # exposure/focal optimization runs inside the block (gradients
        # accumulate across the scan; the host Adam applies on the
        # 16-step boundary exactly like the eager path). Envmap/
        # distortion/per-image-latent optimization steps their device
        # Adam every step, which a scan can't replicate — those fall
        # back to eager, as does a sharded mesh.
        self.steps_per_dispatch = 16

        # training color semantics (nerf.h: random_bg_color default true,
        # linear_colors default false; --nerf_compatibility flips bg off)
        self.random_bg_color = True
        self.train_in_linear_colors = False
        # ablation knob (PSNR-decay bisect, scripts/decay_bisect_r5.py):
        # drop the output-L2 / density-L1 / near-plane loss regularizers
        self.disable_regularizers = False

        # camera optimization (nerf.h:88-110 defaults)
        self.optimize_extrinsics = False
        self.optimize_focal_length = False
        self.optimize_exposure = False
        self.extrinsic_learning_rate = 1e-3
        self.extrinsic_l2_reg = 1e-4
        self.intrinsic_l2_reg = 1e-4
        self.exposure_l2_reg = 0.0
        self.n_steps_between_cam_updates = 16
        # extrinsics/focal gradients need dL/d(pos) through the encoding,
        # which forces the exact 8-corner encode (~4x step cost). Instead
        # of paying that every step, compute the camera gradient on one
        # step per interval and scale it by the interval — an unbiased
        # estimate of the reference's per-window accumulation
        # (testbed_nerf.cu:2601-2680 applies on the same 16-step
        # boundary). Effective interval is clamped to the update window;
        # 1 = reference semantics (every step). Exposure gradients don't
        # rebuild rays and stay per-step either way.
        self.cam_grad_interval = 16
        n_img = self.data.n_images
        self.cam_pos_offset = np.zeros((n_img, 3), np.float32)
        self.cam_rot_offset = np.zeros((n_img, 3), np.float32)
        self.cam_focal_offset = np.zeros(2, np.float32)
        from ..ops.host_adam import HostAdam, RotationHostAdam

        self._cam_pos_adam = HostAdam(1e-4)
        self._cam_rot_adam = RotationHostAdam(1e-4)
        self._focal_adam = HostAdam(1e-5)
        self._exposure_adam = HostAdam(1e-3)
        self._cam_grad_accum = None
        self._exposure_grad_accum = None
        self._n_steps_since_cam_update = 0

        # per-image learnable latents ("extra dims"): trained whenever
        # the dataset declares n_extra_learnable_dims (reference
        # optimize_extra_dims default, testbed_nerf.cu:2177; per-step
        # VarAdam at the MODEL optimizer's current lr :2593-2595). The
        # Adam update runs device-side via a TrainableBuffer on the same
        # optimizer config, so no host sync is added.
        self.optimize_extra_dims = self.scene.n_extra_dims > 0
        self._extra_dims_buf = None
        if self.data.extra_dims is not None:
            from ..ops.trainable_buffer import TrainableBuffer

            self._extra_dims_buf = TrainableBuffer(
                tuple(self.data.extra_dims.shape),
                network_config["optimizer"],
                init_value=self.data.extra_dims)
        # render-time latents (reference Nerf::get_rendering_extra_dims,
        # testbed_nerf.cu:3206-3266): a training view's latent (default
        # view 0) or an explicitly set vector
        self.rendering_extra_dims_from_training_view = 0
        self._rendering_extra_dims = None

        # trained envmap + lens-distortion map (reset_network wiring:
        # envmap testbed.cu:3850-3865, distortion :3781-3792)
        from ..ops.trainable_buffer import TrainableBuffer

        self.train_envmap = False
        self.optimize_distortion = False
        env_cfg = network_config.get("envmap", {})
        dist_cfg = network_config.get("distortion_map", {})
        # dataset-provided envmap sizes AND seeds the trainable buffer
        # (set_params_full_precision from dataset.envmap_data,
        # testbed.cu:3861-3863)
        env_res = (8, 16)  # (H, W) default when the dataset has none
        env_init = None
        if dataset.envmap is not None:
            env_res = dataset.envmap.shape[:2]
            env_init = np.asarray(dataset.envmap, np.float32)
        self.has_dataset_envmap = env_init is not None
        self.envmap = TrainableBuffer(
            (env_res[0], env_res[1], 4),
            env_cfg.get("optimizer", network_config["optimizer"]),
            init_value=env_init)
        dist_res = dist_cfg.get("resolution", [32, 32])
        self.distortion_map = TrainableBuffer(
            (dist_res[1], dist_res[0], 2),
            dist_cfg.get("optimizer", network_config["optimizer"]))

        # error-map importance sampling (nerf.h:113-121)
        self.use_error_map_sampling = bool(
            dataset.wants_importance_sampling)
        self.n_steps_between_error_map_updates = 128
        self._error_map = None
        self._error_cdfs = None
        self._n_steps_since_error_update = 0
        self._error_map_res = (0, 0)

        self._visible_cells = None
        self._train_fns = {}     # (n_rays, k) -> jitted step
        self._density_fns = {}

        # observability (reference m_training_prep_ms / m_training_ms /
        # m_loss_scalar EMA — testbed.h:936-940, common_host.h:62-107 —
        # plus the rays/s, samples/s, steps/ray counters the reference's
        # GUI derives; SURVEY.md §5)
        from ..utils import Ema, PhaseTimers

        self.timers = PhaseTimers()
        self.loss_ema = Ema(half_life_s=1.0)
        self.samples_per_s = Ema(half_life_s=2.0)
        self.rays_per_s = Ema(half_life_s=2.0)
        self.steps_per_s = Ema(half_life_s=2.0)
        self.mean_samples_per_ray = 0.0
        self._last_sync_t = None
        self._steps_at_last_sync = 0

    # ------------------------------------------------------------------
    def _cam_grad_interval_eff(self) -> int:
        """Effective camera-gradient sampling interval (clamped to the
        host-Adam window so every window sees >= 1 gradient step)."""
        return max(1, min(getattr(self, "cam_grad_interval", 1),
                          self.n_steps_between_cam_updates))

    def _stoch_now(self) -> bool:
        """Effective stochastic-corner flag at the CURRENT training step
        (the coarse-to-fine variance schedule: stochastic until
        stochastic_corners_until, exact d-linear after)."""
        if not self.stochastic_corners:
            return False
        until = getattr(self, "stochastic_corners_until", None)
        return until is None or self.training_step < until

    def _train_cfg(self, n_rays: int, max_k: int) -> NerfTrainStepConfig:
        """n_rays is PER-CHIP; capacity splits the global target batch
        across shards so the effective batch stays 2^18 total."""
        return NerfTrainStepConfig(
            n_rays=n_rays,
            n_march=self.n_march,
            max_samples_per_ray=max_k,
            sample_capacity=self.target_batch_size
            * self.sample_capacity_multiplier // self._n_shards,
            lens_mode=self.scene.lens_mode,
            cone_angle=self.scene.cone_angle_constant,
            max_mip=self.scene.max_cascade,
            rgb_activation=self.scene.rgb_activation,
            density_activation=self.scene.density_activation,
            loss_type=self.loss_type,
            near_distance=self.scene.near_distance,
            random_bg_color=self.random_bg_color,
            train_in_linear_colors=self.train_in_linear_colors,
            optimize_camera=(self.optimize_extrinsics
                             or self.optimize_focal_length),
            optimize_exposure=self.optimize_exposure,
            optimize_extra_dims=(self.optimize_extra_dims
                                 and self.data.extra_dims is not None),
            use_error_map=self.use_error_map_sampling,
            error_map_res=self._error_map_res,
            stochastic_corners=self._stoch_now(),
            disable_regularizers=getattr(self, "disable_regularizers",
                                         False),
        )

    def _get_train_fn(self, n_rays: int, max_k: int,
                      cam_now: bool = True):
        key = (n_rays, max_k, self.optimize_extrinsics,
               self.optimize_focal_length, self.optimize_exposure,
               self.optimize_extra_dims,
               self.train_envmap, self.optimize_distortion,
               self._error_cdfs is not None, self._error_map_res,
               self.random_bg_color, self.train_in_linear_colors,
               getattr(self, "disable_regularizers", False),
               cam_now,
               self._stoch_now())  # stoch flag last (tests key on it)
        if key not in self._train_fns:
            cfg = self._train_cfg(n_rays, max_k)
            if not cam_now:
                # off-interval step: skip the extrinsics/focal gradient
                # (and with it the exact-encode rebuild); rays still use
                # the CURRENT camera offsets
                cfg = cfg._replace(optimize_camera=False)
            aabb_min = jnp.asarray(self.scene.aabb_min)
            aabb_max = jnp.asarray(self.scene.aabb_max)

            if self.mesh is not None:
                from .parallel import make_sharded_train_step

                self._train_fns[key] = make_sharded_train_step(
                    self.model, self.optimizer, cfg, aabb_min, aabb_max,
                    self.mesh, axis=self.mesh_axis)
                return self._train_fns[key]

            def step(state, data, bitfield, mean_density, rng, cam,
                     error_cdfs, error_map, envmap, distortion):
                return nerf_train_step(self.model, self.optimizer, cfg,
                                       aabb_min, aabb_max, state, data,
                                       bitfield, mean_density, rng,
                                       cam=cam, error_cdfs=error_cdfs,
                                       error_map=error_map,
                                       envmap=envmap,
                                       distortion=distortion)

            self._train_fns[key] = jax.jit(step, donate_argnums=(0,))
        return self._train_fns[key]

    def _get_scanned_train_fn(self, n_rays: int, max_k: int, n_scan: int,
                              prep_mode: str):
        """One jitted program running n_scan x (density update + train
        step) via lax.scan — a single dispatch per block.

        prep_mode: 'per_step' (full-sweep density update before every
        scanned step — warmup), 'lead' (one mixed update before the
        block — a block starting on a 16-step prep boundary), or 'none'
        (block entirely between prep boundaries)."""
        has_error_map = self._error_map is not None
        has_cam = (self.optimize_extrinsics or self.optimize_focal_length
                   or self.optimize_exposure)
        has_ext = self.optimize_extrinsics or self.optimize_focal_length
        interval_gt1 = has_ext and self._cam_grad_interval_eff() > 1
        key = ("scan", n_rays, max_k, n_scan, prep_mode,
               self._error_cdfs is not None, self._error_map_res,
               has_error_map, has_cam, self.optimize_exposure,
               getattr(self, "disable_regularizers", False),
               interval_gt1,
               self._stoch_now())  # stoch flag last (tests key on it)
        if key not in self._train_fns:
            cfg = self._train_cfg(n_rays, max_k)
            cfg_nocam = cfg._replace(optimize_camera=False)
            aabb_min = jnp.asarray(self.scene.aabb_min)
            aabb_max = jnp.asarray(self.scene.aabb_max)
            n_cascades = self.scene.max_cascade + 1
            n_cells = NERF_GRID_N_CELLS * n_cascades
            if self.density_samples_override is not None:
                n_uni = self.density_samples_override
                n_non = 0 if prep_mode == "per_step" else n_uni
            elif prep_mode == "per_step":
                n_uni, n_non = n_cells, 0
            else:
                n_uni = n_non = n_cells // 4
            density_body = self._density_update_body(n_uni, n_non)
            prep_per_step = prep_mode == "per_step"

            def block(state, density_grid, error_map, data, bitfield,
                      mean_density, train_rngs, density_rngs, error_cdfs,
                      decay, cam, cam_flags):
                def one_step(cfg_step, st, bf, mean, em, t_rng):
                    new_st, stats = nerf_train_step(
                        self.model, self.optimizer, cfg_step, aabb_min,
                        aabb_max, st, data, bf, mean, t_rng,
                        cam=cam if has_cam else None,
                        error_cdfs=error_cdfs,
                        error_map=em if has_error_map else None)
                    em2 = stats["error_map"] if "error_map" in stats \
                        else em
                    out = {k: stats[k] for k in
                           ("loss", "measured_batch_size",
                            "measured_batch_size_before_compaction",
                            "fused", "cam_gradient", "exposure_gradient")
                           if k in stats}
                    if has_ext and "cam_gradient" not in out:
                        # no-cam-grad steps contribute a zero so both
                        # cond branches share one output structure
                        out["cam_gradient"] = jax.tree_util.tree_map(
                            jnp.zeros_like, cam)
                    return new_st, em2, out

                def body(carry, xs):
                    st, grid, bf, mean, em = carry
                    t_rng, d_rng, cam_flag = xs
                    if prep_per_step:
                        params = self.optimizer.inference_params(
                            st["opt"], st["params"])
                        grid, bf, mean = density_body(params, grid,
                                                      d_rng, decay)
                    if interval_gt1:
                        # camera-gradient steps pay the exact-encode
                        # rebuild; the others run the cheap stochastic
                        # path (cam_grad_interval, __init__ comment)
                        new_st, em2, out = jax.lax.cond(
                            cam_flag,
                            lambda op: one_step(cfg, *op),
                            lambda op: one_step(cfg_nocam, *op),
                            (st, bf, mean, em, t_rng))
                    else:
                        new_st, em2, out = one_step(cfg, st, bf, mean,
                                                    em, t_rng)
                    return (new_st, grid, bf, mean, em2), out

                if prep_mode == "lead":
                    params = self.optimizer.inference_params(
                        state["opt"], state["params"])
                    density_grid, bitfield, mean_density = density_body(
                        params, density_grid, density_rngs[0], decay)
                (state, density_grid, bitfield, mean_density, error_map
                 ), seq = jax.lax.scan(
                    body,
                    (state, density_grid, bitfield, mean_density,
                     error_map),
                    (train_rngs, density_rngs, cam_flags))
                # scalars report the block's last step; aux gradients SUM
                # over the scan (the eager path accumulates them per
                # step with tree-add — same total at the 16-boundary)
                last = {k: (jax.tree_util.tree_map(
                            lambda x: jnp.sum(x, axis=0), v)
                            if k in ("cam_gradient", "exposure_gradient")
                            else v[-1])
                        for k, v in seq.items()}
                return (state, density_grid, bitfield, mean_density,
                        error_map, last)

            self._train_fns[key] = jax.jit(block,
                                           donate_argnums=(0, 1, 2))
        return self._train_fns[key]

    def _density_update_body(self, n_uniform: int, n_nonuniform: int,
                             evaluate_only: bool = False):
        """The pure per-step density-grid update (shared by the eager
        path, the scanned block, and — with evaluate_only, which returns
        the (idx, dens) evaluation half only — the sharded loop in
        nerf/parallel.py, whatever the mesh size)."""
        n_cascades = self.scene.max_cascade + 1
        aabb_min = jnp.asarray(self.scene.aabb_min)
        aabb_max = jnp.asarray(self.scene.aabb_max)
        model = self.model
        max_cascade = self.scene.max_cascade
        density_activation = self.scene.density_activation
        span = aabb_max - aabb_min

        stoch = self._stoch_now()

        def evaluate(params, density_grid, rng, decay):
            from .model import network_to_density

            k_cells, k_pos, k_enc = jax.random.split(rng, 3)
            idx = sample_cells(k_cells, density_grid, 0, n_uniform,
                               n_nonuniform, n_cascades)
            comps = cell_positions(idx, k_pos)
            warped = tuple((c - aabb_min[k]) / span[k]
                           for k, c in enumerate(comps))
            n_total = idx.shape[0]
            chunk = 1 << 19
            n_chunks = max((n_total + chunk - 1) // chunk, 1)
            pad = n_chunks * chunk - n_total
            stacked = jnp.stack([
                jnp.pad(c, (0, pad)).reshape(n_chunks, chunk)
                for c in warped])

            # stochastic-corner encode at exact_axes=0 (pure 1-corner
            # Bernoulli): the EMA-max grid update already samples ONE
            # random position per cell (the reference does the same,
            # update_density_grid_nerf :2271), so corner noise adds to
            # existing sampling noise, and the max() EMA only errs
            # CONSERVATIVE (noise inflates maxima -> cells stay marked).
            # 2^d fewer fetches than exact, half of the training
            # encode's j=1.
            def density_chunk(cols):
                if stoch and hasattr(model.pos_encoding, "pack_params"):
                    feats = model.pos_encoding.apply_components(
                        params["pos_encoding"],
                        [cols[0], cols[1], cols[2]], rng=k_enc,
                        exact_axes=0)
                elif hasattr(model.pos_encoding, "apply_components"):
                    feats = model.pos_encoding.apply_components(
                        params["pos_encoding"], [cols[0], cols[1],
                                                 cols[2]])
                else:
                    feats = model.pos_encoding.apply(
                        params["pos_encoding"],
                        jnp.stack([cols[0], cols[1], cols[2]], -1))
                return model.density_net.apply(
                    params["density_net"], feats)[..., 0]

            raw = jax.lax.map(density_chunk,
                              jnp.transpose(stacked, (1, 0, 2)))
            raw = raw.reshape(-1)[:n_total]
            dens = network_to_density(raw, density_activation)
            return idx, dens

        if evaluate_only:
            return evaluate

        def update(params, density_grid, rng, decay):
            idx, dens = evaluate(params, density_grid, rng, decay)
            new_grid = splat_and_ema(density_grid, idx, dens, decay)
            bitfield = update_bitfield(new_grid, max_cascade)
            mean = density_grid_mean(new_grid)
            return new_grid, bitfield, mean

        return update

    def _train_scanned_block(self, n_scan: int, prep_mode: str) -> None:
        """Run n_scan steps in one dispatch (steps_per_dispatch path)."""
        if self.training_step == 0 and not self.dataset.has_rays:
            if self._visible_cells is None:
                self._visible_cells = compute_visible_cells(
                    self.data, self.scene)
            self.density_grid = mark_untrained_cells(
                self.density_grid, self._visible_cells)
        self._maybe_init_error_map()
        n_rays = self._bucket(self.rays_per_batch)
        max_k = self._bucket_k(n_rays)
        fn = self._get_scanned_train_fn(n_rays, max_k, n_scan, prep_mode)
        base = jax.random.PRNGKey(self.seed)
        train_rngs = jnp.stack([
            jax.random.fold_in(base, self.training_step + j)
            for j in range(n_scan)])
        dbase = jax.random.PRNGKey(self.seed ^ 0xD3)
        density_rngs = jnp.stack([
            jax.random.fold_in(dbase, self.density_grid_ema_step + j)
            for j in range(n_scan)])
        em = self._error_map
        if em is None:
            em = jnp.zeros((1, 1), jnp.float32)  # unused placeholder
        interval = self._cam_grad_interval_eff()
        since = self._n_steps_since_cam_update
        cam_flags = jnp.asarray(
            [(since + j) % interval == interval - 1
             for j in range(n_scan)])
        (self.state, self.density_grid, self.bitfield, self.mean_density,
         em, stats) = fn(
            self.state, self.density_grid, em, self.data, self.bitfield,
            self.mean_density, train_rngs, density_rngs,
            self._error_cdfs, 0.95, self._cam_dict(), cam_flags)
        # camera/exposure gradients arrive pre-summed over the block;
        # the host Adam applies on the same 16-step boundary as eager.
        # Sampled cam gradients scale by the interval so the window sum
        # keeps the reference accumulation's expectation.
        if "cam_gradient" in stats:
            g = stats["cam_gradient"]
            if interval > 1:
                g = jax.tree_util.tree_map(
                    lambda x: x * float(interval), g)
            self._cam_grad_accum = g if self._cam_grad_accum is None \
                else jax.tree_util.tree_map(jnp.add,
                                            self._cam_grad_accum, g)
        if "exposure_gradient" in stats:
            g = stats["exposure_gradient"]
            self._exposure_grad_accum = (
                g if self._exposure_grad_accum is None
                else self._exposure_grad_accum + g)
        self._n_steps_since_cam_update += n_scan
        if self._n_steps_since_cam_update >= \
                self.n_steps_between_cam_updates:
            self._apply_camera_updates()
            self._n_steps_since_cam_update = 0
        if "fused" in stats:
            try:   # start the (4,) D2H now; the lagged sync reads it
                stats["fused"].copy_to_host_async()
            except Exception:
                pass
        if self._error_map is not None:
            self._error_map = em
            self._n_steps_since_error_update += n_scan
            if self._n_steps_since_error_update >= \
                    self.n_steps_between_error_map_updates:
                self._rebuild_error_cdfs()
                self._n_steps_since_error_update = 0
        self.training_step += n_scan
        self.density_grid_ema_step += {
            "per_step": n_scan, "lead": 1, "none": 0}[prep_mode]
        return stats

    # ------------------------------------------------------------------
    # density grid maintenance (training_prep_nerf)
    # ------------------------------------------------------------------
    def _get_density_fn(self, n_uniform: int, n_nonuniform: int):
        key = (n_uniform, n_nonuniform, self._stoch_now(),
               self.mesh is not None)
        if key not in self._density_fns:
            if self.mesh is not None:
                from .parallel import make_sharded_density_update

                self._density_fns[key] = make_sharded_density_update(
                    self, self.mesh, axis=self.mesh_axis,
                    n_uniform=n_uniform, n_nonuniform=n_nonuniform)
            else:
                self._density_fns[key] = jax.jit(
                    self._density_update_body(n_uniform, n_nonuniform))
        return self._density_fns[key]

    def training_prep(self, decay: float = 0.95) -> None:
        """Occupancy-grid maintenance before a train step
        (training_prep_nerf :2933-2946)."""
        n_cascades = self.scene.max_cascade + 1
        n_cells = NERF_GRID_N_CELLS * n_cascades

        if self.training_step == 0 and not self.dataset.has_rays:
            if self._visible_cells is None:
                self._visible_cells = compute_visible_cells(
                    self.data, self.scene)
            self.density_grid = mark_untrained_cells(
                self.density_grid, self._visible_cells)

        full_sweep = self.training_step < self.warmup_full_grid_preps
        if self.density_samples_override is not None:
            n = self.density_samples_override
            counts = (n, 0 if full_sweep else n)
        elif full_sweep:
            counts = (n_cells, 0)
        else:
            counts = (n_cells // 4, n_cells // 4)
        fn = self._get_density_fn(*counts)
        rng = jax.random.fold_in(
            jax.random.PRNGKey(self.seed ^ 0xD3), self.density_grid_ema_step)
        if self.mesh is not None:
            rng = jnp.stack([jax.random.fold_in(rng, c)
                             for c in range(self._n_shards)])
        params = self.optimizer.inference_params(self.state["opt"],
                                                 self.state["params"])
        self.density_grid, self.bitfield, self.mean_density = fn(
            params, self.density_grid, rng, decay)
        self.density_grid_ema_step += 1

    # ------------------------------------------------------------------
    def _cam_dict(self):
        if not (self.optimize_extrinsics or self.optimize_focal_length
                or self.optimize_exposure):
            return None
        return {"pos": jnp.asarray(self.cam_pos_offset),
                "rot": jnp.asarray(self.cam_rot_offset),
                "focal": jnp.asarray(self.cam_focal_offset)}

    def _maybe_init_error_map(self):
        if not self.use_error_map_sampling:
            return
        if self._error_map is None or self._n_steps_since_error_update == 0:
            n_samples_per_image = (self.n_steps_between_error_map_updates
                                   * self.rays_per_batch
                                   // max(self.data.n_images, 1))
            w0, h0 = self.data.resolution
            side = int(math.sqrt(math.sqrt(max(n_samples_per_image, 1)))
                       * 3.5)
            side = max((side + 7) // 8 * 8, 8)  # bucket: bound retraces
            res = (min(side, w0), min(side, h0))
            if res != self._error_map_res or self._error_map is None:
                self._error_map_res = res
                self._error_map = jnp.zeros(
                    (self.data.n_images, res[0] * res[1]), jnp.float32)

    def _rebuild_error_cdfs(self):
        """construct_cdf_2d/1d + image CDF (testbed_nerf.cu:1493-1554,
        2552-2567): minimum probability floor, normalized prefix sums."""
        cw, ch = self._error_map_res
        em = np.asarray(self._error_map).reshape(
            self.data.n_images, ch, cw).astype(np.float64)
        em = em + 1e-8  # MIN_PMF floor
        # conditional CDF over x given y, per row
        cdf_x = np.cumsum(em, axis=2)
        row_sum = cdf_x[:, :, -1:]
        cdf_x = cdf_x / row_sum
        # marginal over rows
        cdf_y = np.cumsum(row_sum[:, :, 0], axis=1)
        img_sum = cdf_y[:, -1:]
        cdf_y = cdf_y / img_sum
        cdf_img = np.cumsum(img_sum[:, 0])
        cdf_img = cdf_img / cdf_img[-1]
        self._error_cdfs = {
            "cdf_x_cond_y": jnp.asarray(cdf_x, jnp.float32),
            "cdf_y": jnp.asarray(cdf_y, jnp.float32),
            "cdf_img": jnp.asarray(cdf_img, jnp.float32),
        }
        self._error_map = jnp.zeros_like(self._error_map)

    def _apply_camera_updates(self):
        """Host Adam on accumulated camera gradients every
        n_steps_between_cam_updates steps (testbed_nerf.cu:2601-2680)."""
        if self._cam_grad_accum is None and self._exposure_grad_accum is None:
            return
        n = max(self.data.n_images, 1)
        scale = n / float(self.n_steps_between_cam_updates)
        if self._cam_grad_accum is not None:
            g_pos = np.asarray(self._cam_grad_accum["pos"]) * scale
            g_rot = np.asarray(self._cam_grad_accum["rot"]) * scale
            g_focal = np.asarray(self._cam_grad_accum["focal"]) * scale
            if self.optimize_extrinsics:
                g_pos += self.cam_pos_offset * self.extrinsic_l2_reg
                g_rot += self.cam_rot_offset * self.extrinsic_l2_reg
                lr = self.extrinsic_learning_rate * math.pow(
                    0.33, self._cam_pos_adam.t / 128)
                self._cam_pos_adam.learning_rate = lr
                self._cam_rot_adam.learning_rate = lr
                self.cam_pos_offset = self._cam_pos_adam.step(
                    self.cam_pos_offset, g_pos)
                self.cam_rot_offset = self._cam_rot_adam.step(
                    self.cam_rot_offset, g_rot)
            if self.optimize_focal_length:
                g_focal += self.cam_focal_offset * self.intrinsic_l2_reg
                self.cam_focal_offset = self._focal_adam.step(
                    self.cam_focal_offset, g_focal)
        if self._exposure_grad_accum is not None and self.optimize_exposure:
            g = np.asarray(self._exposure_grad_accum) * scale
            exposures = np.asarray(self.data.exposures)
            g += exposures * self.exposure_l2_reg
            new_exp = self._exposure_adam.step(exposures, g)
            new_exp -= new_exp.mean(0, keepdims=True)  # renormalize
            self.data.exposures = jnp.asarray(new_exp)
        self._cam_grad_accum = None
        self._exposure_grad_accum = None

    # host sync cadence: reading any stat blocks on the device stream,
    # so stats are read (and rays/batch adapted) only every sync_every
    # steps, letting JAX's async dispatch pipeline the steps in between.
    sync_every = 16
    # steady-state density-prep cadence (reference: every 16 steps once
    # past step 256, testbed.cu:4060-4062)
    prep_every = 16

    def train(self, n_steps: int) -> float:
        """n_steps full training iterations (prep + step + adapt)."""
        # camera/exposure/focal optimization scans (gradients accumulate
        # across the block; host Adam on the 16-boundary). Envmap/
        # distortion/latent optimization steps a device Adam every step
        # — not expressible in a fixed-param scan — so those stay eager.
        scan_incompatible = (
            self.train_envmap or self.optimize_distortion
            or (self.optimize_extra_dims
                and self.data.extra_dims is not None))
        cam_active = (self.optimize_extrinsics or self.optimize_exposure
                      or self.optimize_focal_length)
        K = self.steps_per_dispatch
        if K > 1 and not scan_incompatible and self.mesh is None:
            done = 0
            while done < n_steps:
                # unified prep schedule (same as the eager path): full
                # sweep before each of the first warmup_full_grid_preps
                # steps, then one mixed prep at every prep_every-step
                # boundary. Blocks never straddle a boundary.
                k = min(K, n_steps - done)
                step = self.training_step
                until = getattr(self, "stochastic_corners_until", None)
                if (self.stochastic_corners and until is not None
                        and step < until):
                    # a block must not straddle the stochastic->exact
                    # switch (the scanned program bakes the flag in)
                    k = min(k, until - step)
                if cam_active:
                    # nor the camera-update boundary (offsets are
                    # constant within a block, like eager between
                    # host-Adam applications)
                    k = min(k, self.n_steps_between_cam_updates
                            - self._n_steps_since_cam_update)
                if step < self.warmup_full_grid_preps:
                    k = min(k, self.warmup_full_grid_preps - step)
                    mode = "per_step"
                else:
                    off = step % self.prep_every
                    if off == 0:
                        mode = "lead"
                        k = min(k, self.prep_every)
                    else:
                        mode = "none"
                        k = min(k, self.prep_every - off)
                with self.timers.time("scan_dispatch"):
                    stats = self._train_scanned_block(k, mode)
                done += k
                with self.timers.time("train_sync"):
                    # mid-run blocks sync the PREVIOUS block's marker
                    # (lagged, already landed) so consecutive blocks
                    # pipeline on the device queue; only the last block
                    # of the call blocks on its own stats
                    self._sync_stats([stats], final=(done >= n_steps))
            return self.loss_scalar

        pending = []  # (stats, step_idx) not yet synced
        for i in range(n_steps):
            # density-grid maintenance cadence — adaptation of the
            # reference's (testbed.cu:4060-4062 preps every step before
            # step 256, then every 16): we run
            # warmup_full_grid_preps per-step full sweeps, then one
            # mixed 1/4+1/4 prep at every prep_every-step boundary. The
            # same schedule drives the scanned (steps_per_dispatch)
            # path so the two are bit-identical.
            if (self.training_step < self.warmup_full_grid_preps
                    or self.training_step % self.prep_every == 0):
                with self.timers.time("training_prep"):
                    self.training_prep()
            self._maybe_init_error_map()
            # per-chip ray bucket; the effective batch is n_rays * shards
            n_rays = self._bucket(self.rays_per_batch // self._n_shards)
            max_k = self._bucket_k(n_rays * self._n_shards)
            cam_active = (self.optimize_extrinsics
                          or self.optimize_focal_length)
            interval = self._cam_grad_interval_eff()
            # mesh path keeps per-step cam gradients (correctness-first
            # multi-chip path; the interval optimization is single-chip)
            cam_now = ((not cam_active) or self.mesh is not None
                       or (self._n_steps_since_cam_update % interval
                           == interval - 1))
            fn = self._get_train_fn(n_rays, max_k, cam_now)
            rng = jax.random.fold_in(jax.random.PRNGKey(self.seed),
                                     self.training_step)
            if self.mesh is not None:
                rng = jnp.stack([jax.random.fold_in(rng, c)
                                 for c in range(self._n_shards)])
            self.state, stats = fn(
                self.state, self.data, self.bitfield, self.mean_density,
                rng, self._cam_dict(), self._error_cdfs, self._error_map,
                self.envmap.params if self.train_envmap else None,
                self.distortion_map.params if self.optimize_distortion
                else None)
            self.training_step += 1
            pending.append(stats)
            if "fused" in stats:
                # start the (4,)-vector D2H now; it overlaps the queued
                # compute so the 16-step sync read finds it already
                # on the host (16 bytes/step — negligible traffic)
                try:
                    stats["fused"].copy_to_host_async()
                except Exception:
                    pass

            # device-side (async) consumers of this step's outputs
            if "extra_dims_gradient" in stats \
                    and self._extra_dims_buf is not None:
                # per-step Adam at the model optimizer's lr (reference
                # testbed_nerf.cu:2593-2595) — fully on device
                self._extra_dims_buf.step(stats["extra_dims_gradient"])
                self.data.extra_dims = self._extra_dims_buf.params
            if "envmap_gradient" in stats:
                self.envmap.step(stats["envmap_gradient"])
            if "distortion_gradient" in stats:
                self.distortion_map.step(stats["distortion_gradient"])
            if "cam_gradient" in stats:
                g = stats["cam_gradient"]
                if interval > 1 and self.mesh is None:
                    # sampled gradient scales by the interval to keep
                    # the window-sum expectation (cam_grad_interval)
                    g = jax.tree_util.tree_map(
                        lambda x: x * float(interval), g)
                self._cam_grad_accum = g if self._cam_grad_accum is None \
                    else jax.tree_util.tree_map(jnp.add,
                                                self._cam_grad_accum, g)
            if "exposure_gradient" in stats:
                g = stats["exposure_gradient"]
                self._exposure_grad_accum = (
                    g if self._exposure_grad_accum is None
                    else self._exposure_grad_accum + g)
            self._n_steps_since_cam_update += 1
            if self._n_steps_since_cam_update >= \
                    self.n_steps_between_cam_updates:
                self._apply_camera_updates()   # syncs (host Adam)
                self._n_steps_since_cam_update = 0
            if "error_map" in stats:
                self._error_map = stats["error_map"]
                self._n_steps_since_error_update += 1
                if self._n_steps_since_error_update >= \
                        self.n_steps_between_error_map_updates:
                    self._rebuild_error_cdfs()  # syncs (numpy CDFs)
                    self._n_steps_since_error_update = 0

            if len(pending) >= self.sync_every or i == n_steps - 1:
                with self.timers.time("train_sync"):
                    self._sync_stats(pending, final=(i == n_steps - 1))
                pending = []
        return self.loss_scalar

    def _sync_stats(self, pending, final: bool = True) -> None:
        """Block once on a batch of steps' stats; adapt from the latest.

        Reads the ONE fused (4,) stats vector (loss, measured, measured
        pre-compaction, n_rays) in a single D2H transfer instead of four
        scalar reads.

        Mid-run syncs (final=False) read the PREVIOUS cadence's marker
        step instead of the newest one: the newest step was dispatched
        microseconds ago, so blocking on it drains the whole device
        queue; the lagged marker's async D2H landed a cadence
        ago and costs ~0. Adaptation thus runs on 16-step-old stats —
        the same information one cadence later (the reference adapts
        from the previous step for the same reason,
        testbed_nerf.cu:2442). The last sync of a train() call is
        final=True and reads the true latest step."""
        import time as _time

        if not pending:
            return
        stats = pending[-1]
        if not final:
            lagged = getattr(self, "_lagged_sync_marker", None)
            self._lagged_sync_marker = stats
            if lagged is not None:
                stats = lagged
        else:
            self._lagged_sync_marker = None
        if "fused" in stats:
            vec = np.asarray(stats["fused"])
            loss_v = float(vec[0])
            measured = int(vec[1])
            measured_pre = int(vec[2])
            n_rays_stat = int(vec[3])
        else:
            loss_v = float(stats["loss"])
            measured = int(stats["measured_batch_size"])
            measured_pre = int(
                stats["measured_batch_size_before_compaction"])
            n_rays_stat = int(stats.get("n_rays", self.rays_per_batch))
        if measured == 0:
            self.loss_scalar = 0.0
            raise RuntimeError(
                "NeRF training generated 0 samples; aborting "
                "(reference testbed_nerf.cu:2516-2520)")
        self.loss_scalar = loss_v * measured / self.target_batch_size
        self.loss_ema.update(self.loss_scalar)
        self.measured_batch_size = measured
        self.measured_batch_size_before_compaction = measured_pre

        # throughput counters (SURVEY.md §5): per-sync window rates
        now = _time.perf_counter()
        steps_done = self.training_step - self._steps_at_last_sync
        if self._last_sync_t is not None and steps_done > 0:
            dt = max(now - self._last_sync_t, 1e-9)
            n_rays_used = n_rays_stat
            self.steps_per_s.update(steps_done / dt)
            self.samples_per_s.update(steps_done * measured / dt)
            self.rays_per_s.update(steps_done * n_rays_used / dt)
            self.mean_samples_per_ray = measured / max(n_rays_used, 1)
        self._last_sync_t = now
        self._steps_at_last_sync = self.training_step

        if not self.adapt_ray_batch:
            return
        # adaptive rays/batch (update_after_training :2442-2443),
        # additionally clamped so expected GENERATED samples fit the
        # static capacity (reference drops overflowing rays instead)
        new_rays = int(self.rays_per_batch * self.target_batch_size
                       / max(measured, 1))
        capacity = (self.target_batch_size
                    * self.sample_capacity_multiplier)
        cap_rays = int(self.rays_per_batch * capacity
                       / max(measured_pre, 1))
        # ray cap: the reference allows 2^18 rays; the candidate-domain
        # composite materializes (rays, n_march) planes, so bound rays to
        # keep that under ~16M lanes (2^14 x 1024)
        self.rays_per_batch = min(max(min(new_rays, cap_rays), 256),
                                  1 << 14)

    def performance_stats(self):
        """The counters the reference's GUI surfaces (steps/s, rays/s,
        samples/s, steps-per-ray, per-phase ms) as one dict."""
        return {
            "steps_per_s": self.steps_per_s.value,
            "rays_per_s": self.rays_per_s.value,
            "samples_per_s": self.samples_per_s.value,
            "mean_samples_per_ray": self.mean_samples_per_ray,
            "loss_ema": self.loss_ema.value,
            "measured_batch_size": self.measured_batch_size,
            "rays_per_batch": self.rays_per_batch,
            "phase_ms": self.timers.summary(),
        }

    def _derive_n_march(self) -> int:
        """Worst-case per-ray candidate count for THIS scene's cameras.

        The march examines candidates k in [0, n_march) relative to each
        ray's own aabb-entry stepping index s0, so the needed depth is
        max over rays of s(t_exit) - s(t_enter) — below the 1024 global
        cap when cameras sit close to or inside the volume (fox's orbit
        spans ~892 stepping units -> still 1024 after margin; tighter
        captures land at 640 or less). Sampled over a sparse pixel grid
        of every camera with a
        10% + 32-step margin, rounded up to a power of two."""
        from .march import ray_intersect_aabb, to_stepping_space
        from .sampler import build_rays

        cone = self.scene.cone_angle_constant
        n_img = self.data.n_images
        lin = jnp.linspace(0.02, 0.98, 8)
        uv1 = jnp.stack(jnp.meshgrid(lin, lin, indexing="xy"),
                        -1).reshape(-1, 2)                    # (64, 2)
        uv = jnp.tile(uv1, (n_img, 1))
        idx = jnp.repeat(jnp.arange(n_img), uv1.shape[0])
        try:
            o, d, ok = build_rays(self.data, idx, uv,
                                  jnp.zeros(idx.shape[0]),
                                  self.scene.lens_mode)
            lo = jnp.asarray(self.scene.aabb_min)
            hi = jnp.asarray(self.scene.aabb_max)
            tmin, tmax = ray_intersect_aabb(o, d, lo, hi)
            tmin = jnp.maximum(tmin, 0.0)
            span = jnp.where(ok & (tmax > tmin),
                             to_stepping_space(tmax, cone)
                             - to_stepping_space(tmin, cone), 0.0)
            worst = float(jnp.max(span))
        except Exception:
            worst = 1024.0
        need = int(worst * 1.1) + 32
        # round to a lane-aligned multiple of 128, not a power of two:
        # n_march is derived ONCE per scene (it never adapts, so it can't
        # cause recompiles) and every (R, n_march) march/composite plane
        # scales linearly with it — fox needs 582, and pow2 rounding
        # would waste 1.6x on a 1024 cap
        return min(max((need + 127) // 128 * 128, 128), 1024)

    @staticmethod
    def _bucket(n: int) -> int:
        """Round up to the next power of two to bound recompiles."""
        return 1 << max(int(math.ceil(math.log2(max(n, 256)))), 8)

    def _bucket_k(self, n_rays: int) -> int:
        """Padded samples-per-ray for compositing: enough to cover the
        target batch at this ray count, clamped to the march cap."""
        k = self.target_batch_size // max(n_rays, 1) * 4
        k = 1 << int(math.ceil(math.log2(max(k, 8))))
        return min(max(k, 8), self.max_samples_per_ray)

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def set_rendering_extra_dims_from_training_view(self, trainview: int):
        """Render with training view `trainview`'s latent code
        (Nerf::set_rendering_extra_dims_from_training_view,
        testbed_nerf.cu:3246-3256)."""
        if not (0 <= trainview < self.data.n_images):
            raise ValueError(f"invalid training view {trainview}")
        self.rendering_extra_dims_from_training_view = trainview
        self._rendering_extra_dims = None

    def set_rendering_extra_dims(self, vals):
        """Render with an explicit latent vector (:3258-3266)."""
        vals = np.asarray(vals, np.float32).reshape(-1)
        if vals.size != self.scene.n_extra_dims:
            raise ValueError(
                f"expected {self.scene.n_extra_dims} extra dims")
        self.rendering_extra_dims_from_training_view = -1
        self._rendering_extra_dims = vals

    def get_rendering_extra_dims(self):
        """The active render-time latent (n_extra,) or None
        (Nerf::get_rendering_extra_dims, testbed_nerf.cu:3206-3220)."""
        if self.data.extra_dims is None:
            return None
        view = self.rendering_extra_dims_from_training_view
        if view >= 0:
            return self.data.extra_dims[view]
        return jnp.asarray(self._rendering_extra_dims)

    def _get_render_fn(self, tile: int, mode: str, min_transmittance: float,
                       has_extra: bool = False):
        stoch = (self.render_stochastic_corners
                 and mode not in ("Normals", "EncodingVis"))
        key = (tile, mode, min_transmittance, has_extra, stoch,
               self.render_max_samples_per_ray)
        if not hasattr(self, "_render_fns"):
            self._render_fns = {}
        if key not in self._render_fns:
            from .render import (RenderConfig, WavefrontRenderer,
                                 render_tile)

            # depth-major compaction + query budget (reference
            # target_n_queries=2M, testbed_nerf.cu:1697): capacity is the
            # budget, not tile*max_k — truncation sheds every ray's deep
            # tail uniformly, so late rays can't starve and the network
            # never evaluates a 64x-padded buffer
            k_render = (self.render_max_samples_per_ray
                        or min(self.max_samples_per_ray, self.n_march))
            cfg = RenderConfig(
                n_rays=tile, n_march=self.n_march,
                max_samples_per_ray=k_render,
                sample_capacity=min(tile * k_render,
                                    self.render_query_budget),
                cone_angle=self.scene.cone_angle_constant,
                max_mip=self.scene.max_cascade,
                rgb_activation=self.scene.rgb_activation,
                density_activation=self.scene.density_activation,
                min_transmittance=min_transmittance,
                render_mode=mode,
                stochastic_corners=stoch)
            aabb_min = jnp.asarray(self.scene.aabb_min)
            aabb_max = jnp.asarray(self.scene.aabb_max)

            if mode in ("Shade", "Depth", "AO") and self.render_wavefront:
                # early-out wavefront path: dead rays are never
                # evaluated (NerfTracer::trace semantics) — ~10x fewer
                # network evaluations on opaque scenes than the
                # capacity-bound render_tile. Weighted-sum outputs are
                # identical, so Depth/AO ride the same program.
                wr = WavefrontRenderer(self.model, cfg, aabb_min,
                                       aabb_max)
                if mode == "Shade":
                    self._render_fns[key] = wr.render
                elif mode == "Depth":
                    def depth_fn(params, o, d, bitfield, bg, extra=None,
                                 rng=None):
                        out = dict(wr.render(params, o, d, bitfield,
                                             jnp.zeros_like(bg), extra,
                                             rng=rng))
                        out["rgb"] = jnp.stack([out["depth"]] * 3, -1) \
                            + (1.0 - out["alpha"])[:, None] * bg
                        return out
                    self._render_fns[key] = depth_fn
                else:
                    def ao_fn(params, o, d, bitfield, bg, extra=None,
                              rng=None):
                        out = dict(wr.render(params, o, d, bitfield,
                                             jnp.zeros_like(bg), extra,
                                             rng=rng))
                        out["rgb"] = jnp.stack([out["alpha"]] * 3, -1) \
                            + (1.0 - out["alpha"])[:, None] * bg
                        return out
                    self._render_fns[key] = ao_fn
                return self._render_fns[key]

            def fn(params, origins, dirs, bitfield, bg, extra=None,
                   rng=None):
                return render_tile(self.model, cfg, params, origins, dirs,
                                   bitfield, aabb_min, aabb_max, bg,
                                   extra_dims=extra, rng=rng)

            self._render_fns[key] = jax.jit(fn)
        return self._render_fns[key]

    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length=None, spp: int = 1,
                     background_color=(0.0, 0.0, 0.0),
                     render_mode: str = "Shade",
                     min_transmittance: float = 1e-2,
                     tile: Optional[int] = None,
                     lens_mode: int = 0, lens_params=None,
                     screen_center=(0.5, 0.5),
                     use_distortion_map: bool = False,
                     aperture_size: float = 0.0,
                     focus_z: float = 1.0,
                     use_envmap_background: Optional[bool] = None,
                     extra_dims=None,
                     ) -> np.ndarray:
        """Render a frame; returns (H, W, 4) linear float32.

        camera_matrix: (3, 4) NGP-space camera. focal_length defaults to a
        50mm-ish fov scaled from the training camera if available.
        spp > 1 accumulates jittered subpixel samples (render_buffer
        accumulate semantics).

        aperture_size/focus_z: depth of field (reference m_aperture_size /
        m_slice_plane_z autofocus pipeline, testbed.cu:2777-2802 +
        init_rays kernel) — each spp sample draws fresh per-pixel disk
        offsets, so accumulation converges to the thin-lens blur.

        use_envmap_background: composite the trained/loaded envmap behind
        the scene, per-ray by direction (render_nerf,
        testbed_nerf.cu:1862-1866). Defaults to on whenever an envmap is
        being trained.

        extra_dims: per-frame latent override; defaults to the active
        rendering extra dims (a training view's trained latent, view 0
        unless set_rendering_extra_dims* changed it — the reference
        conditions every render on these, get_rendering_extra_dims at
        render_nerf, testbed_nerf.cu:1848)."""
        from ..ops.sampling import ld_pixel_offset
        from .render import camera_rays_for_frame

        if tile is None:
            # wavefront tiles are FAT: its per-depth-chunk host loop
            # costs one blocking readback per round, so fewer/larger
            # tiles amortize it (the march is
            # sub-chunked inside prep to bound memory); render_tile is
            # one dispatch per tile and prefers small tiles
            wavefront = (self.render_wavefront
                         and render_mode in ("Shade", "Depth", "AO"))
            tile = (1 << 19) if wavefront else (1 << 13)

        if focal_length is None:
            fl = np.asarray(self.data.focal_lengths[0])
            res0 = self.data.resolution
            fl = fl * np.array([width / res0[0], height / res0[1]])
        else:
            fl = np.asarray(focal_length, np.float32)
            if fl.ndim == 0:
                fl = np.array([float(fl), float(fl)], np.float32)

        dist_map = None
        if use_distortion_map or self.optimize_distortion:
            dist_map = self.distortion_map.params

        if render_mode == "Distortion":
            # screen-space lens visualization; no marching
            from .render import distortion_flow_image
            return np.asarray(distortion_flow_image(
                width, height, fl, camera_matrix, screen_center,
                lens_mode=lens_mode, lens_params=lens_params,
                distortion_map=dist_map))

        if extra_dims is None:
            extra_dims = self.get_rendering_extra_dims()
        elif not hasattr(extra_dims, "shape"):
            extra_dims = jnp.asarray(extra_dims, jnp.float32)

        params = self.inference_params()
        fn = self._get_render_fn(tile, render_mode, min_transmittance,
                                 has_extra=extra_dims is not None)
        bg_const = jnp.broadcast_to(
            jnp.asarray(background_color, jnp.float32), (tile, 3))

        if use_envmap_background is None:
            # on whenever an envmap exists: being trained, or loaded
            # from the dataset (render_nerf composites the envmap for
            # every ray when envmap data is present, :1862-1866)
            use_envmap_background = (self.train_envmap
                                     or self.has_dataset_envmap)
        env_params = self.envmap.params if use_envmap_background else None
        if env_params is not None:
            from ..ops.trainable_buffer import read_envmap

            if not hasattr(self, "_env_bg_fn"):
                # envmap over the constant background, premult-alpha
                self._env_bg_fn = jax.jit(lambda ep, d, b: (
                    lambda e: e[..., :3] + b * (1.0 - e[..., 3:4]))(
                        read_envmap(ep, d)))

        n_pixels = width * height
        acc = jnp.zeros((n_pixels, 4), jnp.float32)
        depth_acc = jnp.zeros((n_pixels,), jnp.float32)
        for s in range(spp):
            jitter = None if spp == 1 else ld_pixel_offset(s)
            # jitted + cached: lens undistortion is dozens of small ops
            # (Newton iterations) — eager dispatch would pay per-op
            # latency every frame
            if not hasattr(self, "_ray_fns"):
                self._ray_fns = {}
            rk = (width, height, lens_mode, lens_params is not None,
                  dist_map is not None, jitter is not None,
                  float(aperture_size), float(focus_z))
            if rk not in self._ray_fns:
                self._ray_fns[rk] = jax.jit(
                    lambda fl, cam, sc, lp, dm, jit_off, ap_key:
                    camera_rays_for_frame(
                        width, height, fl, cam, screen_center=sc,
                        lens_mode=lens_mode, lens_params=lp,
                        distortion_map=dm, jitter=jit_off,
                        aperture_size=aperture_size, focus_z=focus_z,
                        aperture_key=ap_key),
                    static_argnames=())
            ap_key = (jax.random.fold_in(jax.random.PRNGKey(0xAB), s)
                      if aperture_size != 0.0 else None)
            origins, dirs = self._ray_fns[rk](
                jnp.asarray(fl, jnp.float32),
                jnp.asarray(camera_matrix, jnp.float32),
                jnp.asarray(screen_center, jnp.float32),
                None if lens_params is None
                else jnp.asarray(lens_params, jnp.float32),
                dist_map, jitter, ap_key)
            n_pad = (n_pixels + tile - 1) // tile * tile
            # pad rays MISS the aabb (origin far outside, pointing
            # away): render_tile masks them as invalid, and the
            # wavefront renderer never spends a round on them
            o = jnp.concatenate(
                [origins, jnp.full((n_pad - n_pixels, 3), 9.0)])
            d = jnp.concatenate(
                [dirs, jnp.ones((n_pad - n_pixels, 3)) * 0.577])
            rgbs, alphas, depths = [], [], []
            stoch_render = (self.render_stochastic_corners
                            and render_mode not in ("Normals",
                                                    "EncodingVis"))
            for i in range(0, n_pad, tile):
                d_tile = d[i:i + tile]
                bg = bg_const if env_params is None else \
                    self._env_bg_fn(env_params, d_tile, bg_const)
                render_rng = None
                if stoch_render:
                    # fresh key per (spp pass, tile): estimator noise
                    # decorrelates across spp and averages out
                    render_rng = jax.random.fold_in(
                        jax.random.fold_in(
                            jax.random.PRNGKey(self.seed ^ 0x7E4D), s), i)
                out = fn(params, o[i:i + tile], d_tile,
                         self.bitfield, bg, extra_dims, rng=render_rng)
                rgbs.append(out["rgb"])
                alphas.append(out["alpha"])
                depths.append(out["depth"])
            rgb = jnp.concatenate(rgbs)[:n_pixels]
            alpha = jnp.concatenate(alphas)[:n_pixels]
            depth = jnp.concatenate(depths)[:n_pixels]
            acc = acc + jnp.concatenate([rgb, alpha[:, None]], axis=-1)
            depth_acc = depth_acc + depth
        frame = np.asarray(acc / spp).reshape(height, width, 4)
        return frame

    def render_training_view(self, img_idx: int, spp: int = 1,
                             width: Optional[int] = None,
                             height: Optional[int] = None,
                             min_transmittance: float = 1e-4,
                             background_color=(0.0, 0.0, 0.0)) -> np.ndarray:
        """Render from a training camera (the --test_transforms eval view)."""
        w0, h0 = (int(v) for v in np.asarray(
            self.data.resolutions[img_idx]))
        width = width or w0
        height = height or h0
        fl = np.asarray(self.data.focal_lengths[img_idx]) \
            * np.array([width / w0, height / h0])
        cam = self.effective_xform(img_idx)
        # render through the training camera's actual lens (the reference
        # always rasterizes eval views with the per-frame lens —
        # testbed_nerf.cu:1855 render_with_lens_distortion); a pinhole
        # render of an OpenCV-lens capture like fox misaligns pixels
        extra = None
        if self.data.extra_dims is not None:
            # the view's own trained latent conditions its eval render
            extra = self.data.extra_dims[img_idx]
        return self.render_frame(
            width, height, cam, fl, spp=spp,
            min_transmittance=min_transmittance,
            background_color=background_color,
            lens_mode=self.scene.lens_mode,
            lens_params=np.asarray(self.data.lens_params[img_idx]),
            screen_center=np.asarray(self.data.principal_points[img_idx]),
            extra_dims=extra)

    def render_density_slice(self, resolution: int = 256,
                             plane_z: float = 0.5) -> np.ndarray:
        """ERenderMode::Slice equivalent: false-color raw density on an
        axis-aligned plane (the reference's slice view + the
        density_slices PNG export)."""
        from ..geom.marching import density_slice_image
        from .march import warp_position

        params = self.inference_params()
        lo, hi = self.scene.aabb_min, self.scene.aabb_max
        lin = np.linspace(0, 1, resolution, dtype=np.float32)
        xx, yy = np.meshgrid(lin, lin, indexing="xy")
        pos = np.stack([xx, yy, np.full_like(xx, plane_z)], -1) \
            .reshape(-1, 3) * (hi - lo) + lo

        raw = np.asarray(self.model.density(
            params, np.asarray(warp_position(
                jnp.asarray(pos), jnp.asarray(lo), jnp.asarray(hi)))))
        field = raw.reshape(resolution, resolution, 1)
        return density_slice_image(field, axis=2, index=0)

    def optimise_mesh_step(self, verts: np.ndarray, faces: np.ndarray,
                           n_steps: int = 1, thresh: float = 2.5,
                           smooth_amount: float = 0.002,
                           density_amount: float = 0.001,
                           inflate_amount: float = 0.0,
                           learning_rate: float = 1e-4) -> np.ndarray:
        """Differentiable mesh refinement against the density field
        (optimise_mesh_step, testbed_nerf.cu:2948-3000 +
        compute_mesh_opt_gradients, marching_cubes.h:31): per step, move
        vertices toward the density iso-crossing along the density input
        gradient, plus Laplacian smoothing and optional inflation, via a
        host Adam on the vertex positions."""
        from ..geom.marching import smooth_mesh, vertex_normals
        from ..ops.host_adam import HostAdam
        from .march import warp_position

        params = self.inference_params()
        aabb_min = jnp.asarray(self.scene.aabb_min)
        aabb_max = jnp.asarray(self.scene.aabb_max)
        adam = HostAdam(learning_rate)
        v = np.asarray(verts, np.float32).copy()

        @jax.jit
        def density_and_grad(pos):
            def f(p):
                warped = warp_position(p, aabb_min, aabb_max)
                return jnp.sum(self.model.density(params, warped))

            raw = self.model.density(
                params, warp_position(pos, aabb_min, aabb_max))
            grad = jax.grad(f)(pos)
            return raw, grad

        for _ in range(n_steps):
            raw, grad = density_and_grad(jnp.asarray(v))
            raw = np.asarray(raw)
            grad = np.asarray(grad)
            n_hat = grad / np.maximum(
                np.linalg.norm(grad, axis=-1, keepdims=True), 1e-9)
            centroid = smooth_mesh(v, faces, iterations=1, lam=1.0)
            normals = vertex_normals(v, faces)
            g = (density_amount * (raw - thresh)[:, None] * n_hat
                 + smooth_amount * (v - centroid)
                 + inflate_amount * normals)
            v = adam.step(v, g)
        return v

    def find_closest_training_view(self, camera_matrix) -> int:
        """Index of the training camera nearest (pos + orientation) to the
        given matrix (find_best_training_view, testbed_nerf.cu)."""
        cam = np.asarray(camera_matrix, np.float32)
        xforms = np.asarray(self.data.xforms_start)
        pos_d = np.linalg.norm(xforms[:, :3, 3] - cam[:3, 3], axis=-1)
        dir_d = np.linalg.norm(xforms[:, :3, 2] - cam[:3, 2], axis=-1)
        return int(np.argmin(pos_d + dir_d))

    def effective_xform(self, img_idx: int) -> np.ndarray:
        """Training camera with any optimized extrinsic offsets applied
        (update_transforms equivalent)."""
        cam = np.asarray(self.data.xforms_start[img_idx])
        if self.optimize_extrinsics:
            from ..ops.host_adam import rotvec_to_matrix

            R = rotvec_to_matrix(self.cam_rot_offset[img_idx])
            cam = np.concatenate(
                [R @ cam[:3, :3],
                 (cam[:3, 3] + self.cam_pos_offset[img_idx])[:, None]],
                axis=1).astype(np.float32)
        return cam

    def eval_psnr(self, img_idx: int, spp: int = 1,
                  downscale: int = 1) -> float:
        """PSNR of a rendered training view vs its ground-truth image in
        sRGB space (scripts/run.py:252-268 semantics, black background)."""
        from ..common import linear_to_srgb

        w0, h0 = (int(v) for v in np.asarray(
            self.data.resolutions[img_idx]))
        w, h = w0 // downscale, h0 // downscale
        render = self.render_training_view(img_idx, spp=spp,
                                           width=w, height=h)
        gt_raw = np.asarray(self.data.pixels[img_idx])[:h0, :w0]
        if gt_raw.dtype == np.uint8:
            gt_srgb = gt_raw[..., :3].astype(np.float32) / 255.0
            gt_alpha = gt_raw[..., 3:4].astype(np.float32) / 255.0
            gt_srgb = gt_srgb * gt_alpha  # premultiplied black-bg composite
        else:
            gt_srgb = linear_to_srgb(np.asarray(gt_raw[..., :3], np.float32))
            gt_alpha = np.asarray(gt_raw[..., 3:4], np.float32)
        if downscale != 1:
            # area-average, not decimation: rendered pixel i spans source
            # block [i*ds, (i+1)*ds) and its ray passes through the block
            # CENTER — decimation would sample source pixel i*ds instead,
            # a (ds-1)/2-pixel misalignment that reads as blur
            ds = downscale
            gt_srgb = gt_srgb[:h * ds, :w * ds] \
                .reshape(h, ds, w, ds, 3).mean(axis=(1, 3))
        # model color space: sRGB training → rendered values are sRGB
        pred = np.clip(render[..., :3], 0.0, 1.0)
        mse = float(np.mean((pred - gt_srgb) ** 2))
        return -10.0 * math.log10(max(mse, 1e-20))

    # ------------------------------------------------------------------
    # mesh extraction (testbed_nerf.cu:3026-3138 grid sampling + MC)
    # ------------------------------------------------------------------
    def density_on_grid(self, resolution: int = 128,
                        aabb=None) -> np.ndarray:
        """Raw (pre-activation) density MLP output on a regular grid, with
        cells whose occupancy-grid density is below threshold forced to
        -10000 (grid_samples_half_to_float, testbed_nerf.cu:239-251)."""
        from ..common import NERF_MIN_OPTICAL_THICKNESS
        from .march import cascaded_grid_at, mip_from_pos, warp_position

        aabb_min = np.asarray(aabb[0] if aabb else self.scene.aabb_min)
        aabb_max = np.asarray(aabb[1] if aabb else self.scene.aabb_max)
        params = self.inference_params()
        rx, ry, rz = ((resolution,) * 3 if np.isscalar(resolution)
                      else tuple(int(v) for v in resolution))
        lin = np.linspace(0, 1, rx, dtype=np.float32)
        liny = np.linspace(0, 1, ry, dtype=np.float32)
        linz = np.linspace(0, 1, rz, dtype=np.float32)
        out = np.empty((rx, ry, rz), np.float32)

        @jax.jit
        def density_fn(pos_world):
            warped = warp_position(pos_world,
                                   jnp.asarray(self.scene.aabb_min),
                                   jnp.asarray(self.scene.aabb_max))
            raw = self.model.density(params, warped)
            grid_d = cascaded_grid_at(
                pos_world, self.density_grid,
                mip_from_pos(pos_world, self.scene.max_cascade))
            return jnp.where(grid_d < NERF_MIN_OPTICAL_THICKNESS,
                             -10000.0, raw)

        for ix in range(rx):
            plane = np.stack(np.meshgrid(lin[ix:ix + 1], liny, linz,
                                         indexing="ij"), -1
                             ).reshape(-1, 3)
            pos = plane * (aabb_max - aabb_min) + aabb_min
            out[ix] = np.asarray(density_fn(jnp.asarray(pos))).reshape(
                ry, rz)
        return out

    def compute_and_save_png_slices(self, filename: str,
                                    resolution: int = 256, aabb=None,
                                    thresh: Optional[float] = None,
                                    density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False):
        """Write the raw-density slice-atlas PNG next to `filename`
        (compute_and_save_png_slices, testbed.cu:534-558; atlas layout
        save_density_grid_to_png, marching_cubes.cu:957-1034). Returns
        the per-axis grid resolution baked into the file name."""
        from ..geom.marching import (marching_cubes_res,
                                     save_density_slices_png)

        aabb_min = np.asarray(aabb[0] if aabb else self.scene.aabb_min)
        aabb_max = np.asarray(aabb[1] if aabb else self.scene.aabb_max)
        if thresh is None:
            thresh = 2.5          # m_mesh.thresh default (testbed.h)
        res3d = marching_cubes_res(resolution, aabb_min, aabb_max)
        field = self.density_on_grid(res3d, aabb=(aabb_min, aabb_max))
        out = (f"{filename}.density_slices_"
               f"{res3d[0]}x{res3d[1]}x{res3d[2]}.png")
        save_density_slices_png(out, field, float(thresh), density_range,
                                flip_y_and_z_axes)
        return res3d

    def compute_marching_cubes_mesh(self, resolution: int = 128,
                                    thresh: float = 2.5, aabb=None):
        """Extract (verts, faces, colors) from the density field
        (marching_cubes, testbed_nerf.cu:3139; colors via the RGB head
        with the surface normal as view direction)."""
        from ..geom.marching import marching_tetrahedra, vertex_normals
        from ..geom.marching_cubes import marching_cubes
        from .march import warp_direction, warp_position

        aabb_min = np.asarray(aabb[0] if aabb else self.scene.aabb_min)
        aabb_max = np.asarray(aabb[1] if aabb else self.scene.aabb_max)
        field = self.density_on_grid(resolution, aabb=(aabb_min, aabb_max))
        spacing = (aabb_max - aabb_min) / max(resolution - 1, 1)
        if getattr(self, "mesh_algorithm", "mc") == "tets":
            verts, faces = marching_tetrahedra(
                field, iso=thresh, origin=aabb_min, spacing=spacing)
        else:
            # classic MC (generated table): inside = density > thresh,
            # hence the sign flip (marching_cubes's inside is < iso)
            verts, faces = marching_cubes(-field, iso=-thresh,
                                          origin=aabb_min, spacing=spacing)
        if len(verts) == 0:
            return verts, faces, np.zeros((0, 3), np.float32)
        normals = vertex_normals(verts, faces)
        params = self.inference_params()
        warped_v = np.asarray(warp_position(
            jnp.asarray(verts), jnp.asarray(self.scene.aabb_min),
            jnp.asarray(self.scene.aabb_max)))
        raw = self.model.apply(params, jnp.asarray(warped_v),
                               jnp.asarray(warp_direction(-normals)))
        from .model import network_to_rgb

        colors = np.asarray(network_to_rgb(raw[..., :3],
                                           self.scene.rgb_activation))
        return verts, faces, colors

    # ------------------------------------------------------------------
    def inference_params(self):
        return self.optimizer.inference_params(self.state["opt"],
                                               self.state["params"])

    def save_snapshot(self, path: str) -> None:
        """Snapshot with embedded config + per-image camera state
        (save_snapshot, testbed.cu:4775-4839 incl. :4793-4795)."""
        from ..data.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": self.mode.value,
            "config": self.config,
            "grid_layout": getattr(self.model.pos_encoding, "layout",
                                   "planar"),
            "trainer": self.state,
            "density_grid": self.density_grid,
            "training_step": self.training_step,
            "density_grid_ema_step": self.density_grid_ema_step,
            "aabb_scale": self.scene.aabb_scale,
            "dataset_paths": list(self.dataset.paths),
            "camera": {
                "pos_offset": self.cam_pos_offset,
                "rot_offset": self.cam_rot_offset,
                "focal_offset": self.cam_focal_offset,
                "exposures": self.data.exposures,
            },
            # trained per-image latents (reference saves the per-image
            # optimizer states, testbed.cu:4793-4795)
            "extra_dims": (None if self._extra_dims_buf is None
                           else self._extra_dims_buf.state),
            "envmap": self.envmap.state["params"],
            "distortion_map": self.distortion_map.state["params"],
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        state = jax.tree_util.tree_map(jnp.asarray, snapshot["trainer"])
        enc = self.model.pos_encoding
        if hasattr(enc, "convert_state_layout"):
            # planar-era snapshots permute into the current layout
            state = enc.convert_state_layout(
                state, snapshot.get("grid_layout", "planar"))
        self.state = state
        self.density_grid = jnp.asarray(snapshot["density_grid"])
        self.training_step = int(snapshot.get("training_step", 0))
        self.density_grid_ema_step = int(
            snapshot.get("density_grid_ema_step", 0))
        self.bitfield = update_bitfield(self.density_grid,
                                        self.scene.max_cascade)
        self.mean_density = density_grid_mean(self.density_grid)
        cam = snapshot.get("camera")
        # per-image state restores only for the same dataset
        # (dataset-identity gate, testbed.cu:4945-4951)
        if cam is not None and snapshot.get("dataset_paths") == \
                list(self.dataset.paths):
            self.cam_pos_offset = np.asarray(cam["pos_offset"], np.float32)
            self.cam_rot_offset = np.asarray(cam["rot_offset"], np.float32)
            self.cam_focal_offset = np.asarray(cam["focal_offset"],
                                               np.float32)
            self.data.exposures = jnp.asarray(cam["exposures"])
            extra = snapshot.get("extra_dims")
            if extra is not None and self._extra_dims_buf is not None:
                self._extra_dims_buf.state = jax.tree_util.tree_map(
                    jnp.asarray, extra)
                self.data.extra_dims = self._extra_dims_buf.params
        if "envmap" in snapshot:
            self.envmap.state["params"] = jnp.asarray(snapshot["envmap"])
        if "distortion_map" in snapshot:
            self.distortion_map.state["params"] = jnp.asarray(
                snapshot["distortion_map"])
