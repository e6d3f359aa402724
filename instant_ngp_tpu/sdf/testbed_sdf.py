"""SDF mode: fit a neural SDF to a mesh, render by sphere tracing.

Re-implements src/testbed_sdf.cu (1400 LoC):
- training samples: 4/8 exactly on the surface (area-weighted triangle
  sampling, distance 0), 3/8 surface + logistic perturbation with
  stddev = bounding_radius/1024 * surface_offset_scale, 1/8 uniform in
  the (optionally inflated) aabb; labels from the BVH's signed distance
  (generate_training_samples_sdf :1186-1274);
- training: shuffled samples through the standard trainer, MAPE loss
  (train_sdf :1323-1346; configs/sdf/base.json);
- rendering: vectorized sphere tracing with the reference's stop rule
  (advance_pos_kernel_sdf :147-217: advance by (d - zero_offset) *
  distance_scale, die when |step| <= maximum_distance-ish), normals by
  autodiff input gradient or central finite differences
  (FiniteDifferenceNormalsApproximator :826-880), Disney BRDF shading;
- ground-truth modes: BVH raytrace / BVH-SDF sphere trace (oracles);
- IoU metric: MC sign agreement vs the BVH (calculate_iou :1363-1399).

Design: labels are produced by the native C++ BVH on the host (the
one irregular workload here), everything else is jitted; the sphere
tracer is a fixed-trip masked loop over full ray batches (lanes die by
mask; no per-iteration host compaction).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..common import TestbedMode
from ..geom.triangle_bvh import (TriangleBvh, load_obj,
                                 normalize_mesh_to_unit_cube)
from ..ops.factory import create_network_with_encoding
from ..ops.losses import create_loss
from ..ops.optimizers import create_optimizer
from ..ops.trainer import Trainer
from .brdf import BRDFParams, evaluate_shading


class SdfTestbed:
    mode = TestbedMode.Sdf

    def __init__(self, mesh_or_path, network_config: Dict[str, Any],
                 seed: int = 1337, compute_dtype=jnp.bfloat16):
        if isinstance(mesh_or_path, str):
            triangles = load_obj(mesh_or_path)
        else:
            triangles = np.asarray(mesh_or_path, np.float32)
        self.triangles, self.mesh_scale, self.mesh_offset = \
            normalize_mesh_to_unit_cube(triangles)
        self.bvh = TriangleBvh(self.triangles)

        # area-weighted triangle CDF for surface sampling
        a, b, c = (self.triangles[:, 0], self.triangles[:, 1],
                   self.triangles[:, 2])
        areas = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=-1)
        cdf = np.cumsum(areas)
        self.triangle_cdf = (cdf / cdf[-1]).astype(np.float64)

        center = self.triangles.reshape(-1, 3).mean(0)
        self.bounding_radius = float(np.linalg.norm(
            self.triangles.reshape(-1, 3) - center, axis=-1).max())

        self.config = network_config
        enc_cfg = network_config.get("encoding", {})
        if "stochastic_corners_until" in enc_cfg:
            self.stochastic_corners_until = \
                enc_cfg["stochastic_corners_until"]
        self.triangle_octree = None
        if enc_cfg.get("otype") == "Takikawa":
            # octree-feature encoding over the mesh surface
            # (reset_network Takikawa branch, testbed.cu:3805-3824)
            from ..geom.triangle_octree import TriangleOctree
            from ..ops.mlp import MLP
            from ..ops.takikawa import TakikawaEncoding
            from ..ops.mlp import NetworkWithInputEncoding

            depth = int(enc_cfg.get("n_levels", 8))
            self.triangle_octree = TriangleOctree(self.triangles, depth)
            encoding = TakikawaEncoding(
                self.triangle_octree,
                starting_level=int(enc_cfg.get("starting_level", 4)),
                sum_instead_of_concat=bool(
                    enc_cfg.get("sum_instead_of_concat", False)))
            net = MLP.from_config(encoding.n_output_dims, 1,
                                  network_config.get("network", {}),
                                  compute_dtype=compute_dtype)
            self.model = NetworkWithInputEncoding(encoding, net)
            self.resolved_config = network_config
        else:
            self.model, self.resolved_config = create_network_with_encoding(
                3, 1, network_config, desired_resolution=2048.0,
                compute_dtype=compute_dtype)
        self.optimizer = create_optimizer(network_config["optimizer"])
        self.loss_fn = create_loss(network_config.get("loss",
                                                      {"otype": "MAPE"}))
        self.trainer = Trainer(self.model, self.optimizer, self.loss_fn,
                               seed=seed)
        self.state = self.trainer.init_state()
        self.training_step = 0
        self.seed = seed
        self.loss_scalar = float("nan")

        # reference defaults (testbed.h:789-858)
        self.zero_offset = 0.0
        self.distance_scale = 0.95
        self.maximum_distance = 5e-5
        self.surface_offset_scale = 1.0
        self.mesh_sdf_mode = "Raystab"
        self.shadow_sharpness = 16.0  # testbed.h SphereTracer shadow k
        self.render_with_shadows = False
        # GT render oracle (ESDFGroundTruthMode, common.h:146-150):
        # RaytracedMesh | SpheretracedMesh | SDFBricks
        self.groundtruth_mode = "RaytracedMesh"
        self.brick_res = 5          # testbed.cu:4392
        self.brick_level = 10       # testbed.h:816
        self._bricks = None
        self.brdf = BRDFParams()
        self.aabb_min = np.zeros(3, np.float32)
        self.aabb_max = np.ones(3, np.float32)

        self._np_rng = np.random.RandomState(seed)

    # ------------------------------------------------------------------
    # training data (generate_training_samples_sdf)
    # ------------------------------------------------------------------
    def sample_surface(self, n: int) -> np.ndarray:
        """Uniform area-weighted points on the mesh surface."""
        tri_idx = np.searchsorted(self.triangle_cdf,
                                  self._np_rng.rand(n))
        tri_idx = np.minimum(tri_idx, len(self.triangles) - 1)
        t = self.triangles[tri_idx]
        u = self._np_rng.rand(n, 1).astype(np.float32)
        v = self._np_rng.rand(n, 1).astype(np.float32)
        flip = (u + v) > 1
        u = np.where(flip, 1 - u, u)
        v = np.where(flip, 1 - v, v)
        return t[:, 0] + u * (t[:, 1] - t[:, 0]) + v * (t[:, 2] - t[:, 0])

    def generate_training_samples(self, n: int, uniform_only: bool = False
                                  ) -> Tuple[np.ndarray, np.ndarray]:
        """(positions (n,3), signed distances (n,)); reference 4/8-3/8-1/8
        mix with logistic perturbations."""
        if uniform_only:
            pos = self._np_rng.rand(n, 3).astype(np.float32) \
                * (self.aabb_max - self.aabb_min) + self.aabb_min
            d = self.bvh.signed_distance(pos, self.mesh_sdf_mode,
                                         tuple(self._np_rng.rand(2)))
            return pos, d

        n_base = n // 8
        n_exact = n_base * 4
        n_offset = n_base * 3
        n_uniform = n - n_exact - n_offset

        surf = self.sample_surface(n_exact + n_offset).astype(np.float32)
        exact = surf[:n_exact]
        stddev = self.bounding_radius / 1024.0 * self.surface_offset_scale
        # logistic-distributed perturbation (generate_random_logistic)
        u = np.clip(self._np_rng.rand(n_offset, 3), 1e-7, 1 - 1e-7)
        perturb = (stddev * np.log(u / (1 - u))).astype(np.float32)
        offset = surf[n_exact:] + perturb
        uniform = self._np_rng.rand(n_uniform, 3).astype(np.float32) \
            * (self.aabb_max - self.aabb_min) + self.aabb_min

        labeled = np.concatenate([offset, uniform])
        d = self.bvh.signed_distance(labeled, self.mesh_sdf_mode,
                                     tuple(self._np_rng.rand(2)))
        positions = np.concatenate([exact, labeled])
        distances = np.concatenate([np.zeros(n_exact, np.float32), d])
        return positions, distances

    # training-data injection point (override_sdf_training_data,
    # testbed.h:608 — used by parity tests)
    _override_data: Optional[Tuple[np.ndarray, np.ndarray]] = None

    def override_training_data(self, positions: np.ndarray,
                               distances: np.ndarray) -> None:
        self._override_data = (np.asarray(positions, np.float32),
                               np.asarray(distances, np.float32))

    # ------------------------------------------------------------------
    # stochastic-corner grid encoding during training (unbiased, 2^d
    # fewer table gathers and scatter-adds; no-op for octree configs).
    # SDF fitting is a precision regression like image mode, so the
    # coarse-to-fine schedule switches to the exact d-linear encode
    # after stochastic_corners_until steps (None = never; armadillo IoU
    # 0.155 all-stochastic vs 0.296 scheduled —
    # walkthrough_out/variance_schedule_ab.json). __init__ overrides
    # from the config zoo (configs/sdf/base.json).
    stochastic_corners = True
    stochastic_corners_until = 256

    def _stoch_now(self) -> bool:
        if not self.stochastic_corners:
            return False
        until = getattr(self, "stochastic_corners_until", None)
        return until is None or self.training_step < until

    def train(self, n_steps: int, batch_size: int = 1 << 18) -> float:
        for _ in range(n_steps):
            if self._override_data is not None:
                pos, dist = self._override_data
                perm = self._np_rng.permutation(len(pos))[:batch_size]
                pos, dist = pos[perm], dist[perm]
            else:
                pos, dist = self.generate_training_samples(batch_size)
            enc_key = jax.random.fold_in(
                jax.random.PRNGKey(self.seed ^ 0x5C), self.training_step) \
                if self._stoch_now() else None
            self.state, loss = self.trainer.training_step(
                self.state, jnp.asarray(pos), jnp.asarray(dist)[:, None],
                encode_rng=enc_key)
            self.training_step += 1
        self.loss_scalar = float(loss)
        return self.loss_scalar

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------
    def distance(self, params, pos: jax.Array) -> jax.Array:
        return self.model.apply(params, pos)[..., 0]

    @partial(jax.jit, static_argnums=(0, 4, 5))
    def _sphere_trace(self, params, origins, dirs, n_iters: int = 96,
                      use_gt: bool = False):
        """Vectorized sphere tracing; masked lanes, fixed trip count."""
        aabb_min = jnp.asarray(self.aabb_min)
        aabb_max = jnp.asarray(self.aabb_max)

        from ..nerf.march import aabb_contains, ray_intersect_aabb

        tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
        tmin = jnp.maximum(tmin, 0.0)
        alive0 = tmax >= tmin
        pos0 = origins + (tmin[:, None] + 1e-4) * dirs

        def body(carry, _):
            pos, alive, hit = carry
            raw = (self._bricks.distance(pos) if use_gt
                   else self.distance(params, pos))
            d = raw - self.zero_offset
            step = d * self.distance_scale
            new_pos = pos + step[:, None] * dirs
            inside = aabb_contains(new_pos, aabb_min, aabb_max)
            # stop rule (advance_pos_kernel_sdf :207): converged when the
            # step is no longer meaningfully larger than max distance
            converged = ~((step > self.maximum_distance)
                          & (jnp.abs(step / 2) > 3 * self.maximum_distance))
            new_hit = hit | (alive & converged)
            new_alive = alive & ~converged & inside
            pos = jnp.where(alive[:, None], new_pos, pos)
            return (pos, new_alive, new_hit), None

        (pos, alive, hit), _ = jax.lax.scan(
            body, (pos0, alive0, jnp.zeros_like(alive0)), None,
            length=n_iters)
        return pos, hit

    @partial(jax.jit, static_argnums=(0, 4))
    def _shadow_trace(self, params, origins, light_dir, n_iters: int = 64):
        """Soft-shadow visibility along rays toward the light.

        Mirrors the reference's shadow pass (prepare_shadow_rays
        testbed_sdf.cu:231, min_visibility tracking in
        advance_pos_kernel_sdf :196-203, Inigo Quilez's soft-shadow
        estimator): v = min over the march of k*d / max(t - y, 0)."""
        aabb_min = jnp.asarray(self.aabb_min)
        aabb_max = jnp.asarray(self.aabb_max)
        from ..nerf.march import aabb_contains

        k = self.shadow_sharpness
        dirs = jnp.broadcast_to(light_dir, origins.shape)

        def body(carry, _):
            pos, t_total, prev_d, min_vis, alive = carry
            d = self.distance(params, pos) - self.zero_offset
            step = jnp.maximum(d * self.distance_scale, 0.0)
            y = step * step / jnp.maximum(2.0 * prev_d, 1e-9)
            dd = jnp.sqrt(jnp.maximum(step * step - y * y, 0.0))
            vis = k * dd / jnp.maximum(t_total - y, 1e-9)
            min_vis = jnp.where(alive & (t_total > 0),
                                jnp.minimum(min_vis, vis), min_vis)
            hit = d < self.maximum_distance * 4
            new_pos = pos + (step + 1e-4)[:, None] * dirs
            inside = aabb_contains(new_pos, aabb_min, aabb_max)
            pos = jnp.where(alive[:, None], new_pos, pos)
            t_total = jnp.where(alive, t_total + step + 1e-4, t_total)
            min_vis = jnp.where(alive & hit, 0.0, min_vis)
            alive = alive & inside & ~hit
            return (pos, t_total, jnp.maximum(step, 1e-9), min_vis,
                    alive), None

        n = origins.shape[0]
        start = origins + 2e-3 * dirs
        init = (start, jnp.zeros(n), jnp.full(n, 1e10), jnp.ones(n),
                jnp.ones(n, bool))
        (pos, t, pd, min_vis, alive), _ = jax.lax.scan(body, init, None,
                                                       length=n_iters)
        return jnp.clip(min_vis, 0.0, 1.0)

    def _ensure_bricks(self):
        """Lazily build the SDF brick cache (testbed.cu:4390-4406)."""
        if self._bricks is None:
            from ..geom.triangle_octree import TriangleOctree
            from .bricks import SdfBricks

            octree = self.triangle_octree
            if octree is None or octree.depth - 1 > self.brick_level:
                octree = TriangleOctree(
                    self.triangles, min(self.brick_level + 1, 7))
            self._bricks = SdfBricks(octree, self.bvh,
                                     brick_res=self.brick_res,
                                     brick_level=self.brick_level)

    def _brick_normals(self, pos: jax.Array, eps: float) -> jax.Array:
        """Central differences on the brick SDF, taps one voxel apart
        (brick_smooth_normals, testbed_sdf.cu:980-981)."""
        offs = jnp.eye(3) * eps
        g = jnp.stack([self._bricks.distance(pos + offs[i])
                       - self._bricks.distance(pos - offs[i])
                       for i in range(3)], -1)
        return g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True),
                               1e-9)

    def normals(self, params, pos: jax.Array,
                finite_differences: bool = False,
                eps: float = 1e-3) -> jax.Array:
        if finite_differences:
            offs = jnp.eye(3) * eps
            d_plus = jnp.stack([self.distance(params, pos + offs[i])
                                for i in range(3)], -1)
            d_minus = jnp.stack([self.distance(params, pos - offs[i])
                                 for i in range(3)], -1)
            g = (d_plus - d_minus) / (2 * eps)
        else:
            g = jax.grad(lambda p: jnp.sum(self.distance(params, p)))(pos)
        return g / jnp.maximum(jnp.linalg.norm(g, axis=-1, keepdims=True),
                               1e-9)

    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length: float = None, render_mode: str = "Shade",
                     light_dir=(0.577, -0.577, 0.577),
                     background_color=(1.0, 1.0, 1.0),
                     use_gt: bool = False) -> np.ndarray:
        """Sphere-traced frame (H, W, 4) linear float32."""
        from ..nerf.render import camera_rays_for_frame

        fl = focal_length or width * 1.1
        origins, dirs = camera_rays_for_frame(
            width, height, (fl, fl), np.asarray(camera_matrix, np.float32))

        if use_gt and self.groundtruth_mode == "SDFBricks":
            # sphere trace the brick-cached GT SDF (the mode the
            # reference builds at testbed.cu:4388 but never samples)
            self._ensure_bricks()
            pos_j, hit_j = self._sphere_trace(None, origins, dirs, 96,
                                              True)
            eps = (2.0 ** -(self._bricks.level + 1)) \
                / (self.brick_res - 1)  # one brick voxel (:981)
            n_j = self._brick_normals(pos_j, eps)
        elif use_gt and self.groundtruth_mode == "SpheretracedMesh":
            # iterative host loop against the exact BVH signed distance
            pos = np.asarray(origins, np.float32).copy()
            dirs_np = np.asarray(dirs, np.float32)
            alive = np.ones(len(pos), bool)
            for _ in range(48):
                d = self.bvh.signed_distance(pos[alive], mode="Watertight")
                pos[alive] += (d * self.distance_scale)[:, None] \
                    * dirs_np[alive]
                alive[alive.nonzero()[0]] = np.abs(d) > 5e-4
                if not alive.any():
                    break
            d_final = self.bvh.signed_distance(pos, mode="Watertight")
            hit = np.abs(d_final) < 5e-3
            eps = 1e-3
            g = np.stack([
                self.bvh.signed_distance(pos + off, mode="Watertight")
                - self.bvh.signed_distance(pos - off, mode="Watertight")
                for off in (np.eye(3, dtype=np.float32) * eps)], -1)
            n = g / np.maximum(np.linalg.norm(g, axis=-1, keepdims=True),
                               1e-9)
            pos_j, hit_j, n_j = (jnp.asarray(pos), jnp.asarray(hit),
                                 jnp.asarray(n))
        elif use_gt:
            t, idx = self.bvh.ray_trace(np.asarray(origins),
                                        np.asarray(dirs))
            hit = idx >= 0
            pos = np.asarray(origins) + t[:, None] * np.asarray(dirs)
            n = np.zeros_like(pos)
            normals_all = self.bvh.triangle_normals()
            n[hit] = normals_all[idx[hit]]
            pos_j, hit_j, n_j = (jnp.asarray(pos), jnp.asarray(hit),
                                 jnp.asarray(n))
        else:
            params = self.trainer.inference_params(self.state)
            pos_j, hit_j = self._sphere_trace(params, origins, dirs)
            n_j = self.normals(params, pos_j)

        if render_mode == "Normals":
            rgb = n_j * 0.5 + 0.5
        elif render_mode == "Depth":
            depth = jnp.linalg.norm(pos_j - origins, axis=-1, keepdims=True)
            rgb = jnp.repeat(depth, 3, -1)
        elif render_mode == "Positions":
            rgb = pos_j
        else:
            L = jnp.asarray(light_dir, jnp.float32)
            L = L / jnp.linalg.norm(L)
            V = -dirs
            rgb = evaluate_shading(
                jnp.asarray(self.brdf.basecolor, jnp.float32),
                jnp.asarray(self.brdf.ambientcolor, jnp.float32),
                jnp.ones(3), self.brdf, L, V, n_j)
            if self.render_with_shadows and not use_gt:
                vis = self._shadow_trace(params, pos_j, L)
                rgb = rgb * vis[:, None]

        bg = jnp.asarray(background_color, jnp.float32)
        rgb = jnp.where(hit_j[:, None], rgb, bg)
        rgba = jnp.concatenate(
            [rgb, hit_j[:, None].astype(jnp.float32)], -1)
        return np.asarray(rgba).reshape(height, width, 4)

    # ------------------------------------------------------------------
    def calculate_iou(self, n_samples: int = 128 * 128 * 128,
                      scale_existing: float = 0.0) -> float:
        """MC intersection-over-union of model vs GT sign
        (calculate_iou, testbed_sdf.cu:1363; compare_signs_kernel :472)."""
        pos, gt_d = self.generate_training_samples(n_samples,
                                                   uniform_only=True)
        params = self.trainer.inference_params(self.state)
        chunk = 1 << 18
        pred_signs = []
        for i in range(0, len(pos), chunk):
            d = self.distance(params, jnp.asarray(pos[i:i + chunk]))
            pred_signs.append(np.asarray(d) < self.zero_offset)
        pred_inside = np.concatenate(pred_signs)
        gt_inside = gt_d < 0
        intersection = np.sum(pred_inside & gt_inside)
        union = np.sum(pred_inside | gt_inside)
        return float(intersection) / max(float(union), 1.0)

    def compute_and_save_png_slices(self, filename: str,
                                    resolution: int = 256, aabb=None,
                                    thresh: Optional[float] = None,
                                    density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False,
                                    ground_truth: bool = False):
        """Signed-distance slice-atlas PNG (SDF branch of
        compute_and_save_png_slices, testbed.cu:534-558): the AABB is
        inflated by `density_range` output voxels, the range rescales to
        voxel units and negates so black = outside, white = inside.
        `ground_truth` samples the mesh BVH instead of the network
        (render_ground_truth branch). Returns the per-axis resolution."""
        from ..geom.marching import (marching_cubes_res,
                                     save_density_slices_png)

        aabb_min = np.asarray(aabb[0] if aabb else self.aabb_min,
                              np.float64).copy()
        aabb_max = np.asarray(aabb[1] if aabb else self.aabb_max,
                              np.float64).copy()
        if thresh is None:
            thresh = 0.0          # SDF-mode m_mesh.thresh (testbed_sdf.cu:1145)
        res3d = marching_cubes_res(resolution, aabb_min, aabb_max)
        inflate = density_range * (aabb_max[0] - aabb_min[0]) / res3d[0]
        aabb_min -= inflate
        aabb_max += inflate
        res3d = marching_cubes_res(resolution, aabb_min, aabb_max)
        rng = -density_range * (aabb_max[0] - aabb_min[0]) / res3d[0]

        params = self.trainer.inference_params(self.state)
        lins = [np.linspace(lo, hi, r, dtype=np.float32)
                for lo, hi, r in zip(aabb_min, aabb_max, res3d)]
        field = np.empty(res3d, np.float32)
        for ix in range(res3d[0]):
            pos = np.stack(np.meshgrid(lins[0][ix:ix + 1], lins[1],
                                       lins[2], indexing="ij"),
                           -1).reshape(-1, 3)
            if ground_truth:
                d = self.bvh.signed_distance(pos, self.mesh_sdf_mode)
            else:
                d = np.asarray(self.distance(params, jnp.asarray(pos)))
            field[ix] = d.reshape(res3d[1], res3d[2])
        out = (f"{filename}.density_slices_"
               f"{res3d[0]}x{res3d[1]}x{res3d[2]}.png")
        save_density_slices_png(out, field, float(thresh), rng,
                                flip_y_and_z_axes)
        return res3d

    # ------------------------------------------------------------------
    def save_snapshot(self, path: str) -> None:
        from ..data.snapshot import save_snapshot

        save_snapshot(path, {
            "mode": self.mode.value,
            "config": self.config,
            "grid_layout": getattr(self.model.encoding, "layout", "planar"),
            "trainer": self.state,
            "training_step": self.training_step,
            "mesh_scale": self.mesh_scale,
            "mesh_offset": self.mesh_offset,
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        state = jax.tree_util.tree_map(jnp.asarray, snapshot["trainer"])
        enc = self.model.encoding
        if hasattr(enc, "convert_state_layout"):
            state = enc.convert_state_layout(
                state, snapshot.get("grid_layout", "planar"))
        self.state = state
        self.training_step = int(snapshot.get("training_step", 0))
