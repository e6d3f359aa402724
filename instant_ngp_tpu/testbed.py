"""Testbed facade: the pyngp-compatible top-level API.

Mirrors the reference's `Testbed` orchestrator and its pybind surface
(src/testbed.cu:318-390 load_file dispatch; src/python_api.cu:266-446):
`load_file` / `load_training_data` infer the mode from the path
(mode_from_scene, common_host.cu:146-191), `frame()` advances training,
`render()` produces frames, snapshots round-trip with the config embedded.

Each mode delegates to its testbed implementation (image/, nerf/, sdf/,
volume/, geometry/); this class holds the shared surface so scripts and
the CLI (scripts/run.py) are mode-agnostic, like the reference GUI/CLI.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .common import TestbedMode
from .config import find_network_config, load_network_config, loads_json


def mode_from_scene(path: str) -> TestbedMode:
    """Infer testbed mode from a scene path (common_host.cu:146-191)."""
    if os.path.isdir(path) or path.endswith("transforms.json"):
        return TestbedMode.Nerf
    ext = os.path.splitext(path)[1].lower()
    if ext in (".obj", ".stl"):
        return TestbedMode.Sdf
    if ext in (".exr", ".png", ".jpg", ".jpeg", ".bmp", ".tga", ".bin"):
        return TestbedMode.Image
    if ext in (".nvdb", ".npy"):
        return TestbedMode.Volume
    if ext == ".json":
        try:
            with open(path) as f:
                data = loads_json(f.read())
        except (OSError, ValueError):
            return TestbedMode.NONE
        if isinstance(data, dict):
            if any("geometry" in k for k in data):
                return TestbedMode.Geometry
            if "frames" in data:
                return TestbedMode.Nerf
    return TestbedMode.NONE


class Testbed:
    def __init__(self, mode: TestbedMode = TestbedMode.NONE,
                 seed: int = 1337):
        self.mode = mode
        self.seed = seed
        self.impl = None
        self.network_config: Optional[Dict[str, Any]] = None
        self.network_config_path: Optional[str] = None
        self.data_path: Optional[str] = None
        self.shall_train = True
        self.background_color = np.array([1.0, 1.0, 1.0, 1.0], np.float32)
        self.training_batch_size = 1 << 18  # testbed.h:1015

    # -- loading --------------------------------------------------------
    def load_file(self, path: str) -> None:
        """Dispatch on file type (load_file, testbed.cu:318-390)."""
        path = str(path)
        if path.endswith((".ingp", ".msgpack")):
            self.load_snapshot(path)
            return
        mode = mode_from_scene(path)
        if mode == TestbedMode.NONE and path.endswith(".json"):
            self.reload_network_from_file(path)
            return
        self.load_training_data(path)

    def load_training_data(self, path: str) -> None:
        path = str(path)
        self.mode = mode_from_scene(path)
        if self.mode == TestbedMode.NONE:
            raise ValueError(f"cannot infer testbed mode from {path!r}")
        self.data_path = path
        self._maybe_create_impl()

    def reload_network_from_file(self, path: str = "") -> None:
        if path:
            path = find_network_config(
                path, mode=self.mode.value if self.mode else None)
            self.network_config_path = path
        if self.network_config_path:
            self.network_config = load_network_config(
                self.network_config_path)
        self._maybe_create_impl(reset=True)

    def reload_network_from_json(self, config: Dict[str, Any]) -> None:
        self.network_config = config
        self._maybe_create_impl(reset=True)

    def _default_config(self) -> Dict[str, Any]:
        return load_network_config(
            find_network_config("base.json", mode=self.mode.value))

    def _maybe_create_impl(self, reset: bool = False) -> None:
        if self.data_path is None or self.mode == TestbedMode.NONE:
            return
        if self.impl is not None and not reset:
            return
        if self.network_config is None:
            self.network_config = self._default_config()

        if self.mode == TestbedMode.Image:
            from .data.images import read_image
            from .image import ImageTestbed

            self.impl = ImageTestbed(read_image(self.data_path),
                                     self.network_config, seed=self.seed)
        elif self.mode == TestbedMode.Nerf:
            from .data.nerf_loader import load_nerf
            from .nerf.testbed_nerf import NerfTestbed

            p = self.data_path
            if os.path.isdir(p):
                p = os.path.join(p, "transforms.json")
            self.impl = NerfTestbed(load_nerf(p), self.network_config,
                                    seed=self.seed)
        elif self.mode == TestbedMode.Sdf:
            from .sdf import SdfTestbed

            self.impl = SdfTestbed(self.data_path, self.network_config,
                                   seed=self.seed)
        elif self.mode == TestbedMode.Volume:
            import numpy as _np

            from .volume import VolumeTestbed

            from .volume.testbed_volume import load_volume_grid

            grid = load_volume_grid(self.data_path)
            self.impl = VolumeTestbed(grid, self.network_config,
                                      seed=self.seed)
        elif self.mode == TestbedMode.Geometry:
            from .geometry import GeometryTestbed

            self.impl = GeometryTestbed(self.data_path, self.network_config,
                                        seed=self.seed)
        else:
            raise ValueError(f"unsupported mode {self.mode}")

    # -- training / rendering ------------------------------------------
    @property
    def training_step(self) -> int:
        return self.impl.training_step if self.impl else 0

    @property
    def loss(self) -> float:
        return self.impl.loss_scalar if self.impl else float("nan")

    def train_stats(self) -> dict:
        """Throughput/observability counters (the reference GUI's
        rays/s, samples/s, steps-per-ray and per-phase ms meters —
        testbed.h:936-940 Ema timers + derived counters; SURVEY.md §5)."""
        if self.impl is not None and hasattr(self.impl,
                                             "performance_stats"):
            return self.impl.performance_stats()
        return {}

    def profile_trace(self, logdir: str):
        """Context manager: capture a jax.profiler device trace (XLA ops,
        HBM traffic, fusion boundaries) for everything run inside it.
        View with TensorBoard or Perfetto. The reference's analog is its
        Ema wall-clock meters (testbed.h:936-940); here the device
        trace is the authoritative per-phase profile (SURVEY.md §5)."""
        import jax

        return jax.profiler.trace(logdir)

    def frame(self) -> bool:
        """Headless heartbeat: one training step when training is on, and
        — when `shall_render` is set — one rendered frame at a resolution
        chosen by the dynamic-resolution controller (reference frame()
        interleaves train+render with the render-time-EMA-driven resize,
        testbed.cu:2884-2924). The latest frame lands in `last_frame`."""
        if self.impl is None:
            return False
        if self.shall_train:
            self.train(1)
        if getattr(self, "shall_render", False):
            import time as _time

            from .render_buffer import DynamicResolution
            from .utils import Ema

            if getattr(self, "_dynres", None) is None:
                self._dynres = DynamicResolution(
                    self.full_resolution, self.dynamic_res_target_fps)
                self._render_ms = Ema(half_life_s=1.0)
            w, h = self._dynres.update(self._render_ms.value)
            t0 = _time.perf_counter()
            self.last_frame = self.render(w, h)
            self._render_ms.update((_time.perf_counter() - t0) * 1e3)
        return True

    # dynamic-resolution render heartbeat knobs (m_dynamic_res /
    # m_dynamic_res_target_fps defaults, testbed.h)
    shall_render = False
    full_resolution = (1920, 1080)
    dynamic_res_target_fps = 30.0
    last_frame = None

    def train(self, n_steps: int = 1) -> float:
        if self.mode == TestbedMode.Nerf:
            return self.impl.train(n_steps)
        return self.impl.train(n_steps, batch_size=self.training_batch_size)

    def render(self, width: int, height: int, spp: int = 1,
               linear: bool = True, camera_matrix=None) -> np.ndarray:
        """Render to a (H, W, 4) float array (render_to_cpu equivalent)."""
        if self.mode == TestbedMode.Image:
            img = self.impl.render(width, height)
        elif self.mode == TestbedMode.Nerf:
            if camera_matrix is None:
                camera_matrix = np.asarray(self.impl.data.xforms_start[0])
            img = self.impl.render_frame(
                width, height, camera_matrix, spp=spp,
                background_color=self.background_color[:3])
        elif self.mode in (TestbedMode.Sdf, TestbedMode.Geometry,
                           TestbedMode.Volume):
            if camera_matrix is None:
                camera_matrix = np.array(
                    [[1, 0, 0, 0.5], [0, -1, 0, 0.5], [0, 0, -1, 2.5]],
                    np.float32)
            img = self.impl.render_frame(width, height, camera_matrix)
        else:
            raise ValueError("no scene loaded")
        if not linear:
            from .common import linear_to_srgb

            img = img.copy()
            img[..., :3] = linear_to_srgb(np.maximum(img[..., :3], 0.0))
        return img

    # -- mode-specific passthroughs (pyngp surface) ---------------------
    def calculate_iou(self, n_samples: int = 128 * 128 * 128,
                      scale_existing_results_factor: float = 0.0,
                      blocking: bool = True, force_use_octree: bool = True
                      ) -> float:
        """SDF IoU metric (python_api.cu:438)."""
        return self.impl.calculate_iou(n_samples)

    def compute_marching_cubes_mesh(self, resolution: int = 128,
                                    thresh: float = 2.5):
        """(verts, faces, colors) from the NeRF density field."""
        return self.impl.compute_marching_cubes_mesh(resolution, thresh)

    def compute_and_save_png_slices(self, filename: str,
                                    resolution: int = 256, aabb=None,
                                    thresh=None, density_range: float = 4.0,
                                    flip_y_and_z_axes: bool = False):
        """Slice-atlas PNG of the density/SDF field written next to
        `filename` (compute_and_save_png_slices, testbed.cu:534-558,
        bound in python_api.cu:451). Returns the (x, y, z) grid
        resolution encoded in the output file name."""
        return self.impl.compute_and_save_png_slices(
            filename, resolution=resolution, aabb=aabb, thresh=thresh,
            density_range=density_range,
            flip_y_and_z_axes=flip_y_and_z_axes)

    def save_mesh(self, path: str, resolution: int = 128,
                  thresh: float = 2.5) -> None:
        from .geom.marching import save_mesh, vertex_normals

        verts, faces, colors = self.compute_marching_cubes_mesh(
            resolution, thresh)
        save_mesh(path, verts, faces, colors=colors,
                  normals=vertex_normals(verts, faces) if len(verts)
                  else None)

    def screenshot(self, path: str, width: int = 1920, height: int = 1080,
                   spp: int = 16) -> None:
        from .data.images import write_image

        img = self.render(width, height, spp=spp)
        write_image(path, img.astype("float32"))

    def override_sdf_training_data(self, positions, distances) -> None:
        self.impl.override_training_data(positions, distances)

    @property
    def nerf(self):
        """Nested attribute access compatibility (testbed.nerf.training...)"""
        return self.impl

    # -- snapshots ------------------------------------------------------
    def save_snapshot(self, path: str,
                      serialize_optimizer: bool = True) -> None:
        self.impl.save_snapshot(path)

    def load_snapshot(self, path: str) -> None:
        from .data.snapshot import load_snapshot

        snap = load_snapshot(path)
        self.mode = TestbedMode(snap.get("mode", "none"))
        self.network_config = snap.get("config")
        if self.mode == TestbedMode.Geometry and self.impl is None:
            # geometry snapshots are self-contained (objects embedded)
            from .geometry.testbed_geometry import GeometryTestbed

            self.impl = GeometryTestbed.from_snapshot(snap)
            return
        if self.impl is None and self.data_path:
            self._maybe_create_impl(reset=True)
        if self.impl is not None:
            self.impl.load_snapshot_state(snap)
        else:
            self._pending_snapshot = snap

    def apply_pending_snapshot(self) -> None:
        if getattr(self, "_pending_snapshot", None) is not None \
                and self.impl is not None:
            self.impl.load_snapshot_state(self._pending_snapshot)
            self._pending_snapshot = None
