"""Geometry mode: render multi-object scenes of meshes and NeRFs.

Re-implements the fork's scene renderer (src/testbed_geometry.cu, 3135
LoC): a scene JSON `{"geometry": [{center, path, type: Mesh|Nerf}]}`
(load_scene :3033-3130) builds two object-level BVHs (meshes + NeRFs);
rendering ray-traces mesh objects through their triangle BVHs with
Disney-BRDF shading (render_geometry_mesh :2156, shade_kernel_mesh
:284) and volume-marches NeRF objects. Training is disabled in this
mode, exactly like the reference (testbed.cu:4026-4030).

Note the reference ships the NeRF branch partially wired (the call is
commented out of render_frame_main, testbed.cu:4503); here mesh and NeRF
objects composite together: mesh hits bound the march distance of NeRF
objects along each ray.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..common import TestbedMode
from ..config import loads_json
from ..geom.triangle_bvh import TriangleBvh, load_obj
from ..sdf.brdf import BRDFParams, evaluate_shading


class MeshObject:
    """Per-object mesh bundle (mesh.h:18-42 MeshData; `scale` mirrors
    MeshData::scale, mesh.h:28 — applied about the mesh's own centroid
    before placement)."""

    def __init__(self, path: str, center, scale: float = 1.0):
        tris = load_obj(path) if path else np.zeros((0, 3, 3), np.float32)
        center = np.asarray(center, np.float32)
        if len(tris) and scale != 1.0:
            centroid = tris.reshape(-1, 3).mean(0)
            tris = (tris - centroid) * float(scale) + centroid
        self.triangles = (tris + center).astype(np.float32)
        self.center = center
        if len(self.triangles):
            flat = self.triangles.reshape(-1, 3)
            self.aabb = (flat.min(0), flat.max(0))
            self.scale = float((self.aabb[1] - self.aabb[0]).max())
            self.bvh = TriangleBvh(self.triangles, leaf_size=8)
        else:
            self.aabb = (np.zeros(3, np.float32), np.zeros(3, np.float32))
            self.scale = 1.0
            self.bvh = None
        self.brdf = BRDFParams()


class NerfObject:
    """A trained NeRF placed in the scene (testbed.h:844-857 reuses the
    Nerf struct per object). Loads one of our snapshots (.ingp/.msgpack)
    whose config is embedded."""

    def __init__(self, path: str, center):
        from ..data.snapshot import load_snapshot

        self.center = np.asarray(center, np.float32)
        self.path = path
        self.testbed = None
        if path.endswith((".ingp", ".msgpack")) and os.path.exists(path):
            snap = load_snapshot(path)
            self._init_model(snap["config"], int(snap.get("aabb_scale", 1)),
                             snap["trainer"]["params"],
                             snap["density_grid"],
                             snap.get("grid_layout", "planar"))
        else:
            self.model = None
            self.params = None
            self.config = None
            self.aabb = (self.center + 0.0, self.center + 1.0)

    def _init_model(self, cfg, aabb_scale: int, params, density_grid,
                    grid_layout: str = "planar"):
        """Rebuild a standalone NeRF model from an embedded config; the
        hash table is converted from the snapshot's `grid_layout`."""
        from ..nerf.model import NerfNetwork

        self.config = cfg
        self.model = NerfNetwork(
            3, 3, 0, cfg["encoding"],
            cfg.get("dir_encoding",
                    {"otype": "SphericalHarmonics", "degree": 4}),
            cfg["network"], cfg.get("rgb_network", cfg["network"]),
            aabb_scale=aabb_scale)
        self.params = jax.tree_util.tree_map(jnp.asarray, params)
        enc = self.model.pos_encoding
        if hasattr(enc, "convert_state_layout"):
            self.params = enc.convert_state_layout(self.params, grid_layout)
        self.density_grid = jnp.asarray(density_grid)
        self.aabb_scale = aabb_scale
        side = min(aabb_scale, 128)
        lo = np.full(3, 0.5 - side / 2, np.float32) + self.center
        hi = np.full(3, 0.5 + side / 2, np.float32) + self.center
        self.aabb = (lo, hi)


class GeometryTestbed:
    mode = TestbedMode.Geometry

    def __init__(self, scene_path: str, network_config=None,
                 seed: int = 1337):
        from .geometry_bvh import GeometryBvh

        with open(scene_path) as f:
            scene = loads_json(f.read())
        base = os.path.dirname(os.path.abspath(scene_path))
        self.meshes: List[MeshObject] = []
        self.nerfs: List[NerfObject] = []
        for g in scene.get("geometry", []):
            path = g.get("path", "")
            if path and not os.path.isabs(path):
                path = os.path.join(base, path)
            elif path and not os.path.exists(path):
                # reference scene files embed absolute author paths; fall
                # back to resolving the basename next to the scene JSON
                cand = os.path.join(base, "objs", os.path.basename(path))
                if os.path.exists(cand):
                    path = cand
            center = g.get("center", [0.0, 0.0, 0.0])
            if g.get("type") == "Mesh":
                self.meshes.append(MeshObject(path, center,
                                              g.get("scale", 1.0)))
            elif g.get("type") == "Nerf":
                self.nerfs.append(NerfObject(path, center))

        self.mesh_bvh = GeometryBvh([m.aabb for m in self.meshes]) \
            if self.meshes else None
        self.nerf_bvh = GeometryBvh([n.aabb for n in self.nerfs]) \
            if self.nerfs else None

        self.training_step = 0
        self.loss_scalar = float("nan")
        self.sun_dir = np.array([0.577, -0.577, 0.577], np.float32)
        # points TOWARD the light (shading convention in evaluate_shading)
        self.light_dir = np.array([0.577, 0.577, 0.577], np.float32)
        self.background_color = np.array([1.0, 1.0, 1.0], np.float32)

    # training is a no-op in geometry mode (testbed.cu:4026-4030)
    def train(self, n_steps: int = 1, **kw) -> float:
        return self.loss_scalar

    # ------------------------------------------------------------------
    def trace_meshes(self, origins: np.ndarray, dirs: np.ndarray):
        """Nearest mesh hit over all objects; (t, obj_idx, tri_idx)."""
        n = len(origins)
        best_t = np.full(n, 1e10, np.float32)
        best_obj = np.full(n, -1, np.int32)
        best_tri = np.full(n, -1, np.int32)
        if not self.meshes:
            return best_t, best_obj, best_tri
        mask = self.mesh_bvh.intersect_mask(origins, dirs)
        for oi, mesh in enumerate(self.meshes):
            if mesh.bvh is None:
                continue
            sel = np.nonzero(mask[:, oi])[0]
            if len(sel) == 0:
                continue
            t, tri = mesh.bvh.ray_trace(origins[sel], dirs[sel])
            hit = (tri >= 0) & (t < best_t[sel])
            upd = sel[hit]
            best_t[upd] = t[hit]
            best_obj[upd] = oi
            best_tri[upd] = tri[hit]
        return best_t, best_obj, best_tri

    def render_frame(self, width: int, height: int, camera_matrix,
                     focal_length: float = None,
                     render_mode: str = "Shade") -> np.ndarray:
        """(H, W, 4) linear. Mesh trace + BRDF shade; NeRF objects march
        behind/in front of mesh hits and composite."""
        from ..nerf.render import camera_rays_for_frame

        fl = focal_length or width * 1.1
        origins_j, dirs_j = camera_rays_for_frame(
            width, height, (fl, fl), np.asarray(camera_matrix, np.float32))
        origins = np.asarray(origins_j)
        dirs = np.asarray(dirs_j)

        t, obj, tri = self.trace_meshes(origins, dirs)
        hit = obj >= 0
        pos = origins + t[:, None] * dirs
        normals = np.zeros_like(pos)
        color = np.zeros((len(origins), 3), np.float32)
        for oi, mesh in enumerate(self.meshes):
            sel = np.nonzero(hit & (obj == oi))[0]
            if len(sel) == 0:
                continue
            n_all = mesh.bvh.triangle_normals()
            n = n_all[tri[sel]]
            # face normals toward the viewer
            flip = np.sum(n * dirs[sel], -1) > 0
            n[flip] = -n[flip]
            normals[sel] = n
            L = self.light_dir / np.linalg.norm(self.light_dir)
            shade = evaluate_shading(
                jnp.asarray(mesh.brdf.basecolor, jnp.float32),
                jnp.asarray(np.maximum(mesh.brdf.ambientcolor, 0.08),
                            jnp.float32),
                jnp.ones(3), mesh.brdf, jnp.asarray(L, jnp.float32),
                jnp.asarray(-dirs[sel]), jnp.asarray(n))
            color[sel] = np.asarray(shade)

        if render_mode == "Normals":
            color = np.where(hit[:, None], normals * 0.5 + 0.5, color)
        elif render_mode == "Depth":
            color = np.repeat(np.where(hit, t, 0.0)[:, None], 3, -1)

        alpha = hit.astype(np.float32)

        # NeRF objects: march each object's model along rays, composite
        # in front of mesh hits (capped at the mesh t)
        for nerf in self.nerfs:
            if nerf.model is None:
                continue
            rgb_n, alpha_n, depth_n = self._march_nerf_object(
                nerf, origins, dirs, np.where(hit, t, 1e10))
            in_front = alpha_n > 1e-3
            color = np.where(in_front[:, None],
                             rgb_n + (1 - alpha_n[:, None]) * color, color)
            alpha = np.where(in_front, alpha_n + (1 - alpha_n) * alpha,
                             alpha)

        color = np.where(alpha[:, None] > 0,
                         color + (1 - alpha[:, None]) * self.background_color,
                         self.background_color)
        rgba = np.concatenate([color, alpha[:, None]], -1)
        return rgba.reshape(height, width, 4).astype(np.float32)

    def _march_nerf_object(self, nerf: NerfObject, origins, dirs, t_max,
                           chunk: int = 1 << 15):
        """Fixed-step march of one NeRF object in its own local frame.

        Rays run in `chunk`-sized bands: each band evaluates
        chunk x 128 samples whose encode planes are (N, L*2^d) — an
        unchunked 512^2 frame would materialize multiple GB at once."""
        n = len(origins)
        if n > chunk:
            outs = [self._march_nerf_object(
                nerf, origins[i:i + chunk], dirs[i:i + chunk],
                t_max[i:i + chunk], chunk) for i in range(0, n, chunk)]
            return tuple(np.concatenate([o[k] for o in outs])
                         for k in range(3))
        from ..nerf.march import ray_intersect_aabb, warp_direction, \
            warp_position
        from ..nerf.model import network_to_density, network_to_rgb

        lo = jnp.asarray(nerf.aabb[0])
        hi = jnp.asarray(nerf.aabb[1])
        o = jnp.asarray(origins)
        d = jnp.asarray(dirs)
        tmin, tmax_box = ray_intersect_aabb(o, d, lo, hi)
        tmin = jnp.maximum(tmin, 0.0)
        tmax_eff = jnp.minimum(tmax_box, jnp.asarray(t_max))
        n_steps = 128
        dt = (tmax_eff - tmin) / n_steps
        valid = dt > 0

        ts = tmin[:, None] + (jnp.arange(n_steps) + 0.5)[None, :] \
            * dt[:, None]
        pos = o[:, None, :] + ts[..., None] * d[:, None, :]
        local = pos - jnp.asarray(nerf.center)
        warped = warp_position(local, lo - jnp.asarray(nerf.center),
                               hi - jnp.asarray(nerf.center))
        raw = nerf.model.apply(nerf.params, warped,
                               jnp.broadcast_to(
                                   warp_direction(d)[:, None, :],
                                   pos.shape))
        sigma = network_to_density(raw[..., 3], "Exponential")
        rgb = network_to_rgb(raw[..., :3], "Logistic")
        alpha = 1.0 - jnp.exp(-sigma * dt[:, None])
        alpha = jnp.where(valid[:, None], alpha, 0.0)
        trans = jnp.cumprod(1.0 - alpha, axis=-1)
        T_before = jnp.concatenate(
            [jnp.ones((alpha.shape[0], 1)), trans[:, :-1]], axis=-1)
        w = alpha * T_before
        rgb_ray = jnp.sum(w[..., None] * rgb, axis=1)
        alpha_ray = jnp.sum(w, axis=1)
        depth_ray = jnp.sum(w * ts, axis=1)
        return (np.asarray(rgb_ray), np.asarray(alpha_ray),
                np.asarray(depth_ray))

    # ------------------------------------------------------------------
    # Snapshots. The reference geometry mode cannot snapshot at all
    # (training is disabled and load_snapshot rejects the mode); here a
    # geometry snapshot is SELF-CONTAINED: mesh objects embed their
    # triangles + BRDF, NeRF objects embed the same state a NeRF
    # snapshot carries (config, params, density grid), so a scene
    # round-trips with no external files.
    def save_snapshot(self, path: str) -> None:
        import dataclasses

        from ..data.snapshot import save_snapshot as _save

        objects = []
        for m in self.meshes:
            objects.append({
                "type": "Mesh",
                "center": np.asarray(m.center, np.float32),
                "triangles": (m.triangles
                              - m.center[None, None, :]).astype(np.float32),
                "brdf": dataclasses.asdict(m.brdf),
            })
        for n in self.nerfs:
            entry: Dict[str, Any] = {
                "type": "Nerf",
                "center": np.asarray(n.center, np.float32),
                "path": n.path,
            }
            if n.model is not None:
                entry["nerf"] = {
                    "config": n.config,
                    "aabb_scale": n.aabb_scale,
                    "params": n.params,
                    "density_grid": n.density_grid,
                }
            objects.append(entry)
        _save(path, {
            "mode": "geometry",
            "objects": objects,
            "sun_dir": self.sun_dir,
            "light_dir": self.light_dir,
            "background_color": self.background_color,
        })

    def load_snapshot_state(self, snapshot: Dict[str, Any]) -> None:
        from .geometry_bvh import GeometryBvh

        self.meshes = []
        self.nerfs = []
        for entry in snapshot.get("objects", []):
            center = np.asarray(entry["center"], np.float32)
            if entry["type"] == "Mesh":
                m = MeshObject.__new__(MeshObject)
                m.center = center
                m.triangles = (np.asarray(entry["triangles"], np.float32)
                               + center[None, None, :])
                if len(m.triangles):
                    flat = m.triangles.reshape(-1, 3)
                    m.aabb = (flat.min(0), flat.max(0))
                    m.scale = float((m.aabb[1] - m.aabb[0]).max())
                    m.bvh = TriangleBvh(m.triangles, leaf_size=8)
                else:
                    m.aabb = (np.zeros(3, np.float32),
                              np.zeros(3, np.float32))
                    m.scale = 1.0
                    m.bvh = None
                m.brdf = BRDFParams(**{
                    k: tuple(v) if isinstance(v, (list, np.ndarray)) else v
                    for k, v in entry.get("brdf", {}).items()})
                self.meshes.append(m)
            elif entry["type"] == "Nerf":
                n = NerfObject.__new__(NerfObject)
                n.center = center
                n.path = entry.get("path", "")
                n.testbed = None
                if "nerf" in entry:
                    n._init_model(entry["nerf"]["config"],
                                  int(entry["nerf"]["aabb_scale"]),
                                  entry["nerf"]["params"],
                                  entry["nerf"]["density_grid"])
                else:
                    n.model = None
                    n.params = None
                    n.aabb = (n.center + 0.0, n.center + 1.0)
                self.nerfs.append(n)
        self.mesh_bvh = GeometryBvh([m.aabb for m in self.meshes]) \
            if self.meshes else None
        self.nerf_bvh = GeometryBvh([n.aabb for n in self.nerfs]) \
            if self.nerfs else None
        for k in ("sun_dir", "light_dir", "background_color"):
            if k in snapshot:
                setattr(self, k, np.asarray(snapshot[k], np.float32))

    @classmethod
    def from_snapshot(cls, snapshot: Dict[str, Any]) -> "GeometryTestbed":
        tb = cls.__new__(cls)
        tb.training_step = 0
        tb.loss_scalar = float("nan")
        tb.sun_dir = np.array([0.577, -0.577, 0.577], np.float32)
        tb.light_dir = np.array([0.577, 0.577, 0.577], np.float32)
        tb.background_color = np.array([1.0, 1.0, 1.0], np.float32)
        tb.load_snapshot_state(snapshot)
        return tb
