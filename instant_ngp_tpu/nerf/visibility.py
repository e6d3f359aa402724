"""Camera-visibility culling of occupancy cells.

Re-implements mark_untrained_density_grid (src/testbed_nerf.cu:74-146):
a grid cell is trainable iff at least `min_count`=1 training camera sees
any of its 8 corners (corner in front of the camera and projecting inside
(0,1)^2). FTheta/LatLong/Equirect lenses are assumed to see everything.

Runs once per dataset in a single jitted dispatch (lax.map over cell
chunks, scan over images). All per-corner math is component-separated —
(chunk, 8) x/y/z planes, with no (N, 8, 3) buffers.
The reference's undistortion round-trip check is approximated by the
plain projection test; it only differs for extreme distortion outside
the image, where density barely matters.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import (LENS_EQUIRECT, LENS_FTHETA, LENS_LATLONG,
                      LENS_OPENCV, LENS_OPENCV_FISHEYE,
                      opencv_fisheye_lens_distortion_delta,
                      opencv_lens_distortion_delta)
from ..common import NERF_GRID_N_CELLS, NERF_GRIDSIZE
from .dataset import NerfSceneConfig, NerfTrainingData
from .march import morton3d_coords


def compute_visible_cells(data: NerfTrainingData, scene: NerfSceneConfig,
                          chunk: int = 1 << 16) -> jax.Array:
    """Returns (n_cascades * 128^3,) bool visibility."""
    n_cascades = scene.max_cascade + 1
    if scene.lens_mode in (LENS_FTHETA, LENS_LATLONG, LENS_EQUIRECT):
        return jnp.ones(NERF_GRID_N_CELLS * n_cascades, bool)

    xforms = data.xforms_start          # (N, 3, 4)
    focal = data.focal_lengths          # (N, 2)
    resolutions = data.resolutions      # (N, 2) per-image (w, h)
    pps = data.principal_points         # (N, 2)
    lens_params = data.lens_params      # (N, 7)
    lens_mode = scene.lens_mode

    def visible_chunk(flat_idx: jax.Array) -> jax.Array:
        level = flat_idx // NERF_GRID_N_CELLS
        pos_idx = flat_idx % NERF_GRID_N_CELLS
        gx, gy, gz = morton3d_coords(pos_idx)
        mip = jnp.exp2(level.astype(jnp.float32))
        voxel = mip / NERF_GRIDSIZE
        base = [(g.astype(jnp.float32) / NERF_GRIDSIZE - 0.5) * mip + 0.5
                for g in (gx, gy, gz)]
        # corner component planes (chunk, 8)
        offs = np.array([[cx, cy, cz] for cx in (0, 1) for cy in (0, 1)
                         for cz in (0, 1)], np.float32)
        corners = [base[k][:, None] + voxel[:, None] * offs[None, :, k]
                   for k in range(3)]

        def per_image(carry, inputs):
            xform, fl, pp, lp, res = inputs
            R = xform[:3, :3]
            cam_o = xform[:3, 3]
            dx = corners[0] - cam_o[0]
            dy = corners[1] - cam_o[1]
            dz = corners[2] - cam_o[2]
            # camera-frame components via R^T
            cz = R[0, 2] * dx + R[1, 2] * dy + R[2, 2] * dz
            cxc = R[0, 0] * dx + R[1, 0] * dy + R[2, 0] * dz
            cyc = R[0, 1] * dx + R[1, 1] * dy + R[2, 1] * dz
            norm = jnp.sqrt(dx * dx + dy * dy + dz * dz)
            in_front = cz / jnp.maximum(norm, 1e-9) > 1e-4
            safe_z = jnp.where(jnp.abs(cz) < 1e-9, 1e-9, cz)
            px = cxc / safe_z
            py = cyc / safe_z
            if lens_mode == LENS_OPENCV:
                du, dv = opencv_lens_distortion_delta(lp, px, py)
                px, py = px + du, py + dv
            elif lens_mode == LENS_OPENCV_FISHEYE:
                du, dv = opencv_fisheye_lens_distortion_delta(lp, px, py)
                px, py = px + du, py + dv
            u = px * fl[0] / res[0] + pp[0]
            v = py * fl[1] / res[1] + pp[1]
            inside = (u > 0) & (u < 1) & (v > 0) & (v < 1)
            seen = jnp.any(in_front & inside, axis=-1)
            return carry | seen, None

        init = jnp.zeros(flat_idx.shape[0], bool)
        seen_any, _ = jax.lax.scan(per_image, init,
                                   (xforms, focal, pps, lens_params,
                                    resolutions))
        return seen_any

    n_total = NERF_GRID_N_CELLS * n_cascades
    n_chunks = (n_total + chunk - 1) // chunk

    @jax.jit
    def all_chunks():
        idx = jnp.arange(n_chunks * chunk).reshape(n_chunks, chunk)
        return jax.lax.map(visible_chunk, idx)

    out = np.asarray(all_chunks()).reshape(-1)[:n_total]
    return jnp.asarray(out)
