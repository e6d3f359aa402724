"""SDF voxel bricks: ground-truth SDF cached on per-octree-cell lattices.

The reference's ESDFGroundTruthMode::SDFBricks (testbed.cu:4388-4406)
builds a B^3 (B=5, brick_res) voxel lattice for every octree cell via
TriangleOctree::build_brick_voxel_position_list (triangle_octree.cuh:69-99)
and evaluates watertight signed distance at each lattice point with the
triangle BVH. Its sampling kernel is vestigial (commented out,
testbed.cu:4412-4423); here the mode is completed: sampling finds the
finest occupied cell at `brick_level` and trilinearly interpolates its
brick — a pure-gather jittable function, so the sphere tracer can
consume it like the learned SDF.

Notes: brick build happens once on the host (native BVH,
multithreaded); sampling is one sorted-table lookup + an (N, 8) gather,
fully inside jit.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..nerf.march import morton3d


class SdfBricks:
    MAX_VOXELS = 1 << 20  # cap host-side BVH evaluations at build

    def __init__(self, octree, bvh, brick_res: int = 5,
                 brick_level: int = 10):
        """octree: geom.TriangleOctree (cells in [0,1]^3);
        bvh: geom.TriangleBvh (same space); brick_res: lattice side B."""
        self.brick_res = B = int(brick_res)
        level = min(octree.depth - 1, brick_level)
        while level > 0 and len(octree.levels[level].cell_codes) * B ** 3 \
                > self.MAX_VOXELS:
            level -= 1
        self.level = level
        lvl = octree.levels[level]
        self.cell_codes = np.asarray(lvl.cell_codes, np.int64)
        res = 1 << level
        self.res = res

        # lattice positions for every occupied cell (B^3 per brick,
        # spacing cell_size/(B-1) => corners on the cell boundary, same
        # as write_brick_voxel_positions' rstep = 1/(B-1))
        from ..nerf.march import morton3d_coords

        cc = jnp.asarray(self.cell_codes.astype(np.int32))
        if len(self.cell_codes):
            x, y, z = (np.asarray(v) for v in morton3d_coords(cc))
        else:
            x = y = z = np.zeros(0, np.int32)
        base = np.stack([x, y, z], -1).astype(np.float32) / res  # (C,3)
        step = 1.0 / (res * (B - 1))
        g = np.mgrid[0:B, 0:B, 0:B].astype(np.float32)  # (3,B,B,B)
        lattice = g.transpose(1, 2, 3, 0).reshape(-1, 3) * step
        pos = (base[:, None, :] + lattice[None, :, :]).reshape(-1, 3)

        d = bvh.signed_distance(pos, mode="Watertight") if len(pos) else \
            np.zeros(0, np.float32)
        self.data = jnp.asarray(d.reshape(-1, B, B, B).astype(np.float32))
        self._ctable = jnp.asarray(self.cell_codes.astype(np.int32))

    def distance(self, pos: jax.Array) -> jax.Array:
        """(N, 3) in [0,1]^3 -> interpolated GT signed distance. Points
        outside any occupied cell get a conservative positive distance
        (half a cell) so sphere tracing keeps advancing, mirroring the
        octree raymarcher's empty-space skip."""
        B, res = self.brick_res, self.res
        c = jnp.clip(jnp.floor(pos * res).astype(jnp.int32), 0, res - 1)
        code = morton3d(c[..., 0], c[..., 1], c[..., 2])
        n_cells = self.data.shape[0]
        if n_cells == 0:
            return jnp.full(pos.shape[:-1], 0.5 / res)
        ci = jnp.clip(jnp.searchsorted(self._ctable, code), 0, n_cells - 1)
        occupied = self._ctable[ci] == code

        # local coordinates in lattice units
        f = jnp.clip((pos * res - c) * (B - 1), 0.0, B - 1 - 1e-6)
        i0 = jnp.floor(f).astype(jnp.int32)
        t = f - i0
        out = jnp.zeros(pos.shape[:-1], self.data.dtype)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    w = (jnp.where(dx, t[..., 0], 1 - t[..., 0])
                         * jnp.where(dy, t[..., 1], 1 - t[..., 1])
                         * jnp.where(dz, t[..., 2], 1 - t[..., 2]))
                    v = self.data[ci,
                                  jnp.minimum(i0[..., 0] + dx, B - 1),
                                  jnp.minimum(i0[..., 1] + dy, B - 1),
                                  jnp.minimum(i0[..., 2] + dz, B - 1)]
                    out = out + w * v
        return jnp.where(occupied, out, 0.5 / res)
