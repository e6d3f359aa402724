"""NeRF rendering: occupancy-guided marching + volumetric compositing.

Replaces the reference's wavefront tracer (NerfTracer::trace,
src/testbed_nerf.cu:1639-1795; render_nerf :1827-1987). The CUDA design
compacts alive rays on device with host readbacks every iteration
(:1688). Here rendering reuses the training
machinery: pixels are tiled into fixed-size ray batches; each batch is
marched with the same fixed-trip occupancy-skipping scan, compacted by
prefix sum, evaluated densely, and composited with min-transmittance
early-out (render default 1e-2, eval 1e-4 — nerf.h:173, run.py:230).
The march is the analytic candidate grid (sampler.march_rays) and the
composite runs directly on it. One jitted program per tile; zero host
syncs inside a frame.

Render modes (common.h:56-67): Shade, Depth, Positions, Normals (autodiff
input gradient of density, like network->input_gradient :1724), AO.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..camera import uv_to_ray
from .march import (advance_n_steps, calc_dt, ray_intersect_aabb,
                    warp_position)
from .model import NerfNetwork, network_to_density, network_to_rgb
from .sampler import RayBatch, compact_samples, march_rays


class RenderConfig(NamedTuple):
    n_rays: int              # tile size (static)
    n_march: int
    max_samples_per_ray: int
    sample_capacity: int
    cone_angle: float
    max_mip: int
    rgb_activation: str
    density_activation: str
    min_transmittance: float = 1e-2
    render_mode: str = "Shade"
    # render with the training-path stochastic-corner encode (axis-exact
    # j=1: 2 row fetches per sample-level instead of the exact path's 8)
    # — unbiased per-sample noise that averages out over spp exactly like
    # training noise, with ~4x fewer table fetches. Ignored by
    # modes needing spatial input gradients (Normals).
    stochastic_corners: bool = False


def render_tile(model: NerfNetwork, cfg: RenderConfig, params,
                origins: jax.Array, dirs: jax.Array, bitfield: jax.Array,
                aabb_min, aabb_max, bg_color: jax.Array,
                extra_dims: Optional[jax.Array] = None,
                rng: Optional[jax.Array] = None
                ) -> Dict[str, jax.Array]:
    """Render one tile of rays. origins/dirs (R, 3) in NGP space, dirs
    normalized; bg_color (R, 3) linear. Returns rgba + depth."""
    n_rays = origins.shape[0]
    tmin, tmax = ray_intersect_aabb(origins, dirs, aabb_min, aabb_max)
    tmin = jnp.maximum(tmin, 0.0)
    valid = tmax >= tmin
    t_start = advance_n_steps(tmin, cfg.cone_angle, 0.5)

    rays = RayBatch(origins, dirs, t_start,
                    jnp.zeros(n_rays, jnp.int32),
                    jnp.zeros((n_rays, 2)),
                    jnp.zeros((n_rays, 4)), valid)
    ts, dts, emits = march_rays(rays, bitfield, aabb_min, aabb_max,
                                cfg.cone_angle, cfg.max_mip, cfg.n_march,
                                cfg.max_samples_per_ray)
    # depth-major compaction: a query-budget capacity sheds the DEEP
    # tail of every ray uniformly (the reference bounds each compaction
    # round by target_n_queries=2M, testbed_nerf.cu:1697-1698) — the
    # network never evaluates tile*max_k mostly-padding samples
    samples = compact_samples(rays, ts, dts, emits, aabb_min, aabb_max,
                              cfg.sample_capacity, order="depth",
                              cone_angle=cfg.cone_angle)

    extra_flat = None
    if extra_dims is not None:
        extra_flat = jnp.broadcast_to(
            extra_dims[None], (cfg.sample_capacity, extra_dims.shape[-1]))

    if cfg.render_mode == "Normals":
        # d(density)/dpos via autodiff (input_gradient equivalent),
        # component-separated like everything else
        def raw_density(px, py, pz):
            if hasattr(model.pos_encoding, "apply_components"):
                feats = model.pos_encoding.apply_components(
                    params["pos_encoding"], [px, py, pz])
            else:
                feats = model.pos_encoding.apply(
                    params["pos_encoding"], jnp.stack([px, py, pz], -1))
            return jnp.sum(model.density_net.apply(
                params["density_net"], feats)[..., 0])

        g = jax.grad(raw_density, argnums=(0, 1, 2))(*samples.positions)
        norm = jnp.sqrt(g[0] ** 2 + g[1] ** 2 + g[2] ** 2)
        normals = [-gi / jnp.maximum(norm, 1e-9) for gi in g]
        _, _, _, sig = model.apply_components(
            params, samples.positions, samples.dirs, extra_flat)
        raw_ch = (*normals, sig)
        shade_is_raw = True
    else:
        enc_rng = rng if (cfg.stochastic_corners and rng is not None) \
            else None
        raw_ch = model.apply_components(params, samples.positions,
                                        samples.dirs, extra_flat,
                                        encode_rng=enc_rng)
        shade_is_raw = False

    # composite in the (R, M) candidate domain: the network's flat
    # outputs scatter back once per channel; mask/dt/t are march outputs
    m_cand = ts.shape[1]
    kept = samples.cand_slot < cfg.sample_capacity

    def to_cand(v):
        plane = jnp.zeros(n_rays * m_cand + 1, v.dtype).at[
            samples.cand_src].set(v, mode="drop")
        return plane[:n_rays * m_cand].reshape(n_rays, m_cand)

    padded = [to_cand(c) for c in raw_ch]
    mask = kept
    t_padded = ts

    if shade_is_raw:
        rgb_ch = [c * 0.5 + 0.5 for c in padded[:3]]
    else:
        rgb_ch = [network_to_rgb(c, cfg.rgb_activation)
                  for c in padded[:3]]
    sigma = network_to_density(padded[3], cfg.density_activation)
    dt = dts
    alpha = jnp.where(mask, 1.0 - jnp.exp(-sigma * dt), 0.0)

    one_minus = 1.0 - alpha
    t_prefix = jnp.cumprod(one_minus, axis=-1)
    T_before = jnp.concatenate(
        [jnp.ones((n_rays, 1), alpha.dtype), t_prefix[:, :-1]], axis=-1)
    alive = mask & (T_before >= cfg.min_transmittance)
    weight = jnp.where(alive, alpha * T_before, 0.0)

    if cfg.render_mode == "Positions":
        rgb_ch = [to_cand(p) for p in samples.positions]
    elif cfg.render_mode == "Depth":
        rgb_ch = [t_padded] * 3
    elif cfg.render_mode == "AO":
        # ambient-occlusion-style view: pure white medium — the image is
        # the accumulated opacity profile (ERenderMode::AO analog)
        rgb_ch = [jnp.ones_like(t_padded)] * 3
    elif cfg.render_mode == "EncodingVis":
        # visualize the first three hash-encoding features at the samples
        if hasattr(model.pos_encoding, "apply_components"):
            feats = model.pos_encoding.apply_components(
                params["pos_encoding"], list(samples.positions))
        else:
            feats = model.pos_encoding.apply(
                params["pos_encoding"], jnp.stack(samples.positions, -1))
        vis = feats[..., :3] * 20.0 + 0.5
        rgb_ch = [to_cand(vis[..., k]) for k in range(3)]

    ray_ch = [jnp.sum(weight * c, axis=1) for c in rgb_ch]
    opacity = jnp.sum(weight, axis=1)
    depth_ray = jnp.sum(weight * t_padded, axis=1)
    # opacity-normalized depth looks wrong at silhouettes; reference keeps
    # the weighted sum, matching composite_kernel_nerf
    ray_ch = [c + (1.0 - opacity) * bg_color[:, k]
              for k, c in enumerate(ray_ch)]

    if cfg.render_mode == "Cost":
        n_steps = jnp.sum(mask, axis=1).astype(jnp.float32) / 128.0
        ray_ch = [n_steps] * 3

    rgb_ray = jnp.stack(ray_ch, axis=-1)
    return {
        "rgb": jnp.where(valid[..., None], rgb_ray, bg_color),
        "alpha": jnp.where(valid, opacity, 0.0),
        "depth": jnp.where(valid, depth_ray, 0.0),
        "n_samples": samples.n_samples,
    }


class WavefrontRenderer:
    """Early-out wavefront rendering — the NerfTracer::trace equivalent
    (src/testbed_nerf.cu:1639-1795), with static shapes.

    The reference's tracer evaluates <=8 steps per alive ray between
    compactions so dead rays (transmittance below threshold) cost
    nothing. `render_tile` instead evaluates a full capacity-bound
    sample buffer — most of which is padding or behind the first
    surface.

    Here the march's (R, M) candidate grid is packed per ray ONCE by a
    dense XLA sort (no scatter, like compact_samples),
    then a host loop walks depth chunks of K candidates: each round
    gathers the alive rays (power-of-two buckets, so only a handful of
    programs compile), evaluates the network on (B, K) samples, and
    composites with the exact same transmittance math as render_tile.
    Rays whose transmittance crossed min_transmittance — or whose
    candidates ran out — are never evaluated again. One (R,)-sized
    host readback per round is the only sync, mirroring the
    reference's n_alive readback (:1688) at ~1/K the frequency.
    Results are identical to render_tile with a non-binding capacity
    (same candidates, same weights, float-rounding differences only).
    """

    #: alive-count bucket floor — quarter-steps anchored at the tile
    #: size ({R, R/4, R/16, ...}) so at most ~5 round programs compile
    #: per tile size, at a per-round padding waste of at most 4x
    _MIN_BUCKET = 4096
    #: rays per march sub-chunk inside prep: the march's (rays, n_march)
    #: planes are transient — lax.map over sub-chunks pins peak memory
    #: to one chunk while the packed (rays, C) output spans the full tile
    _MARCH_CHUNK = 1 << 15

    def __init__(self, model: NerfNetwork, cfg: RenderConfig, aabb_min,
                 aabb_max, chunk: int = 32):
        self.model = model
        self.cfg = cfg
        self.aabb_min = jnp.asarray(aabb_min)
        self.aabb_max = jnp.asarray(aabb_max)
        self.chunk = chunk
        # depth windows slice a fixed `chunk` of candidates per round, so
        # the packed buffers are padded up to a chunk multiple (padding
        # lanes carry ok=False and composite to zero). Without this, a
        # march budget smaller than one chunk crashed dynamic_slice, and
        # a non-multiple budget would double-composite its clamped tail.
        self._c_pad = -(-cfg.max_samples_per_ray // chunk) * chunk
        self._prep = jax.jit(self._prep_impl)
        self._round_fns: Dict[Tuple[int, bool], Any] = {}

    def _march_and_pack(self, origins, dirs, bitfield):
        cfg = self.cfg
        n_rays = origins.shape[0]
        tmin, tmax = ray_intersect_aabb(origins, dirs, self.aabb_min,
                                        self.aabb_max)
        tmin = jnp.maximum(tmin, 0.0)
        valid = tmax >= tmin
        t_start = advance_n_steps(tmin, cfg.cone_angle, 0.5)
        rays = RayBatch(origins, dirs, t_start,
                        jnp.zeros(n_rays, jnp.int32),
                        jnp.zeros((n_rays, 2)),
                        jnp.zeros((n_rays, 4)), valid)
        ts, _, emit = march_rays(rays, bitfield, self.aabb_min,
                                 self.aabb_max, cfg.cone_angle,
                                 cfg.max_mip, cfg.n_march,
                                 cfg.max_samples_per_ray)
        # per-ray packing by sort: emitted candidates keep their march
        # slot as key, non-emitting ones sink to M — after an ascending
        # row sort the first C columns are each ray's time-ordered
        # samples (dense passes instead of an R*M-element scatter)
        m = ts.shape[1]
        key = jnp.where(emit, jnp.arange(m, dtype=jnp.int32)[None, :], m)
        keys_s, ts_s = jax.lax.sort((key, ts), num_keys=1)
        c = cfg.max_samples_per_ray
        ts_c, ok_c = ts_s[:, :c], keys_s[:, :c] < m
        if self._c_pad > c:
            pad = ((0, 0), (0, self._c_pad - c))
            ts_c = jnp.pad(ts_c, pad)
            ok_c = jnp.pad(ok_c, pad)
        n_cand = jnp.minimum(jnp.sum(emit, axis=1), c).astype(jnp.int32)
        return ts_c, ok_c, n_cand, valid

    def _prep_impl(self, origins, dirs, bitfield):
        n_rays = origins.shape[0]
        chunk = self._MARCH_CHUNK
        if n_rays <= chunk:
            return self._march_and_pack(origins, dirs, bitfield)
        n_chunks = (n_rays + chunk - 1) // chunk
        pad = n_chunks * chunk - n_rays
        o = jnp.pad(origins, ((0, pad), (0, 0))).reshape(
            n_chunks, chunk, 3)
        d = jnp.pad(dirs, ((0, pad), (0, 0)),
                    constant_values=0.577).reshape(n_chunks, chunk, 3)
        ts, ok, n_cand, valid = jax.lax.map(
            lambda od: self._march_and_pack(od[0], od[1], bitfield),
            (o, d))
        c = self._c_pad
        return (ts.reshape(-1, c)[:n_rays], ok.reshape(-1, c)[:n_rays],
                n_cand.reshape(-1)[:n_rays], valid.reshape(-1)[:n_rays])

    def _round_fn(self, bucket: int, has_extra: bool,
                  has_rng: bool = False):
        key = (bucket, has_extra, has_rng)
        if key not in self._round_fns:
            self._round_fns[key] = jax.jit(
                partial(self._round_impl, bucket))
        return self._round_fns[key]

    def _round_impl(self, bucket, params, packed_ts, packed_ok, origins,
                    dirs, T, acc_rgb, acc_alpha, acc_depth, idx, start,
                    extra_dims, rng=None):
        cfg = self.cfg
        k = self.chunk
        # contiguous depth window first (dense slice), THEN one row
        # gather per alive ray — not B*K element gathers
        ts_win = jax.lax.dynamic_slice_in_dim(packed_ts, start, k, 1)
        ok_win = jax.lax.dynamic_slice_in_dim(packed_ok, start, k, 1)
        rt = ts_win[idx]                                       # (B, K)
        rv = ok_win[idx]
        o_b, d_b = origins[idx], dirs[idx]
        span = self.aabb_max - self.aabb_min
        pos = tuple(
            ((o_b[:, c:c + 1] + rt * d_b[:, c:c + 1])
             - self.aabb_min[c]) / span[c] for c in range(3))
        dirw = tuple(jnp.broadcast_to((d_b[:, c:c + 1] + 1.0) * 0.5,
                                      rt.shape) for c in range(3))
        # network eval in sample chunks: the fused encode materializes
        # (N, L*2^d) index/weight planes, so a fat tile's B*K samples
        # must not hit apply_components in one call (observed: 32 GB
        # HBM ask at B=2^18, K=64); lax.map pins peak to one chunk
        n_s = bucket * k
        eval_chunk = 1 << 21

        enc_rng = rng if (cfg.stochastic_corners and rng is not None) \
            else None

        def eval_all(c6):
            extra_flat = None
            if extra_dims is not None:
                extra_flat = jnp.broadcast_to(
                    extra_dims[None], (c6[0].shape[0],
                                       extra_dims.shape[-1]))
            return self.model.apply_components(
                params, (c6[0], c6[1], c6[2]), (c6[3], c6[4], c6[5]),
                extra_flat, encode_rng=enc_rng)

        comp6 = [p.reshape(-1) for p in pos] \
            + [w.reshape(-1) for w in dirw]
        if n_s <= eval_chunk:
            raw = eval_all(comp6)
        else:
            nc = (n_s + eval_chunk - 1) // eval_chunk
            pad = nc * eval_chunk - n_s
            stacked = jnp.stack([jnp.pad(c, (0, pad)) for c in comp6]) \
                .reshape(6, nc, eval_chunk).transpose(1, 0, 2)
            outs = jax.lax.map(eval_all, stacked)   # 4 x (nc, chunk)
            raw = [o.reshape(-1)[:n_s] for o in outs]
        rgb = [network_to_rgb(raw[c].reshape(rt.shape),
                              cfg.rgb_activation) for c in range(3)]
        sigma = network_to_density(raw[3].reshape(rt.shape),
                                   cfg.density_activation)
        dt = jnp.asarray(calc_dt(rt, cfg.cone_angle), sigma.dtype)
        alpha = jnp.where(rv, 1.0 - jnp.exp(-sigma * dt), 0.0)
        one_minus = 1.0 - alpha
        prefix = jnp.cumprod(one_minus, axis=1)
        t_in = T[idx]
        t_before = t_in[:, None] * jnp.concatenate(
            [jnp.ones_like(prefix[:, :1]), prefix[:, :-1]], axis=1)
        w = jnp.where(rv & (t_before >= cfg.min_transmittance),
                      alpha * t_before, 0.0)
        # padded lanes carry idx == R: their writes drop below
        T = T.at[idx].set(t_in * prefix[:, -1], mode="drop")
        acc_rgb = acc_rgb.at[idx].add(
            jnp.stack([jnp.sum(w * c, axis=1) for c in rgb], axis=-1),
            mode="drop")
        acc_alpha = acc_alpha.at[idx].add(jnp.sum(w, axis=1), mode="drop")
        acc_depth = acc_depth.at[idx].add(jnp.sum(w * rt, axis=1),
                                          mode="drop")
        return T, acc_rgb, acc_alpha, acc_depth

    def _bucket(self, n_alive: int, n_rays: int) -> int:
        b = n_rays
        while b // 4 >= max(n_alive, self._MIN_BUCKET):
            b //= 4
        return b

    def render(self, params, origins: jax.Array, dirs: jax.Array,
               bitfield: jax.Array, bg_color: jax.Array,
               extra_dims: Optional[jax.Array] = None,
               rng: Optional[jax.Array] = None
               ) -> Dict[str, jax.Array]:
        """Same contract as render_tile (rgb composited over bg_color)."""
        cfg = self.cfg
        n_rays = origins.shape[0]
        packed_ts, packed_ok, n_cand, valid = self._prep(
            origins, dirs, bitfield)
        T = jnp.ones(n_rays, jnp.float32)
        acc_rgb = jnp.zeros((n_rays, 3), jnp.float32)
        acc_alpha = jnp.zeros(n_rays, jnp.float32)
        acc_depth = jnp.zeros(n_rays, jnp.float32)
        n_cand_np = np.asarray(n_cand)
        alive_base = np.asarray(valid)
        # pipelined alive tracking: the alive set for round r is built
        # from the freshest transmittance that has LANDED on the host
        # (round r-2) — T is monotone decreasing, so a stale mask is a
        # conservative SUPERSET (never drops a live ray, wastes at most
        # one extra round on dying rays). Keeping <=2 rounds in flight
        # hides the dispatch+readback latency behind the device queue
        # (the reference's n_alive readback :1688 pays the same sync
        # every compaction — on-device queueing hides ours).
        t_known = np.ones(n_rays, np.float32)
        inflight = []
        n_evaluated = 0
        for start in range(0, cfg.max_samples_per_ray, self.chunk):
            while len(inflight) >= 2:
                t_known = np.asarray(inflight.pop(0))
            alive = (alive_base & (t_known >= cfg.min_transmittance)
                     & (n_cand_np > start))
            if not alive.any():
                # possibly stale-dead: drain and recheck before exiting
                while inflight:
                    t_known = np.asarray(inflight.pop(0))
                alive = (alive_base
                         & (t_known >= cfg.min_transmittance)
                         & (n_cand_np > start))
                if not alive.any():
                    break
            n_alive = int(alive.sum())
            b = self._bucket(n_alive, n_rays)
            idx = np.full(b, n_rays, np.int32)
            idx[:n_alive] = np.nonzero(alive)[0][:b]
            fn = self._round_fn(b, extra_dims is not None,
                                rng is not None)
            round_rng = None if rng is None else \
                jax.random.fold_in(rng, start)
            T, acc_rgb, acc_alpha, acc_depth = fn(
                params, packed_ts, packed_ok, origins, dirs, T, acc_rgb,
                acc_alpha, acc_depth, jnp.asarray(idx),
                jnp.int32(start), extra_dims, round_rng)
            inflight.append(T)
            n_evaluated += b * self.chunk
        rgb = acc_rgb + (1.0 - acc_alpha)[:, None] * bg_color
        return {
            "rgb": jnp.where(valid[:, None], rgb, bg_color),
            "alpha": jnp.where(valid, acc_alpha, 0.0),
            "depth": jnp.where(valid, acc_depth, 0.0),
            "n_samples": jnp.asarray(n_evaluated, jnp.int32),
        }


def camera_rays_for_frame(width: int, height: int, focal_length,
                          camera_matrix, screen_center=(0.5, 0.5),
                          lens_mode: int = 0, lens_params=None,
                          distortion_map: Optional[jax.Array] = None,
                          jitter: Optional[jax.Array] = None,
                          aperture_size: float = 0.0, focus_z: float = 1.0,
                          aperture_key: Optional[jax.Array] = None
                          ) -> Tuple[jax.Array, jax.Array]:
    """(H*W, 3) origins + normalized dirs for a full frame. `jitter` (2,)
    is the subpixel offset for spp accumulation (default pixel centers).

    aperture_size/focus_z: depth of field (init_rays_with_payload_kernel,
    testbed_nerf.cu:1392-1399 — per-pixel disk-sampled origin offset with
    the direction refocused on the focus plane). aperture_key draws the
    per-pixel disk samples; required when aperture_size > 0."""
    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    off = jnp.asarray([0.5, 0.5]) if jitter is None else jitter
    uv = jnp.stack(jnp.meshgrid((x + off[0]) / width,
                                (y + off[1]) / height, indexing="xy"),
                   axis=-1).reshape(-1, 2)
    ap_samples = None
    if aperture_size != 0.0 and aperture_key is not None:
        ap_samples = jax.random.uniform(aperture_key, (uv.shape[0], 2))
    origins, dirs, _ = uv_to_ray(
        uv, (width, height), jnp.asarray(focal_length, jnp.float32),
        jnp.asarray(camera_matrix, jnp.float32), screen_center,
        lens_mode=lens_mode, lens_params=lens_params,
        distortion_map=distortion_map,
        aperture_size=aperture_size, focus_z=focus_z,
        aperture_samples=ap_samples)
    dirs = dirs / jnp.linalg.norm(dirs, axis=-1, keepdims=True)
    return origins, dirs


def hsv_to_rgb(h: jax.Array, s: jax.Array, v: jax.Array):
    """HSV→RGB per channel (common_device.cuh:691-712)."""
    h6 = (h % 1.0) * 6.0
    c = v * s
    x = c * (1.0 - jnp.abs(h6 % 2.0 - 1.0))
    m = v - c
    i = jnp.floor(h6).astype(jnp.int32) % 6
    r = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4], [c, x, 0.0, 0.0, x], c)
    g = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4], [x, c, c, x, 0.0], 0.0)
    b = jnp.select([i == 0, i == 1, i == 2, i == 3, i == 4], [0.0, 0.0, x, c, c], x)
    return r + m, g + m, b + m


def distortion_flow_image(width: int, height: int, focal_length,
                          camera_matrix, screen_center=(0.5, 0.5),
                          lens_mode: int = 0, lens_params=None,
                          distortion_map: Optional[jax.Array] = None
                          ) -> jax.Array:
    """ERenderMode::Distortion (testbed_nerf.cu:1458-1467): cast the
    distorted ray per pixel, project ray(1.0) back through the *pinhole*
    model, and visualize the uv displacement ×64 as an HSV flow field
    (hue = direction, value = magnitude; to_rgb common_device.cuh:714)."""
    from ..camera import pos_to_uv

    x = jnp.arange(width, dtype=jnp.float32)
    y = jnp.arange(height, dtype=jnp.float32)
    uv = jnp.stack(jnp.meshgrid((x + 0.5) / width, (y + 0.5) / height,
                                indexing="xy"), axis=-1).reshape(-1, 2)
    fl = jnp.asarray(focal_length, jnp.float32)
    cam = jnp.asarray(camera_matrix, jnp.float32)
    origins, dirs, _ = uv_to_ray(
        uv, (width, height), fl, cam, screen_center,
        lens_mode=lens_mode, lens_params=lens_params,
        distortion_map=distortion_map)
    uv_after, _ = pos_to_uv(origins + dirs, (width, height), fl, cam,
                            screen_center)
    d = (uv_after - uv) * 64.0
    mag = jnp.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    hue = jnp.arctan2(d[:, 1], d[:, 0]) / (2.0 * jnp.pi) + 0.5
    r, g, b = hsv_to_rgb(hue, jnp.ones_like(mag), mag)
    rgba = jnp.stack([r, g, b, jnp.ones_like(mag)], axis=-1)
    return rgba.reshape(height, width, 4)
