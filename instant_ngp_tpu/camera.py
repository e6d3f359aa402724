"""Camera and lens math: uv↔ray, distortion models, rolling shutter.

Vectorized jnp re-implementation of common_device.cuh:
- OpenCV radial/tangential distortion delta (:249-263) and fisheye
  (:265-287), with iterative Newton undistortion (:289-330) — fixed
  iteration count (no data-dependent trip counts; the reference caps
  at 100 with early-out, convergence is typically < 10);
- f-theta polynomial undistortion (:360-374), latlong (:376-383) and
  equirectangular (:385-391) direction mapping;
- uv_to_ray (:393-466): pixel plane at z=1 in camera space, optional
  depth-of-field aperture sampling;
- pos_to_uv (:497-538): forward projection (used by the untrained-cell
  camera visibility test);
- camera_slerp + rolling-shutter time interpolation (:624-637).

Conventions: uv in [0,1]^2, x right / y DOWN (image space); camera matrix
is (3,4) [R|t] with columns x-right, y-down, z-forward in NGP world space.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# float32 camera math must not run in TF32 on GPUs
_HIGHEST = jax.lax.Precision.HIGHEST


class LensParams(NamedTuple):
    """Static lens description for jitted code. mode is an int:
    0 Perspective, 1 OpenCV, 2 FTheta, 3 LatLong, 4 OpenCVFisheye,
    5 Equirectangular (common.h ELensMode order)."""

    mode: int
    params: jax.Array  # (7,)


LENS_PERSPECTIVE, LENS_OPENCV, LENS_FTHETA = 0, 1, 2
LENS_LATLONG, LENS_OPENCV_FISHEYE, LENS_EQUIRECT = 3, 4, 5

_LENS_MODE_FROM_STR = {
    "Perspective": LENS_PERSPECTIVE, "OpenCV": LENS_OPENCV,
    "FTheta": LENS_FTHETA, "LatLong": LENS_LATLONG,
    "OpenCVFisheye": LENS_OPENCV_FISHEYE, "Equirectangular": LENS_EQUIRECT,
}


def lens_mode_id(name: str) -> int:
    return _LENS_MODE_FROM_STR[name]


# ---------------------------------------------------------------------------
# Distortion deltas
# ---------------------------------------------------------------------------

def opencv_lens_distortion_delta(params: jax.Array, u: jax.Array,
                                 v: jax.Array) -> Tuple[jax.Array, jax.Array]:
    k1, k2, p1, p2 = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    u2, v2, uv = u * u, v * v, u * v
    r2 = u2 + v2
    radial = k1 * r2 + k2 * r2 * r2
    du = u * radial + 2 * p1 * uv + p2 * (r2 + 2 * u2)
    dv = v * radial + 2 * p2 * uv + p1 * (r2 + 2 * v2)
    return du, dv


def opencv_fisheye_lens_distortion_delta(params: jax.Array, u: jax.Array,
                                         v: jax.Array
                                         ) -> Tuple[jax.Array, jax.Array]:
    k1, k2, k3, k4 = (params[..., 0], params[..., 1], params[..., 2],
                      params[..., 3])
    r = jnp.sqrt(u * u + v * v)
    safe_r = jnp.maximum(r, 1e-12)
    theta = jnp.arctan(safe_r)
    t2 = theta * theta
    thetad = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = jnp.where(r > 1e-12, thetad / safe_r - 1.0, 0.0)
    return u * scale, v * scale


def iterative_lens_undistortion(params: jax.Array, u: jax.Array,
                                v: jax.Array, distortion_fn,
                                n_iterations: int = 12
                                ) -> Tuple[jax.Array, jax.Array]:
    """Newton iterations with central-difference Jacobian, vectorized.

    Matches the reference solver (common_device.cuh:289-330) with a fixed
    trip count; kRelStepSize = 1e-6."""
    rel = 1e-6
    eps = np.finfo(np.float32).eps
    x0u, x0v = u, v
    xu, xv = u, v

    def body(_, carry):
        xu, xv = carry
        s0 = jnp.maximum(eps, jnp.abs(rel * xu))
        s1 = jnp.maximum(eps, jnp.abs(rel * xv))
        du, dv = distortion_fn(params, xu, xv)
        du0b, dv0b = distortion_fn(params, xu - s0, xv)
        du0f, dv0f = distortion_fn(params, xu + s0, xv)
        du1b, dv1b = distortion_fn(params, xu, xv - s1)
        du1f, dv1f = distortion_fn(params, xu, xv + s1)
        j00 = 1 + (du0f - du0b) / (2 * s0)
        j01 = (du1f - du1b) / (2 * s1)
        j10 = (dv0f - dv0b) / (2 * s0)
        j11 = 1 + (dv1f - dv1b) / (2 * s1)
        fu = xu + du - x0u
        fv = xv + dv - x0v
        det = j00 * j11 - j01 * j10
        det = jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
        step_u = (j11 * fu - j01 * fv) / det
        step_v = (-j10 * fu + j00 * fv) / det
        return xu - step_u, xv - step_v

    xu, xv = jax.lax.fori_loop(0, n_iterations, body, (xu, xv))
    return xu, xv


def f_theta_undistortion(uv: jax.Array, params: jax.Array) -> jax.Array:
    """(..., 2) uv (already screen-center-relative) -> (..., 3) dir; zero
    vector marks invalid."""
    xpix = uv[..., 0] * params[..., 5]
    ypix = uv[..., 1] * params[..., 6]
    norm = jnp.sqrt(xpix * xpix + ypix * ypix)
    alpha = params[..., 0] + norm * (params[..., 1] + norm * (
        params[..., 2] + norm * (params[..., 3] + norm * params[..., 4])))
    sin_a, cos_a = jnp.sin(alpha), jnp.cos(alpha)
    safe_norm = jnp.maximum(norm, 1e-12)
    ok = (cos_a > np.finfo(np.float32).tiny) & (norm > 0)
    s = sin_a / safe_norm
    dir = jnp.stack([s * xpix, s * ypix, cos_a], axis=-1)
    return jnp.where(ok[..., None], dir, 0.0)


def latlong_to_dir(uv: jax.Array) -> jax.Array:
    theta = (uv[..., 1] - 0.5) * jnp.pi
    phi = (uv[..., 0] - 0.5) * jnp.pi * 2.0
    st, ct = jnp.sin(theta), jnp.cos(theta)
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([sp * ct, st, cp * ct], axis=-1)


def equirectangular_to_dir(uv: jax.Array) -> jax.Array:
    ct = (uv[..., 1] - 0.5) * 2.0
    st = jnp.sqrt(jnp.maximum(1.0 - ct * ct, 0.0))
    phi = (uv[..., 0] - 0.5) * jnp.pi * 2.0
    sp, cp = jnp.sin(phi), jnp.cos(phi)
    return jnp.stack([sp * st, ct, cp * st], axis=-1)


# ---------------------------------------------------------------------------
# uv -> ray
# ---------------------------------------------------------------------------

def uv_to_ray(uv: jax.Array, resolution, focal_length: jax.Array,
              camera_matrix: jax.Array, screen_center=(0.5, 0.5),
              lens_mode: int = LENS_PERSPECTIVE,
              lens_params: Optional[jax.Array] = None,
              near_distance: float = 0.0,
              aperture_size: float = 0.0, focus_z: float = 1.0,
              aperture_samples: Optional[jax.Array] = None,
              distortion_map: Optional[jax.Array] = None,
              ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """uv (..., 2) → (origin (...,3), dir (...,3) UNnormalized, valid).

    camera_matrix: (..., 3, 4) or (3, 4); dir z=1 plane convention.
    lens_mode must be a static int (one compiled program per lens type —
    the reference branches per-thread, we specialize per dataset)."""
    resolution = jnp.asarray(resolution, jnp.float32)
    screen_center = jnp.asarray(screen_center, jnp.float32)
    valid = jnp.ones(uv.shape[:-1], bool)

    if lens_mode == LENS_FTHETA:
        dir = f_theta_undistortion(uv - screen_center, lens_params)
        valid = jnp.any(dir != 0.0, axis=-1)
    elif lens_mode == LENS_LATLONG:
        dir = latlong_to_dir(uv)
    elif lens_mode == LENS_EQUIRECT:
        dir = equirectangular_to_dir(uv)
    else:
        x = (uv[..., 0] - screen_center[..., 0]) * resolution[..., 0] \
            / focal_length[..., 0]
        y = (uv[..., 1] - screen_center[..., 1]) * resolution[..., 1] \
            / focal_length[..., 1]
        if lens_mode == LENS_OPENCV:
            x, y = iterative_lens_undistortion(
                lens_params, x, y, opencv_lens_distortion_delta)
        elif lens_mode == LENS_OPENCV_FISHEYE:
            x, y = iterative_lens_undistortion(
                lens_params, x, y, opencv_fisheye_lens_distortion_delta)
        dir = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)

    if distortion_map is not None:
        # trained lens-distortion offsets on the image plane (uv_to_ray's
        # `dir.xy() += distortion.at_lerp(uv)`; testbed.cu:3781-3792)
        from .ops.trainable_buffer import bilerp_2d

        delta = bilerp_2d(distortion_map, uv)
        dir = dir.at[..., :2].add(delta)

    rot = camera_matrix[..., :3, :3]
    dir = jnp.einsum("...ij,...j->...i", rot, dir, precision=_HIGHEST)
    origin = jnp.broadcast_to(camera_matrix[..., :3, 3], dir.shape)

    if aperture_size != 0.0 and aperture_samples is not None:
        lookat = origin + dir * focus_z
        blur = aperture_size * square2disk_shirley(aperture_samples * 2.0 - 1.0)
        origin = origin + jnp.einsum("...ij,...j->...i", rot[..., :2], blur,
                                     precision=_HIGHEST)
        dir = (lookat - origin) / focus_z

    origin = origin + dir * near_distance
    return origin, dir, valid


def pos_to_uv(pos: jax.Array, resolution, focal_length: jax.Array,
              camera_matrix: jax.Array, screen_center=(0.5, 0.5),
              lens_mode: int = LENS_PERSPECTIVE,
              lens_params: Optional[jax.Array] = None
              ) -> Tuple[jax.Array, jax.Array]:
    """World pos (..., 3) → (uv (..., 2), z_cam) forward projection."""
    resolution = jnp.asarray(resolution, jnp.float32)
    screen_center = jnp.asarray(screen_center, jnp.float32)
    rot = camera_matrix[..., :3, :3]
    origin = camera_matrix[..., :3, 3]
    d = pos - origin
    d_cam = jnp.einsum("...ji,...j->...i", rot, d,  # R^T (orthonormal)
                       precision=_HIGHEST)
    z = d_cam[..., 2]
    safe_z = jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)
    x = d_cam[..., 0] / safe_z
    y = d_cam[..., 1] / safe_z
    if lens_mode == LENS_OPENCV:
        du, dv = opencv_lens_distortion_delta(lens_params, x, y)
        x, y = x + du, y + dv
    elif lens_mode == LENS_OPENCV_FISHEYE:
        du, dv = opencv_fisheye_lens_distortion_delta(lens_params, x, y)
        x, y = x + du, y + dv
    u = x * focal_length[..., 0] / resolution[..., 0] + screen_center[..., 0]
    v = y * focal_length[..., 1] / resolution[..., 1] + screen_center[..., 1]
    return jnp.stack([u, v], axis=-1), z


def square2disk_shirley(s: jax.Array) -> jax.Array:
    """Shirley's concentric square→disk map (random_val.cuh)."""
    x, y = s[..., 0], s[..., 1]
    use_x = jnp.abs(x) > jnp.abs(y)
    safe = lambda a: jnp.where(jnp.abs(a) < 1e-12, 1e-12, a)
    r = jnp.where(use_x, x, y)
    phi = jnp.where(use_x, (jnp.pi / 4) * (y / safe(x)),
                    (jnp.pi / 2) - (jnp.pi / 4) * (x / safe(y)))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


# ---------------------------------------------------------------------------
# Camera interpolation / rolling shutter
# ---------------------------------------------------------------------------

def _mat3_slerp(a: jax.Array, b: jax.Array, t: jax.Array) -> jax.Array:
    """Rotation slerp via quaternions, vectorized; t broadcastable."""
    qa = _mat3_to_quat(a)
    qb = _mat3_to_quat(b)
    dot = jnp.sum(qa * qb, axis=-1, keepdims=True)
    qb = jnp.where(dot < 0, -qb, qb)
    dot = jnp.abs(dot)
    # nlerp fallback for nearly-parallel, slerp otherwise
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    near = sin_theta < 1e-5
    w_a = jnp.where(near, 1.0 - t, jnp.sin((1.0 - t) * theta)
                    / jnp.where(near, 1.0, sin_theta))
    w_b = jnp.where(near, t, jnp.sin(t * theta)
                    / jnp.where(near, 1.0, sin_theta))
    q = w_a * qa + w_b * qb
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return _quat_to_mat3(q)


def _mat3_to_quat(m: jax.Array) -> jax.Array:
    """(..., 3, 3) column-major rotation → (..., 4) quaternion (w,x,y,z).

    Branch-free Shepperd's method: compute all four candidate forms and
    select the numerically best by the largest diagonal combination."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-12))

    # candidate 0: w largest
    s0 = safe_sqrt(tr + 1.0) * 2
    q0 = jnp.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                    (m10 - m01) / s0], axis=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2
    q1 = jnp.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                    (m02 + m20) / s1], axis=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2
    q2 = jnp.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                    (m12 + m21) / s2], axis=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2
    q3 = jnp.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                    0.25 * s3], axis=-1)

    cond0 = tr > 0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = jnp.where(cond0[..., None], q0,
                  jnp.where(cond1[..., None], q1,
                            jnp.where(cond2[..., None], q2, q3)))
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def _quat_to_mat3(q: jax.Array) -> jax.Array:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], axis=-1)
    row1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], axis=-1)
    row2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def camera_slerp(a: jax.Array, b: jax.Array, t: jax.Array) -> jax.Array:
    """(..., 3, 4) camera lerp: rotation slerp + translation mix
    (common_device.cuh:628-632)."""
    t = jnp.asarray(t)[..., None, None]
    rot = _mat3_slerp(a[..., :3, :3], b[..., :3, :3], t[..., 0])
    trans = a[..., :3, 3:] * (1 - t) + b[..., :3, 3:] * t
    return jnp.concatenate([rot, trans], axis=-1)


def xform_with_rolling_shutter(xform_start: jax.Array, xform_end: jax.Array,
                               rolling_shutter: jax.Array, uv: jax.Array,
                               motionblur_time: jax.Array) -> jax.Array:
    """Per-pixel camera matrix at t = A + B*u + C*v + D*mb
    (get_xform_given_rolling_shutter, common_device.cuh:633-637)."""
    t = (rolling_shutter[..., 0]
         + rolling_shutter[..., 1] * uv[..., 0]
         + rolling_shutter[..., 2] * uv[..., 1]
         + rolling_shutter[..., 3] * motionblur_time)
    return camera_slerp(xform_start, xform_end, t)
