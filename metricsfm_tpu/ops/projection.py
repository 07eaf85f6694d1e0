"""Camera model and projection kernels.

Re-design of the reference data model (SfM/src/basic_structs.h:48-145,
camera.{h,cc}, structure.cc:267-300):

* Pose is stored as a 6-vector ``[aa(3), t(3)]`` (world->camera), the same BA
  parameter block layout as the reference's ``Camera::data`` (camera.h:79).
* Intrinsics are a 3-vector ``[f, k1, k2]`` — the reference's
  ``CameraModel::data`` BA block (basic_structs.h:120).
* All image observations are *centered* at the principal point; the whole
  pipeline works in centered coordinates (reference database.cc:522-527).
* Projection follows reprojection_error_pose_cam_xyz.h:40-63:
  ``pred = f * (1 + r2*(k1 + k2*r2)) * (x/z, y/z)`` with +z forward.

Everything is batched: cameras are arrays of shape (..., 6) / (..., 3) and
points (..., 3); vmap/broadcast rules do the rest.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import lie

_EPS = 1e-12


def pose_from_Rt(R: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """(R, t) world->cam  ->  6-vector [angle_axis, t]."""
    return jnp.concatenate([lie.matrix_to_angle_axis(R), t], axis=-1)


def pose_to_Rt(pose: jnp.ndarray):
    return lie.angle_axis_to_matrix(pose[..., :3]), pose[..., 3:6]


def camera_center(pose: jnp.ndarray) -> jnp.ndarray:
    """c = -R^T t (the reference's ACPose.c, camera.cc:67-77)."""
    R, t = pose_to_Rt(pose)
    return -jnp.einsum("...ji,...j->...i", R, t)


def pose_from_center(aa: jnp.ndarray, c: jnp.ndarray) -> jnp.ndarray:
    """Angle-axis + camera center -> [aa, t] with t = -R c."""
    R = lie.angle_axis_to_matrix(aa)
    t = -jnp.einsum("...ij,...j->...i", R, c)
    return jnp.concatenate([aa, t], axis=-1)


def compose_relative(pose_ref: jnp.ndarray, rel: jnp.ndarray) -> jnp.ndarray:
    """World pose of a camera given a reference pose and a relative pose.

    R = R_rel R_ref, t = R_rel t_ref + t_rel (reference camera.cc:55-65).
    """
    R_ref, t_ref = pose_to_Rt(pose_ref)
    R_rel, t_rel = pose_to_Rt(rel)
    R = R_rel @ R_ref
    t = jnp.einsum("...ij,...j->...i", R_rel, t_ref) + t_rel
    return pose_from_Rt(R, t)


def transform_to_camera(pose: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """World -> camera frame: p = R x + t, via direct angle-axis rotation."""
    aa = pose[..., :3]
    t = pose[..., 3:6]
    return lie.rotate_point(aa, points) + t


def distort_radial(xn: jnp.ndarray, k1: jnp.ndarray, k2: jnp.ndarray) -> jnp.ndarray:
    """Apply radial distortion factor (1 + r2*(k1 + k2*r2)) to normalized coords."""
    r2 = jnp.sum(xn * xn, axis=-1, keepdims=True)
    factor = 1.0 + r2 * (k1[..., None] + k2[..., None] * r2)
    return xn * factor


def undistort_radial(xd: jnp.ndarray, k1: jnp.ndarray, k2: jnp.ndarray,
                     iters: int = 8) -> jnp.ndarray:
    """Invert the radial model by fixed-point iteration.

    Replaces the reference's polynomial-root inversion (utils/calibration.cc:17-19)
    with an XLA-friendly fixed iteration count: x <- xd / distortion(|x|^2).
    """
    def body(_, x):
        r2 = jnp.sum(x * x, axis=-1, keepdims=True)
        factor = 1.0 + r2 * (k1[..., None] + k2[..., None] * r2)
        return xd / jnp.maximum(factor, 1e-6)
    return jax.lax.fori_loop(0, iters, body, xd)


def project(pose: jnp.ndarray, intr: jnp.ndarray, points: jnp.ndarray):
    """Project world points into centered pixel coordinates.

    Args:
      pose: (..., 6) [aa, t] world->camera.
      intr: (..., 3) [f, k1, k2].
      points: (..., 3) world points.

    Returns:
      (uv, depth): (..., 2) centered pixels and (...,) camera-frame z.
    """
    p = transform_to_camera(pose, points)
    z = p[..., 2]
    zsafe = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    xn = p[..., :2] / zsafe[..., None]
    f = intr[..., 0]
    xd = distort_radial(xn, intr[..., 1], intr[..., 2])
    uv = f[..., None] * xd
    return uv, z


def reprojection_residual(pose, intr, points, obs, weight=None):
    """Per-observation residual weight*(pred - obs), shape (..., 2).

    Mirrors the reference residual functor exactly
    (reprojection_error_pose_cam_xyz.h:40-69).
    """
    uv, _ = project(pose, intr, points)
    r = uv - obs
    if weight is not None:
        r = r * weight[..., None]
    return r


def reprojection_mse(pose, intr, points, obs, mask=None):
    """Mean squared reprojection error over observations (reference Reprojection(),
    structure.cc:267-300: mse over tracks in px^2)."""
    uv, _ = project(pose, intr, points)
    err2 = jnp.sum((uv - obs) ** 2, axis=-1)
    if mask is None:
        return jnp.mean(err2)
    w = mask.astype(err2.dtype)
    return jnp.sum(err2 * w) / jnp.maximum(jnp.sum(w), 1.0)


def backproject_ray(pose: jnp.ndarray, intr: jnp.ndarray, uv: jnp.ndarray):
    """Centered pixel -> (origin, world unit direction) — ref structure.cc:219-224.

    Ignores distortion (callers undistort first when needed), matching the
    reference's Trianglate2 which uses raw centered observations.
    """
    f = intr[..., 0]
    dir_c = jnp.concatenate([uv, jnp.broadcast_to(f[..., None], uv[..., :1].shape)], axis=-1)
    R, _ = pose_to_Rt(pose)
    dir_w = jnp.einsum("...ji,...j->...i", R, dir_c)
    dir_w = dir_w / jnp.maximum(jnp.linalg.norm(dir_w, axis=-1, keepdims=True), _EPS)
    return camera_center(pose), dir_w


def intrinsic_matrix(intr: jnp.ndarray) -> jnp.ndarray:
    """K for centered coordinates: diag(f, f, 1)."""
    f = intr[..., 0]
    zero = jnp.zeros_like(f)
    one = jnp.ones_like(f)
    row0 = jnp.stack([f, zero, zero], axis=-1)
    row1 = jnp.stack([zero, f, zero], axis=-1)
    row2 = jnp.stack([zero, zero, one], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def projection_matrix(pose: jnp.ndarray, intr: jnp.ndarray) -> jnp.ndarray:
    """P = K [R | t], (..., 3, 4) (reference camera.cc:89-137 caches)."""
    R, t = pose_to_Rt(pose)
    M = jnp.concatenate([R, t[..., None]], axis=-1)
    return intrinsic_matrix(intr) @ M


def apply_similarity_to_pose(pose: jnp.ndarray, s, R_s: jnp.ndarray, t_s: jnp.ndarray):
    """Update a world->cam pose under a world similarity x' = s R_s x + t_s.

    New extrinsics: R' = R R_s^T, t' = t - (1/s) R' t_s... derived so that
    projection of transformed points is preserved up to scale:
    R'(s R_s x + t_s) + t' == s (R x + t). (Reference camera.cc:79-87 updates
    pose under georeferencing similarity.)
    """
    R, t = pose_to_Rt(pose)
    R_new = R @ jnp.swapaxes(R_s, -1, -2)
    t_new = s * t - jnp.einsum("...ij,...j->...i", R_new, t_s)
    return pose_from_Rt(R_new, t_new)
