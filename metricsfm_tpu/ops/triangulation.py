"""Multi-view triangulation kernels.

Re-design of the reference Point3D triangulators
(SfM/src/structure.cc:163-265) and the parallax gate
(structure.cc:325-355).  Tracks are fixed-shape masked tensors: a track of
up to V views is (poses (V,6), intrs (V,3), obs (V,2), mask (V,)).  Batch
over tracks with vmap — this is how "20k new points per step" becomes one
XLA call instead of 20k heap objects.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import projection

_EPS = 1e-10


def triangulate_dlt(poses, intrs, obs, mask):
    """Masked multiview DLT (reference Trianglate, structure.cc:163-209).

    Row pair per view (centered coords x,y, focal f, M = [R|t]):
        (-f*M1 + y*M3) X = 0
        ( f*M0 - x*M3) X = 0
    Solved via the normal equations A^T A (4x4 symmetric eigendecomposition)
    instead of a tall SVD — masked rows contribute zero, so variable view
    counts need no dynamic shapes.

    Args:
      poses: (V, 6), intrs: (V, 3), obs: (V, 2), mask: (V,) bool/float.
    Returns:
      xyz: (3,) triangulated world point.
    """
    R = jax.vmap(lambda p: projection.pose_to_Rt(p)[0])(poses)   # (V,3,3)
    t = poses[:, 3:6]
    M = jnp.concatenate([R, t[:, :, None]], axis=-1)             # (V,3,4)
    f = intrs[:, 0]
    x, y = obs[:, 0], obs[:, 1]
    row0 = -f[:, None] * M[:, 1, :] + y[:, None] * M[:, 2, :]    # (V,4)
    row1 = f[:, None] * M[:, 0, :] - x[:, None] * M[:, 2, :]
    A = jnp.concatenate([row0, row1], axis=0)                    # (2V,4)
    m = jnp.concatenate([mask, mask], axis=0).astype(A.dtype)[:, None]
    # row normalization improves conditioning (f can be ~1e3)
    A = A / jnp.maximum(jnp.linalg.norm(A, axis=-1, keepdims=True), _EPS)
    A = A * m
    AtA = A.T @ A
    # smallest-eigenvector of 4x4 symmetric matrix
    w, V4 = jnp.linalg.eigh(AtA)
    h = V4[:, 0]
    xyz = h[:3] / jnp.where(jnp.abs(h[3]) < _EPS, _EPS, h[3])
    return xyz


def triangulate_midpoint(poses, intrs, obs, mask):
    """Masked ray-midpoint triangulation (reference Trianglate2,
    structure.cc:211-265): least-squares point closest to all viewing rays,
    solved from sum_i (I - d_i d_i^T) X = sum_i (I - d_i d_i^T) o_i.
    """
    origins, dirs = jax.vmap(projection.backproject_ray)(poses, intrs, obs)
    m = mask.astype(poses.dtype)[:, None, None]
    eye = jnp.eye(3, dtype=poses.dtype)
    P = (eye[None] - dirs[:, :, None] * dirs[:, None, :]) * m    # (V,3,3)
    A = jnp.sum(P, axis=0)
    b = jnp.sum(jnp.einsum("vij,vj->vi", P, origins), axis=0)
    # 3x3 solve with Tikhonov guard against parallel rays
    A = A + 1e-8 * eye
    return jnp.linalg.solve(A, b)


def triangulation_angle_deg(poses, xyz, mask):
    """Max pairwise parallax angle (deg) between viewing rays to xyz.

    Reference SufficientTriangulationAngle (structure.cc:325-355) checks the
    max angle across camera pairs against a threshold.
    """
    centers = jax.vmap(projection.camera_center)(poses)           # (V,3)
    rays = xyz[None, :] - centers
    rays = rays / jnp.maximum(jnp.linalg.norm(rays, axis=-1, keepdims=True), _EPS)
    cosang = jnp.clip(rays @ rays.T, -1.0, 1.0)
    ang = jnp.degrees(jnp.arccos(cosang))
    pair_mask = mask[:, None] * mask[None, :]
    ang = jnp.where(pair_mask > 0, ang, 0.0)
    return jnp.max(ang)


def track_reprojection_mse(poses, intrs, obs, mask, xyz):
    """Per-track masked reprojection MSE in px^2 (reference structure.cc:267-300)."""
    uv, z = jax.vmap(lambda p, i: projection.project(p, i, xyz))(poses, intrs)
    err2 = jnp.sum((uv - obs) ** 2, axis=-1)
    w = mask.astype(err2.dtype)
    return jnp.sum(err2 * w) / jnp.maximum(jnp.sum(w), 1.0)


def cheirality_mask(poses, xyz, mask):
    """Views where the point is in front of the camera (z > 0)."""
    z = jax.vmap(lambda p: projection.transform_to_camera(p, xyz)[..., 2])(poses)
    return jnp.logical_and(mask > 0, z > 0)


def triangulate_and_gate(poses, intrs, obs, mask, th_error_px, th_angle_deg,
                         method: str = "midpoint"):
    """Triangulate one track and apply the reference acceptance gates.

    Returns (xyz, ok, mse): ok mirrors Trianglate2's return — reprojection
    RMSE <= th_error_px AND parallax >= th_angle_deg AND >=2 valid views AND
    cheirality in all valid views.
    """
    tri = triangulate_midpoint if method == "midpoint" else triangulate_dlt
    xyz = tri(poses, intrs, obs, mask)
    mse = track_reprojection_mse(poses, intrs, obs, mask, xyz)
    angle = triangulation_angle_deg(poses, xyz, mask)
    nviews = jnp.sum(mask.astype(jnp.int32))
    front = cheirality_mask(poses, xyz, mask)
    all_front = jnp.sum(front.astype(jnp.int32)) == nviews
    ok = (jnp.sqrt(mse) <= th_error_px) & (angle >= th_angle_deg) \
        & (nviews >= 2) & all_front
    return xyz, ok, mse


# Batched entry points -------------------------------------------------------

_triangulate_tracks_vmap = jax.vmap(triangulate_and_gate,
                                    in_axes=(0, 0, 0, 0, None, None, None))

# jitted: an un-jitted vmap executes the ~60-primitive chain op by op —
# one device dispatch per primitive per call.  `method` (arg 6) is static.
triangulate_tracks = jax.jit(_triangulate_tracks_vmap, static_argnums=(6,))


def _triangulate_indexed(pose_table, intr_table, cam_idx, obs, mask,
                         th_error_px, th_angle_deg, method):
    poses = pose_table[cam_idx]
    intrs = intr_table[cam_idx]
    return _triangulate_tracks_vmap(poses, intrs, obs, mask, th_error_px,
                                    th_angle_deg, method)


# jitted with the device-side table gather fused in (one dispatch)
triangulate_tracks_indexed = jax.jit(_triangulate_indexed,
                                     static_argnums=(7,))
triangulate_tracks_indexed.__doc__ = """\
triangulate_tracks with per-view poses/intrs GATHERED ON DEVICE from
small (R, 6)/(R, 3) tables by (P, V) int32 camera rows.

The host uploads ~a quarter of the bytes of the materialized form
(indices instead of duplicated 6+3-float rows per view)."""


def triangulate_two_view(pose1, intr1, uv1, pose2, intr2, uv2):
    """Convenience two-view midpoint triangulation for (N,) match arrays."""
    def one(u1, u2):
        poses = jnp.stack([pose1, pose2])
        intrs = jnp.stack([intr1, intr2])
        obs = jnp.stack([u1, u2])
        mask = jnp.ones((2,), dtype=pose1.dtype)
        return triangulate_midpoint(poses, intrs, obs, mask)
    return jax.vmap(one)(uv1, uv2)
