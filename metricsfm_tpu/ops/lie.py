"""SO(3) parameterizations: rotation matrix <-> angle-axis <-> quaternion <-> Euler.

Re-design of the reference's rotation conversions
(SfM/src/utils/basic_funcs.h:201-219) and the dual pose bookkeeping in
Camera (SfM/src/camera.cc:43-137).  All functions are pure, batched-friendly
(vmap over leading axes), and numerically safe at the theta->0 limit via
Taylor expansions (needed for autodiff through the BA residuals).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jnp.ndarray) -> jnp.ndarray:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ v == cross(w, v)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack([
        jnp.stack([zeros, -wz, wy], axis=-1),
        jnp.stack([wz, zeros, -wx], axis=-1),
        jnp.stack([-wy, wx, zeros], axis=-1),
    ], axis=-2)


def angle_axis_to_matrix(aa: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula with small-angle Taylor fallback.

    R = I + sin(t)/t * hat(aa) + (1-cos(t))/t^2 * hat(aa)^2, t = |aa|.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)[..., None]  # (...,1,1)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    # safe coefficients: sin(t)/t -> 1 - t^2/6, (1-cos t)/t^2 -> 1/2 - t^2/24
    small = theta2 < 1e-8
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = hat(aa)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=aa.dtype), K.shape)
    return eye + a * K + b * (K @ K)


def matrix_to_angle_axis(R: jnp.ndarray) -> jnp.ndarray:
    """Log map SO(3) -> R^3 via quaternion (stable near 0 and pi)."""
    return quaternion_to_angle_axis(matrix_to_quaternion(R))


def matrix_to_quaternion(R: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z), branch-free.

    Uses the four-candidate construction (one per diagonal dominance case)
    and selects the numerically largest denominator with jnp.where — the
    XLA-friendly analogue of Shepperd's branching method.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # candidate squared components *4
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, _EPS))

    # case w-dominant
    sw = safe_sqrt(qw2) * 2.0
    cand_w = jnp.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                        (m10 - m01) / sw], axis=-1)
    sx = safe_sqrt(qx2) * 2.0
    cand_x = jnp.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                        (m02 + m20) / sx], axis=-1)
    sy = safe_sqrt(qy2) * 2.0
    cand_y = jnp.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                        (m12 + m21) / sy], axis=-1)
    sz = safe_sqrt(qz2) * 2.0
    cand_z = jnp.stack([(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz,
                        0.25 * sz], axis=-1)

    mags = jnp.stack([qw2, qx2, qy2, qz2], axis=-1)
    best = jnp.argmax(mags, axis=-1)[..., None]
    cands = jnp.stack([cand_w, cand_x, cand_y, cand_z], axis=-2)  # (...,4,4)
    q = jnp.take_along_axis(cands, best[..., None], axis=-2)[..., 0, :]
    # canonical sign: w >= 0
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quaternion_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], axis=-1)
    row1 = jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], axis=-1)
    row2 = jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def quaternion_to_angle_axis(q: jnp.ndarray) -> jnp.ndarray:
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0 => theta in [0, pi]
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = jnp.linalg.norm(v, axis=-1, keepdims=True)
    theta = 2.0 * jnp.arctan2(vnorm[..., 0], w)[..., None]
    # aa = theta * v / |v|; small-angle: 2*v (since q ~ [1, aa/2])
    scale = jnp.where(vnorm < 1e-6, 2.0, theta / jnp.maximum(vnorm, _EPS))
    return v * scale


def angle_axis_to_quaternion(aa: jnp.ndarray) -> jnp.ndarray:
    theta = jnp.linalg.norm(aa, axis=-1, keepdims=True)
    half = 0.5 * theta
    # sin(t/2)/t with Taylor fallback 1/2 - t^2/48
    small = theta < 1e-6
    s = jnp.where(small, 0.5 - theta * theta / 48.0, jnp.sin(half) / jnp.maximum(theta, _EPS))
    w = jnp.where(small, 1.0 - half * half / 2.0, jnp.cos(half))
    return jnp.concatenate([w, aa * s], axis=-1)


def rotate_point(aa: jnp.ndarray, p: jnp.ndarray) -> jnp.ndarray:
    """Rotate p by the rotation whose angle-axis is aa, without forming R.

    Matches the Ceres AngleAxisRotatePoint semantics the reference's residual
    functors use (utils/reprojection_error_pose_cam_xyz.h:36).  Differentiable
    at theta = 0.
    """
    theta2 = jnp.sum(aa * aa, axis=-1, keepdims=True)
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    axis = aa / theta
    w_cross_p = jnp.cross(axis, p)
    w_dot_p = jnp.sum(axis * p, axis=-1, keepdims=True)
    rotated = p * cos_t + w_cross_p * sin_t + axis * w_dot_p * (1.0 - cos_t)
    # small-angle: p + aa x p
    approx = p + jnp.cross(aa, p)
    return jnp.where(small, approx, rotated)


def euler_zyx_to_matrix(euler: jnp.ndarray) -> jnp.ndarray:
    """Euler (roll=x, pitch=y, yaw=z) -> R = Rz @ Ry @ Rx."""
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)
    row0 = jnp.stack([cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx], axis=-1)
    row1 = jnp.stack([sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx], axis=-1)
    row2 = jnp.stack([-sy, cy * sx, cy * cx], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_euler_zyx(R: jnp.ndarray) -> jnp.ndarray:
    sy = -R[..., 2, 0]
    pitch = jnp.arcsin(jnp.clip(sy, -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def euler_xyz_to_matrix(euler: jnp.ndarray) -> jnp.ndarray:
    """Euler (rx, ry, rz) -> R = Rx @ Ry @ Rz (X-Y-Z intrinsic order).

    This is the convention of the reference's EulerAnglesToRotationMatrix /
    RotationMatrixToEulerAngles pair used by the MSP `.qin` writer
    (SfM/src/utils/basic_funcs.cc:245-249): R02 = sin(ry),
    R12 = -sin(rx)cos(ry), R01 = -cos(ry)sin(rz).
    """
    rx, ry, rz = euler[..., 0], euler[..., 1], euler[..., 2]
    cx, sx = jnp.cos(rx), jnp.sin(rx)
    cy, sy = jnp.cos(ry), jnp.sin(ry)
    cz, sz = jnp.cos(rz), jnp.sin(rz)
    row0 = jnp.stack([cy * cz, -cy * sz, sy], axis=-1)
    row1 = jnp.stack([cx * sz + sx * sy * cz, cx * cz - sx * sy * sz,
                      -sx * cy], axis=-1)
    row2 = jnp.stack([sx * sz - cx * sy * cz, sx * cz + cx * sy * sz,
                      cx * cy], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def matrix_to_euler_xyz(R: jnp.ndarray) -> jnp.ndarray:
    """Inverse of euler_xyz_to_matrix — the reference's
    RotationMatrixToEulerAngles (SfM/src/utils/basic_funcs.cc:245-249):
    rx = atan2(-R12, R22), ry = asin(R02), rz = atan2(-R01, R00)."""
    rx = jnp.arctan2(-R[..., 1, 2], R[..., 2, 2])
    ry = jnp.arcsin(jnp.clip(R[..., 0, 2], -1.0, 1.0))
    rz = jnp.arctan2(-R[..., 0, 1], R[..., 0, 0])
    return jnp.stack([rx, ry, rz], axis=-1)


def project_to_so3(M: jnp.ndarray) -> jnp.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD with det correction."""
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate([
        jnp.ones_like(det)[..., None],
        jnp.ones_like(det)[..., None],
        det[..., None],
    ], axis=-1)
    return (U * D[..., None, :]) @ Vt
