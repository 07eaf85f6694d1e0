"""Two-view epipolar geometry: F/E estimation, focal recovery, decomposition.

Re-design of the reference solvers
(SfM/src/orientation/fundamental_matrix_eight_point.{h,cc},
 essential_matrix_five_point.{h,cc},
 relative_pose_from_fundamental_matrix.{h,cc},
 relative_pose_from_essential_matrix.{h,cc},
 relative_pose_estimation.{h,cc}).

Design notes (SURVEY.md §7):
* Convention: x2^T F x1 = 0 with homogeneous centered pixels x = (u, v, 1).
* Hypotheses are generated *in batch* (vmap over sampled minimal sets) and
  scored against all correspondences with one einsum — the batched
  replacement for the reference's sequential RANSAC loops.
* The essential solver is the normalized 8-point system followed by SVD
  projection onto the essential manifold (sigma = (1,1,0)).  This replaces
  the Nister 5-point solver: the polynomial eigen-solve does not batch
  well under XLA while extra RANSAC hypotheses are nearly free, so a
  non-minimal sample with a bigger hypothesis budget is the batched design.
* Focal-from-F uses the Bougnoux closed form (centered principal points),
  replacing the reference's epipole-rotation construction
  (relative_pose_from_fundamental_matrix.cc:56-123).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from . import lie

_EPS = 1e-12


def _homog(x):
    return jnp.concatenate([x, jnp.ones_like(x[..., :1])], axis=-1)


def normalize_points(pts):
    """Hartley normalization: translate centroid to origin, mean dist sqrt(2).

    Returns (pts_n, T) with x_n = T x (homogeneous 3x3 T).
    """
    centroid = jnp.mean(pts, axis=-2, keepdims=True)
    d = jnp.linalg.norm(pts - centroid, axis=-1)
    scale = jnp.sqrt(2.0) / jnp.maximum(jnp.mean(d, axis=-1), _EPS)
    cx, cy = centroid[..., 0, 0], centroid[..., 0, 1]
    zero = jnp.zeros_like(scale)
    one = jnp.ones_like(scale)
    T = jnp.stack([
        jnp.stack([scale, zero, -scale * cx], axis=-1),
        jnp.stack([zero, scale, -scale * cy], axis=-1),
        jnp.stack([zero, zero, one], axis=-1),
    ], axis=-2)
    pts_n = (pts - centroid) * scale[..., None, None]
    return pts_n, T


def _smallest_right_singular(A):
    """Unit vector minimizing |A v| via eigh of A^T A (batches under vmap)."""
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    _, V = jnp.linalg.eigh(AtA)
    return V[..., :, 0]


def _nullvec_minimal(A):
    """Exact null vector of a MINIMAL (..., k, k+1) linear system via k
    unrolled Householder reflections (QR of A^T; the null vector is the
    last column of Q).

    XLA's batched eigh/SVD on tiny matrices lowers to sequential loops
    or solver-library calls per matrix; k unrolled reflector applications
    are pure batched FMAs.  (A shifted power iteration was tried first and is NOT
    usable here: the spectral gap ratio (sigma - l8)/sigma of a minimal
    sample is ~1, so 64 iterations leave ~70% of the off-null component
    — measured as a 4x inlier-count collapse.)  Exact for rank-k
    samples; rank-deficient (degenerate) samples produce an arbitrary
    null-space vector, which consensus scoring discards.
    """
    k, k1 = A.shape[-2], A.shape[-1]
    At = jnp.swapaxes(A, -1, -2)                       # (..., k+1, k)
    vs = []
    R = At
    for c in range(k):
        x = R[..., :, c]
        # zero the already-eliminated entries so the reflector acts on
        # the trailing subvector only
        rows = jnp.arange(k1)
        live = (rows >= c).astype(A.dtype)
        x = x * live
        alpha = jnp.sqrt(jnp.sum(x * x, axis=-1, keepdims=True) + _EPS)
        sign = jnp.where(x[..., c:c + 1] >= 0, 1.0, -1.0)
        v = x + sign * alpha * (rows == c).astype(A.dtype)
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True),
                            _EPS)
        vs.append(v)
        R = R - 2.0 * v[..., :, None] * jnp.sum(
            v[..., :, None] * R, axis=-2, keepdims=True)
    # null vector = Q e_{k+1} = H_1 ... H_k e_{k+1}
    u = jnp.zeros(A.shape[:-2] + (k1,), A.dtype
                  ).at[..., k1 - 1].set(1.0)
    for v in reversed(vs):
        u = u - 2.0 * v * jnp.sum(v * u, axis=-1, keepdims=True)
    return u


def _rank2_project(F):
    """Zero the smallest singular value of (..., 3, 3) F without an SVD.

    v3 (smallest right-singular vector) via the ADJUGATE: adj(F) =
    V diag(s2 s3, s1 s3, s1 s2) U^T, so as s3 -> 0 the adjugate collapses
    to s1 s2 v3 u3^T and every column aligns with v3 up to O(s3/s2).
    The columns of adj(F) are the cross products of row pairs of F; take
    the largest.  Then F - (F v3) v3^T removes the v3 input direction —
    equal to U diag(s1, s2, 0) V^T up to the same O(s3/s2) error, which
    consensus scoring absorbs (8-point solutions have small s3 unless
    the sample is outlier-ridden, and those lose the vote anyway)."""
    r0, r1, r2 = F[..., 0, :], F[..., 1, :], F[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1, keepdims=True)
    n02 = jnp.sum(c02 * c02, axis=-1, keepdims=True)
    n12 = jnp.sum(c12 * c12, axis=-1, keepdims=True)
    best = jnp.where(n01 >= jnp.maximum(n02, n12), c01,
                     jnp.where(n02 >= n12, c02, c12))
    v3 = best / jnp.maximum(
        jnp.linalg.norm(best, axis=-1, keepdims=True), _EPS)
    Fv = jnp.einsum("...ij,...j->...i", F, v3)
    return F - Fv[..., :, None] * v3[..., None, :]


def fundamental_8pt(pts1, pts2, weights=None, exact: bool = True):
    """Hartley-normalized 8-point fundamental matrix.

    Args:
      pts1, pts2: (..., N, 2) centered pixel correspondences, N >= 8.
      weights: optional (..., N) row weights (0 masks a row) — enables
        masked non-minimal refits on inlier sets without dynamic shapes.
      exact: True = eigh/SVD decompositions (refits, seed paths);
        False = unrolled Householder-QR null vector (exact for minimal
        8-row samples) + adjugate rank-2 projection — no tiny-matrix
        LAPACK calls, built for the vmapped RANSAC hypothesis solves.
        Requires N == 8; larger systems fall back to the exact path.
    Returns:
      F: (..., 3, 3) with x2^T F x1 = 0, rank-2 enforced, |F| = 1.
    """
    p1n, T1 = normalize_points(pts1)
    p2n, T2 = normalize_points(pts2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = jnp.ones_like(x1)
    A = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                  axis=-1)  # (..., N, 9)
    if weights is not None:
        A = A * weights[..., None]
    exact = exact or pts1.shape[-2] != 8
    if exact:
        f = _smallest_right_singular(A)
    else:
        f = _nullvec_minimal(A)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # enforce rank 2
    if exact:
        U, S, Vt = jnp.linalg.svd(F)
        S = S.at[..., 2].set(0.0)
        F = (U * S[..., None, :]) @ Vt
    else:
        F = _rank2_project(F)
    # denormalize: x2n^T F x1n = 0 with xn = T x  =>  F_px = T2^T F T1
    F = jnp.swapaxes(T2, -1, -2) @ F @ T1
    norm = jnp.linalg.norm(F.reshape(*F.shape[:-2], 9), axis=-1)
    return F / jnp.maximum(norm[..., None, None], _EPS)


def essential_8pt(norm1, norm2, weights=None, exact: bool = True):
    """Essential matrix from >=8 K-normalized correspondences.

    8-point linear system + SVD projection to the essential manifold
    (singular values (1,1,0)).  Non-minimal by design — see module
    docstring.  exact=False (RANSAC hypothesis path) returns the rank-2
    F without the manifold projection: Sampson scoring is F-scale
    invariant and consensus absorbs the sigma1/sigma2 mismatch; the
    winner's refit re-projects exactly.
    """
    F = fundamental_8pt(norm1, norm2, weights, exact=exact)
    if not exact:
        return F
    U, S, Vt = jnp.linalg.svd(F)
    s = (S[..., 0] + S[..., 1]) * 0.5
    S_e = jnp.stack([s, s, jnp.zeros_like(s)], axis=-1)
    return (U * S_e[..., None, :]) @ Vt


def sampson_distance(F, pts1, pts2):
    """First-order geometric (Sampson) distance, (..., N).

    d = (x2^T F x1)^2 / ((Fx1)_0^2 + (Fx1)_1^2 + (F^T x2)_0^2 + (F^T x2)_1^2)
    Matches the reference's RANSAC scoring (essential_matrix_five_point.cc,
    feature_matching_essential.cpp:27-111).
    """
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    num = jnp.einsum("...ni,...ni->...n", x2, Fx1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / jnp.maximum(den, _EPS)


def epipolar_distance(F, pts1, pts2):
    """Symmetric point-to-epipolar-line distance in px (..., N).

    The reference's re-filter metric (fine_matching_graph.cc:137-147,
    geo_verification.cc:60-79).
    """
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, x2)
    val = jnp.abs(jnp.einsum("...ni,...ni->...n", x2, Fx1))
    d1 = val / jnp.maximum(jnp.sqrt(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2), _EPS)
    d2 = val / jnp.maximum(jnp.sqrt(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2), _EPS)
    return 0.5 * (d1 + d2)


def focals_from_fundamental(F, scale_hint: float = 1000.0):
    """Focal lengths from F via the linear Kruppa equations (centered pp).

    Replaces the reference's epipole-rotation construction
    (relative_pose_from_fundamental_matrix.cc:56-123).  With principal
    points at the origin, the Kruppa constraint
        F w1* F^T = lam * [e2]x w2* [e2]x^T,   wi* = diag(fi^2, fi^2, 1)
    is *linear* in (f1^2, lam*f2^2, lam): a 6x3 least-squares solve over the
    symmetric upper triangle.  Exact on noise-free data; degenerate when the
    optical axes are coplanar (cameras fixating a common point), in which
    case `valid` is usually still True but focals are unreliable — callers
    gate on downstream reprojection error as the reference does.

    Returns (f1, f2, valid): valid is False when a squared focal comes out
    non-positive.

    `scale_hint` (~expected focal in px) rescales pixels so the unknowns are
    O(1) — without it the f32 normal equations span ~12 orders of magnitude
    and the solve is garbage in f32.
    """
    # work in scaled pixel units: x' = diag(1/s,1/s,1) x  =>  F' = D F D, D=diag(s,s,1)
    s = jnp.asarray(scale_hint, F.dtype)
    D = jnp.stack([s, s, jnp.ones_like(s)])
    F = F * D[..., :, None] * D[..., None, :]
    F = F / jnp.maximum(jnp.linalg.norm(F, axis=(-2, -1), keepdims=True), _EPS)

    p = jnp.array([0.0, 0.0, 1.0], dtype=F.dtype)
    I2 = jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype=F.dtype))
    Ft = jnp.swapaxes(F, -1, -2)
    # epipole in image 2: F^T e2 = 0
    e2 = _smallest_right_singular(Ft[None] if F.ndim == 2 else Ft)
    if F.ndim == 2:
        e2 = e2[0]
    e2x = lie.hat(e2)
    e2xt = jnp.swapaxes(e2x, -1, -2)

    M1 = F @ I2 @ Ft
    M2 = e2x @ I2 @ e2xt
    v2 = jnp.einsum("...ij,j->...i", e2x, p)
    M3 = v2[..., :, None] * v2[..., None, :]
    v0 = jnp.einsum("...ij,j->...i", F, p)
    M0 = v0[..., :, None] * v0[..., None, :]

    iu = jnp.triu_indices(3)
    A = jnp.stack([M1[..., iu[0], iu[1]], -M2[..., iu[0], iu[1]],
                   -M3[..., iu[0], iu[1]]], axis=-1)      # (..., 6, 3)
    b = -M0[..., iu[0], iu[1]]                            # (..., 6)
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    Atb = jnp.einsum("...ki,...k->...i", A, b)
    eye3 = jnp.eye(3, dtype=F.dtype)
    x = jnp.linalg.solve(AtA + 1e-12 * eye3, Atb)
    f1s = x[..., 0]
    lam = x[..., 2]
    lam = jnp.where(jnp.abs(lam) < _EPS, _EPS, lam)
    f2s = x[..., 1] / lam
    valid = (f1s > 0) & (f2s > 0)
    f1 = jnp.sqrt(jnp.maximum(f1s, _EPS)) * s
    f2 = jnp.sqrt(jnp.maximum(f2s, _EPS)) * s
    return f1, f2, valid


def essential_from_fundamental(F, f1, f2):
    """E = K2^T F K1 with K = diag(f, f, 1) (ref relative_pose_from_fundamental_matrix.cc:125-136)."""
    K1 = jnp.diag(jnp.array([1.0, 1.0, 1.0], dtype=F.dtype))
    K1 = jnp.stack([f1, f1, jnp.ones_like(f1)], axis=-1)
    K2 = jnp.stack([f2, f2, jnp.ones_like(f2)], axis=-1)
    # K2^T F K1 with diagonal K's = row scale by K2, col scale by K1
    return F * K2[..., :, None] * K1[..., None, :]


def decompose_essential(E, norm1, norm2, mask=None):
    """E -> (R, t) by SVD + cheirality voting over the 4 candidates.

    Reference relative_pose_from_essential_matrix.h:35-40.  norm1/norm2 are
    K-normalized correspondences used to vote; mask selects valid rows.
    Returns (R, t, n_front) for the winning candidate, with |t| = 1 and the
    convention x2 ~ R x1 + t (pose of cam2 in cam1 frame = world frame of
    cam1).
    """
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    d = jnp.linalg.det(U @ Vt)
    Vt = Vt * jnp.where(d < 0, -1.0, 1.0)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., :, 2]

    def count_front(R, tt):
        # triangulate by midpoint in cam1 frame: cam1 = [I|0], cam2 = [R|tt]
        z1, z2 = _two_view_depths(R, tt, norm1, norm2)
        ok = (z1 > 0) & (z2 > 0)
        if mask is not None:
            ok = ok & (mask > 0)
        return jnp.sum(ok.astype(jnp.int32))

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    votes = jnp.stack([count_front(R, tt) for R, tt in cands])
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    best = jnp.argmax(votes)
    return Rs[best], ts[best], votes[best]


def _two_view_depths(R, t, norm1, norm2):
    """Depths of linear-triangulated points for cams [I|0] and [R|t].

    Vectorized midpoint: for rays d1 = (x1,1)/|.|, d2_world = R^T (x2,1)/|.|
    from centers 0 and c2 = -R^T t, solve the 2x2 system for ray params.
    """
    d1 = _homog(norm1)
    d1 = d1 / jnp.linalg.norm(d1, axis=-1, keepdims=True)
    d2c = _homog(norm2)
    d2c = d2c / jnp.linalg.norm(d2c, axis=-1, keepdims=True)
    d2 = jnp.einsum("ji,nj->ni", R, d2c)
    c2 = -jnp.einsum("ji,j->i", R, t)
    # [a -b; -b c] [s; u] = [d1.(c2), -d2.(c2-0)] for closest points
    b_ = jnp.einsum("ni,ni->n", d1, d2)
    rhs1 = jnp.einsum("ni,i->n", d1, c2)
    rhs2 = jnp.einsum("ni,i->n", d2, c2)
    det = 1.0 - b_ * b_
    det = jnp.where(jnp.abs(det) < _EPS, _EPS, det)
    s = (rhs1 - b_ * rhs2) / det         # param along ray 1 == depth z1 * |d1|
    u = (b_ * rhs1 - rhs2) / det
    X = d1 * s[..., None]                # point on ray1 (cam1/world frame)
    z1 = X[..., 2] / jnp.maximum(d1[..., 2], _EPS) * d1[..., 2]  # = s * d1_z / d1_z
    z1 = s * d1[..., 2]
    Xc2 = jnp.einsum("ij,nj->ni", R, X) + t
    z2 = Xc2[..., 2]
    return z1, z2


def relative_pose_known_focal(pts1, pts2, f1, f2, weights=None, mask=None):
    """Calibrated relative pose: normalize by focal, 8pt-E, decompose.

    Reference RelativePoseEstimation with known focals
    (relative_pose_estimation.cc:90-120).
    Returns dict with R, t, E, n_front.
    """
    n1 = pts1 / f1
    n2 = pts2 / f2
    E = essential_8pt(n1, n2, weights)
    R, t, votes = decompose_essential(E, n1, n2, mask)
    return {"R": R, "t": t, "E": E, "n_front": votes}


def relative_pose_unknown_focal(pts1, pts2, weights=None, mask=None,
                                f_hint=None):
    """Uncalibrated path: 8pt-F -> Kruppa focals -> E -> decompose.

    Reference relative_pose_estimation.cc:29-83.  `f_hint` scales the focal
    solve for conditioning; defaults to 3x the pixel spread (~image size,
    the same spirit as the reference's f_hyp = 1.2*max(w,h)).
    Returns dict with R, t, f1, f2, F, valid.
    """
    F = fundamental_8pt(pts1, pts2, weights)
    if f_hint is None:
        f_hint = 3.0 * jnp.maximum(jnp.max(jnp.abs(pts1)), jnp.max(jnp.abs(pts2)))
    f1, f2, valid = focals_from_fundamental(F, f_hint)
    n1 = pts1 / f1
    n2 = pts2 / f2
    E = essential_from_fundamental(F, f1, f2)
    # re-project onto essential manifold for stability
    U, S, Vt = jnp.linalg.svd(E)
    s = (S[..., 0] + S[..., 1]) * 0.5
    E = (U * jnp.stack([s, s, jnp.zeros_like(s)], axis=-1)[..., None, :]) @ Vt
    R, t, votes = decompose_essential(E, n1, n2, mask)
    return {"R": R, "t": t, "f1": f1, "f2": f2, "F": F, "E": E,
            "n_front": votes, "valid": valid}
