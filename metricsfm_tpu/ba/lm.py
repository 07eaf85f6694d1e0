"""Schur-complement Levenberg-Marquardt bundle adjuster.

Replaces Ceres DENSE_SCHUR + Huber + autodiff functors
(SfM/src/optimizer.cc:44-135, utils/reprojection_error_*.h) with a
batched device solver:

* Per-observation 2-vector residuals and Jacobians come from one vmapped
  ``jax.jacfwd`` over the (P, V) track tensor — the analogue of Ceres
  autodiff, batched instead of per-block.
* Huber robustness is IRLS: residual/Jacobian rows scaled by
  sqrt(rho'(s)), s = |r|^2 (Ceres' corrector, to first order).
* Elimination: point blocks H_pp are (P, 3, 3) batched inverses; the
  reduced camera system S (6C+3M dofs) is assembled with segment-sums for
  block-diagonals and a scan of static scatters for the track-induced
  camera-camera fill — no dynamic shapes anywhere.
* Mutability masks freeze dofs by zeroing their rows/cols and pinning the
  diagonal, matching the reference's functor-selection matrix semantics
  (optimizer.cc:86-125).
* The LM loop is a ``lax.while_loop`` with accept/reject damping —
  ``solve_lm`` is one jittable call, so "BA iterations/s" is a pure device
  metric.

Multi-chip: see parallel/sharded_ba.py — tracks are sharded over the data
axis and every term of (S, rhs) is a per-shard partial sum combined with
``psum``, which is exactly how the normal equations decompose.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops import projection
from .problem import BAProblem


class LMConfig(NamedTuple):
    max_iterations: int = 100
    huber_delta: float = 1.0
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 2.0
    min_lambda: float = 1e-12
    max_lambda: float = 1e10
    rtol: float = 1e-8
    jacobi_scale: bool = True
    # > 0: solve the reduced camera system with matrix-free block-Jacobi
    # PCG instead of dense Cholesky.  The dense path assembles S via an
    # O(P*C) one-hot factor — fine to a few hundred cameras, OOM at 1k+
    # (19 GB at 1024 cams / 262k pts); the CG path touches only
    # O(P*V) per-track tensors per matvec and scales to thousands of
    # cameras (Agarwal et al., "Bundle Adjustment in the Large": inexact
    # Newton steps keep LM convergence).
    cg_iterations: int = 0
    cg_tol: float = 1e-5
    cg_chunk: int = 4096
    # inexact-Newton forcing sequence (Agarwal et al., BAL §3): the CG
    # relative tolerance starts loose (cg_eta0) and tightens superlinearly
    # (eta <- max(cg_tol, eta^1.5)) on every ACCEPTED LM step — early LM
    # steps far from the optimum don't deserve exact linear solves, and
    # the while_loop'd CG exits early at loose tolerances.
    cg_forcing: bool = True
    cg_eta0: float = 0.25
    # LM iterations per device execution: solve_lm dispatches the while-
    # loop in host chunks of this size so no single XLA execution runs
    # for minutes (ROADMAP design item 3.3 asks whether chunking still
    # pays on a local GPU)
    host_chunk: int = 8
    # observations (P*V) below which the whole solve runs as ONE chunk:
    # small solves are short on the device, and every extra chunk costs a
    # host round trip.  Set 0 to always chunk.
    host_chunk_small_obs: int = 1 << 17


def _residual_one(pose, intr, point, uv):
    """2-vector reprojection residual for one observation."""
    return projection.reprojection_residual(pose, intr, point, uv)


def _obs_jacobians(problem: BAProblem):
    """Residuals + Jacobians for every (P, V) observation slot.

    Returns r (P,V,2), Jpose (P,V,2,6), Jintr (P,V,2,3), Jpt (P,V,2,3),
    all pre-multiplied by sqrt(track_weight) but NOT by robust weights.
    """
    cam = problem.track_cam
    poses = problem.poses[cam]              # (P,V,6)
    intrs = problem.intrs[problem.cam_model[cam]]  # (P,V,3)
    pts = problem.points[:, None, :].repeat(problem.max_views, 1)

    def rj(pose, intr, pt, uv):
        r = _residual_one(pose, intr, pt, uv)
        Jpo, Jin, Jpt = jax.jacfwd(_residual_one, argnums=(0, 1, 2))(pose, intr, pt, uv)
        return r, Jpo, Jin, Jpt

    rj_v = jax.vmap(jax.vmap(rj))
    r, Jpo, Jin, Jpt = rj_v(poses, intrs, pts, problem.track_uv)
    w = jnp.sqrt(problem.track_weight)[:, None, None]
    m = problem.track_mask.astype(r.dtype)[:, :, None]
    r = r * w * m
    scale = (w * m)[..., None]
    return r * 1.0, Jpo * scale, Jin * scale, Jpt * scale


def robust_weights(r, delta):
    """sqrt(rho'(s)) for Huber rho (Ceres semantics: rho(s)=s | 2 d sqrt(s)-d^2)."""
    s = jnp.sum(r * r, axis=-1)
    w2 = jnp.where(s <= delta * delta, 1.0, delta / jnp.sqrt(jnp.maximum(s, 1e-20)))
    return jnp.sqrt(w2)


def robust_cost(r, mask, delta):
    """Total Huber cost, 0.5 * sum rho(|r|^2) over valid observations."""
    s = jnp.sum(r * r, axis=-1)
    rho = jnp.where(s <= delta * delta, s, 2.0 * delta * jnp.sqrt(jnp.maximum(s, 1e-20)) - delta * delta)
    return 0.5 * jnp.sum(rho * mask.astype(r.dtype))


def compute_residuals(problem: BAProblem):
    cam = problem.track_cam
    poses = problem.poses[cam]
    intrs = problem.intrs[problem.cam_model[cam]]
    pts = problem.points[:, None, :].repeat(problem.max_views, 1)
    r = jax.vmap(jax.vmap(_residual_one))(poses, intrs, pts, problem.track_uv)
    w = jnp.sqrt(problem.track_weight)[:, None, None]
    return r * w * problem.track_mask.astype(r.dtype)[:, :, None]


def gps_residuals(problem: BAProblem):
    """GPS camera-center anchor residuals (C, 3): weight*(center - gps).

    Reference GPSErrorPoseAbsolute (utils/gps_error_pose_absolute.h:31-44)
    with per-axis weights (z down-weighted x1/5 by the caller)."""
    centers = jax.vmap(projection.camera_center)(problem.poses)
    return problem.gps_weight * (centers - problem.gps_pos)


def pose_prior_residuals(problem: BAProblem):
    """Full-pose prior residuals (C, 6) (ref cam_error_pose_absolute.h)."""
    return problem.pose_prior_weight * (problem.poses - problem.pose_prior)


def _triple_residual(poses3, gps3, w2, eps=1e-8):
    """(2,) GPS relative residuals for one camera triple (i, j, k).

    Reference gps_error_pose_raletive_angle.h (triangle angle at the middle
    camera) and gps_error_pose_raletive_dis.h (distance ratio), expressed as
    smooth cosine / ratio differences.
    """
    c = jax.vmap(projection.camera_center)(poses3)      # (3,3)
    v1 = c[0] - c[1]
    v2 = c[2] - c[1]
    # sqrt(|v|^2 + eps) keeps the jacfwd finite for degenerate (placeholder)
    # triples where all three cameras coincide — norm() has a NaN gradient
    # at 0, and 0-weight times NaN still poisons the normal equations
    n1 = jnp.sqrt(jnp.dot(v1, v1) + eps)
    n2 = jnp.sqrt(jnp.dot(v2, v2) + eps)
    cos_est = jnp.dot(v1, v2) / (n1 * n2)
    g1 = gps3[0] - gps3[1]
    g2 = gps3[2] - gps3[1]
    m1 = jnp.sqrt(jnp.dot(g1, g1) + eps)
    m2 = jnp.sqrt(jnp.dot(g2, g2) + eps)
    cos_gps = jnp.dot(g1, g2) / (m1 * m2)
    ratio_est = n1 / n2
    ratio_gps = m1 / m2
    return jnp.stack([w2[0] * (cos_est - cos_gps),
                      w2[1] * (ratio_est - ratio_gps)])


def gps_triple_residuals(problem: BAProblem):
    """(T, 2) relative GPS residuals over the configured camera triples."""
    poses3 = problem.poses[problem.gps_triple]           # (T,3,6)
    gps3 = problem.gps_pos[problem.gps_triple]           # (T,3,3)
    return jax.vmap(_triple_residual)(poses3, gps3, problem.gps_triple_weight)


def problem_cost(problem: BAProblem, huber_delta: float):
    reproj = robust_cost(compute_residuals(problem), problem.track_mask,
                         huber_delta)
    rg = gps_residuals(problem)
    rp = pose_prior_residuals(problem)
    rt = gps_triple_residuals(problem)
    return (reproj + 0.5 * jnp.sum(rg * rg) + 0.5 * jnp.sum(rp * rp)
            + 0.5 * jnp.sum(rt * rt))


def _inv3x3(A, eps=1e-12):
    """Closed-form batched 3x3 inverse (adjugate/det): elementwise
    arithmetic, no batched solver call for millions of tiny matrices."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < eps, eps, det)
    rows = jnp.stack([
        jnp.stack([A11, A12, A13], axis=-1),
        jnp.stack([A21, A22, A23], axis=-1),
        jnp.stack([A31, A32, A33], axis=-1),
    ], axis=-2)
    return rows / det[..., None, None]


def _chol3x3(A, eps=1e-12):
    """Closed-form batched 3x3 Cholesky (lower)."""
    a11 = jnp.maximum(A[..., 0, 0], eps)
    l11 = jnp.sqrt(a11)
    l21 = A[..., 1, 0] / l11
    l31 = A[..., 2, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(A[..., 1, 1] - l21 * l21, eps))
    l32 = (A[..., 2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(A[..., 2, 2] - l31 * l31 - l32 * l32, eps))
    z = jnp.zeros_like(l11)
    return jnp.stack([
        jnp.stack([l11, z, z], axis=-1),
        jnp.stack([l21, l22, z], axis=-1),
        jnp.stack([l31, l32, l33], axis=-1),
    ], axis=-2)


def partial_camera_system(problem: BAProblem, lam, cfg: LMConfig):
    """Linearize the local track shard into its share of the reduced system.

    Every term of (S, rhs) is a sum over tracks, so a shard of tracks
    produces an additive partial — the distributed decomposition
    (SURVEY.md §2.11): shards psum their (S_raw, rhs_raw) over ICI and each
    chip solves the (replicated) reduced system, keeping point elimination
    and back-substitution fully local.

    Aggregation strategy: everything indexed by camera/model is gathered
    with ONE-HOT MATMULS (einsum against (P,V,C) / (P,V,M) indicator
    tensors), not scatter/segment ops (ROADMAP design item 3.4 asks for a
    measured segment_sum form on the GPU).  The Schur product itself is
    a single (6C+3M, 3P)x(3P, 6C+3M) matmul via the G = one_hot . W . chol
    factor.

    Returns (S_raw, rhs_raw, aux): the *undamped, unmasked* camera system
    partials plus per-track tensors needed for back-substitution.
    """
    C, M, P, V = (problem.n_cameras, problem.n_models, problem.n_points,
                  problem.max_views)
    D = 6 * C + 3 * M
    dtype = problem.points.dtype

    r, Jpo, Jin, Jpt = _obs_jacobians(problem)
    # Huber IRLS scaling
    rw = robust_weights(r, cfg.huber_delta)[..., None]
    r = r * rw
    Jpo = Jpo * rw[..., None]
    Jin = Jin * rw[..., None]
    Jpt = Jpt * rw[..., None]

    cam = problem.track_cam            # (P,V)
    model = problem.cam_model[cam]     # (P,V)

    # one-hot aggregation operands (bf16 indicators, f32 accumulation)
    O_cam = jax.nn.one_hot(cam, C, dtype=dtype)          # (P,V,C)
    O_mod = jax.nn.one_hot(model, M, dtype=dtype)        # (P,V,M)

    # ---- gradient ----
    g_pose = jnp.einsum("pvri,pvr->pvi", Jpo, r)        # (P,V,6)
    g_intr = jnp.einsum("pvri,pvr->pvi", Jin, r)        # (P,V,3)
    g_pt = jnp.einsum("pvri,pvr->pi", Jpt, r)           # (P,3)
    gc_pose = jnp.einsum("pvc,pvi->ci", O_cam, g_pose)  # (C,6)
    gc_intr = jnp.einsum("pvm,pvi->mi", O_mod, g_intr)  # (M,3)
    g_cam = jnp.concatenate([gc_pose.reshape(-1), gc_intr.reshape(-1)])  # (D,)

    # ---- point blocks (closed-form 3x3 ops) ----
    Hpp = jnp.einsum("pvri,pvrj->pij", Jpt, Jpt)        # (P,3,3)
    diag_pp = jnp.diagonal(Hpp, axis1=-2, axis2=-1)
    damp = lam * jnp.maximum(diag_pp, 1e-12) + 1e-12
    Hpp_d = Hpp + damp[..., None] * jnp.eye(3, dtype=dtype)
    # frozen points: make block identity so inverse is benign; d_pt forced 0 later
    pm = problem.point_mut[:, None, None]
    Hpp_d = Hpp_d * pm + jnp.eye(3, dtype=dtype)[None] * (1.0 - pm)
    Hpp_inv = _inv3x3(Hpp_d)                             # (P,3,3)

    # ---- camera block-diagonals (one-hot matmuls) ----
    Hpose = jnp.einsum("pvri,pvrj->pvij", Jpo, Jpo)
    Hintr = jnp.einsum("pvri,pvrj->pvij", Jin, Jin)
    Hpi = jnp.einsum("pvri,pvrj->pvij", Jpo, Jin)
    Hcc_pose = jnp.einsum("pvc,pvij->cij", O_cam, Hpose)   # (C,6,6)
    Hcc_intr = jnp.einsum("pvm,pvij->mij", O_mod, Hintr)   # (M,3,3)
    Hcc_pi = jnp.einsum("pvc,pvij->cij", O_cam, Hpi)       # (C,6,3)

    S = jnp.zeros((D, D), dtype)
    pose_rows = (6 * jnp.arange(C)[:, None] + jnp.arange(6)[None, :])  # (C,6)
    S = S.at[pose_rows[:, :, None], pose_rows[:, None, :]].add(Hcc_pose)
    intr_rows = 6 * C + 3 * jnp.arange(M)[:, None] + jnp.arange(3)[None, :]
    S = S.at[intr_rows[:, :, None], intr_rows[:, None, :]].add(Hcc_intr)
    pi_cols = 6 * C + 3 * problem.cam_model[:, None] + jnp.arange(3)[None, :]  # (C,3)
    S = S.at[pose_rows[:, :, None], pi_cols[:, None, :]].add(Hcc_pi)
    S = S.at[pi_cols[:, :, None], pose_rows[:, None, :]].add(
        jnp.swapaxes(Hcc_pi, -1, -2))

    # ---- Schur subtraction: S -= sum_p E_p Hpp_inv E_p^T ----
    # W (P,V,9,3) = [Jpose|Jintr]^T Jpt per view; mutable points only.
    Jc = jnp.concatenate([Jpo, Jin], axis=-1)            # (P,V,2,9)
    W = jnp.einsum("pvri,pvrj->pvij", Jc, Jpt)           # (P,V,9,3)
    W = W * problem.point_mut[:, None, None, None]

    # Factor Hpp_inv = L L^T; fold the view->dof one-hots into per-point
    # factors G so the whole Schur product is one big matmul:
    #   G_pose (P,C,6,3) = sum_v O_cam . W_pose . L
    #   G_intr (P,M,3,3) = sum_v O_mod . W_intr . L
    #   Schur  = [G_pose|G_intr] [G_pose|G_intr]^T contracted over (p, k).
    Lp = _chol3x3(Hpp_inv)                               # (P,3,3)
    U = jnp.einsum("pvij,pjk->pvik", W, Lp)              # (P,V,9,3)
    G_pose = jnp.einsum("pvc,pvik->pcik", O_cam, U[:, :, :6, :])  # (P,C,6,3)
    G_intr = jnp.einsum("pvm,pvik->pmik", O_mod, U[:, :, 6:, :])  # (P,M,3,3)
    S_pp = jnp.einsum("pcik,pdjk->cidj", G_pose, G_pose).reshape(6 * C, 6 * C)
    S_pi = jnp.einsum("pcik,pmjk->cimj", G_pose, G_intr).reshape(6 * C, 3 * M)
    S_ii = jnp.einsum("pmik,pnjk->minj", G_intr, G_intr).reshape(3 * M, 3 * M)
    schur = jnp.concatenate([
        jnp.concatenate([S_pp, S_pi], axis=1),
        jnp.concatenate([S_pi.T, S_ii], axis=1),
    ], axis=0)
    S = S - schur

    # ---- rhs: -(g_cam - E Hpp_inv g_pt) ----
    y = jnp.einsum("pij,pj->pi", Hpp_inv, g_pt)          # (P,3)
    corr = jnp.einsum("pvij,pj->pvi", W, y)              # (P,V,9)
    corr_pose = jnp.einsum("pvc,pvi->ci", O_cam, corr[..., :6])
    corr_intr = jnp.einsum("pvm,pvi->mi", O_mod, corr[..., 6:])
    rhs = -g_cam + jnp.concatenate([corr_pose.reshape(-1),
                                    corr_intr.reshape(-1)])

    aux = _lane_major_aux(W, Hpp_inv, cam, g_pt)
    return S, rhs, aux


def _lane_major_aux(W, Hpp_inv, cam, g_pt):
    """Back-substitution tensors in LANE-MAJOR layout: the big slot axis
    (P, or V*P flattened) goes LAST; the tiny 9/3 dims become leading
    axes, so no op carries a tiny minor dimension."""
    return {"WT": jnp.transpose(W, (2, 3, 1, 0)),          # (9,3,V,P)
            "HiT": jnp.transpose(Hpp_inv, (1, 2, 0)),      # (3,3,P)
            "camT": jnp.transpose(cam, (1, 0)),            # (V,P)
            "g_ptT": jnp.transpose(g_pt, (1, 0))}          # (3,P)


def solve_reduced(S, rhs, problem: BAProblem, lam, cfg: LMConfig):
    """Damp + freeze-mask the (already psum-complete) reduced system, solve.

    GPS anchor terms are camera-indexed (replicated under sharding), so they
    are added here — once, after the psum — not in the per-shard partials.
    """
    C, M = problem.n_cameras, problem.n_models
    D = 6 * C + 3 * M

    # ---- GPS camera-center anchors ----
    def gps_rj(pose, gpos, gw):
        def r(p):
            return gw * (projection.camera_center(p) - gpos)
        return r(pose), jax.jacfwd(r)(pose)

    rg, Jg = jax.vmap(gps_rj)(problem.poses, problem.gps_pos,
                              problem.gps_weight)      # (C,3), (C,3,6)
    Hg = jnp.einsum("cri,crj->cij", Jg, Jg)            # (C,6,6)
    gg = jnp.einsum("cri,cr->ci", Jg, rg)              # (C,6)
    pose_rows = 6 * jnp.arange(C)[:, None] + jnp.arange(6)[None, :]
    S = S.at[pose_rows[:, :, None], pose_rows[:, None, :]].add(Hg)
    rhs = rhs - jnp.concatenate([gg.reshape(-1),
                                 jnp.zeros((3 * M,), rhs.dtype)])

    # ---- full-pose priors (diagonal in pose dofs) ----
    rp = pose_prior_residuals(problem)                 # (C,6)
    wp = problem.pose_prior_weight
    S = S.at[pose_rows.reshape(-1), pose_rows.reshape(-1)].add(
        (wp * wp).reshape(-1))
    rhs = rhs - jnp.concatenate([(wp * rp).reshape(-1),
                                 jnp.zeros((3 * M,), rhs.dtype)])

    # ---- GPS relative (triple) constraints ----
    def triple_rj(poses3, gps3, w2):
        r = _triple_residual(poses3, gps3, w2)          # (2,)
        J = jax.jacfwd(_triple_residual)(poses3, gps3, w2)  # (2,3,6)
        return r, J

    rt, Jt = jax.vmap(triple_rj)(problem.poses[problem.gps_triple],
                                 problem.gps_pos[problem.gps_triple],
                                 problem.gps_triple_weight)  # (T,2),(T,2,3,6)
    Ht = jnp.einsum("trai,trbj->taibj", Jt, Jt)        # (T,3,6,3,6)
    gt = jnp.einsum("trai,tr->tai", Jt, rt)            # (T,3,6)
    trip_rows = 6 * problem.gps_triple[:, :, None] + jnp.arange(6)[None, None, :]  # (T,3,6)
    for a in range(3):
        rhs = rhs.at[trip_rows[:, a, :]].add(-gt[:, a, :])
        for b in range(3):
            S = S.at[trip_rows[:, a, :, None], trip_rows[:, b, None, :]].add(
                Ht[:, a, :, b, :])

    # ---- damping + mutability on camera system ----
    diag = jnp.diagonal(S)
    S = S.at[jnp.arange(D), jnp.arange(D)].add(lam * jnp.maximum(diag, 1e-12) + 1e-10)
    free = jnp.concatenate([
        jnp.repeat(problem.pose_mut, 6), jnp.repeat(problem.intr_mut, 3)])
    S = S * free[:, None] * free[None, :]
    S = S.at[jnp.arange(D), jnp.arange(D)].add(1.0 - free)
    rhs = rhs * free

    if cfg.jacobi_scale:
        d = jnp.sqrt(jnp.maximum(jnp.diagonal(S), 1e-12))
        Sn = S / d[:, None] / d[None, :]
        L = jax.scipy.linalg.cho_factor(Sn, lower=True)
        d_cam = jax.scipy.linalg.cho_solve(L, rhs / d) / d
    else:
        L = jax.scipy.linalg.cho_factor(S, lower=True)
        d_cam = jax.scipy.linalg.cho_solve(L, rhs)
    return d_cam


def backsub_points(aux, d_cam, problem: BAProblem):
    """Local point back-substitution: d_pt = -Hpp_inv (g_pt + E^T d_cam).

    Lane-major: one (C,9)-table row gather per slot replaces a (P,V,9)
    scalar scatter-gather of d_cam[dofs], and the 9x3 / 3x3 contractions
    are unrolled FMAs over the P lanes."""
    WT, HiT, camT, g_ptT = (aux["WT"], aux["HiT"], aux["camT"],
                            aux["g_ptT"])
    C, M = problem.n_cameras, problem.n_models
    dp = d_cam[:6 * C].reshape(C, 6)
    di = d_cam[6 * C:].reshape(M, 3)
    d9 = jnp.concatenate([dp, di[problem.cam_model]], axis=1)   # (C,9)
    dc = jnp.take(d9.T, camT, axis=1)                           # (9,V,P)
    Et = [sum((WT[i, k] * dc[i]).sum(0) for i in range(9))
          for k in range(3)]                                    # 3 x (P,)
    rhs3 = [g_ptT[k] + Et[k] for k in range(3)]
    d_pt = -jnp.stack([sum(HiT[i, j] * rhs3[j] for j in range(3))
                       for i in range(3)], axis=1)              # (P,3)
    return d_pt * problem.point_mut[:, None]


# ---------------------------------------------------------------------------
# Matrix-free PCG path for the reduced camera system (cfg.cg_iterations > 0)
# ---------------------------------------------------------------------------

def _inv3x3_lead(A, eps=1e-12):
    """_inv3x3 for LEADING (3, 3, ...) index layout (lanes trailing)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    det = jnp.where(jnp.abs(det) < eps, eps, det)
    rows = jnp.stack([jnp.stack([A11, A12, A13]),
                      jnp.stack([A21, A22, A23]),
                      jnp.stack([A31, A32, A33])])
    return rows / det


def _chol3x3_lead(A, eps=1e-12):
    """_chol3x3 for LEADING (3, 3, ...) index layout."""
    a11 = jnp.maximum(A[0, 0], eps)
    l11 = jnp.sqrt(a11)
    l21 = A[1, 0] / l11
    l31 = A[2, 0] / l11
    l22 = jnp.sqrt(jnp.maximum(A[1, 1] - l21 * l21, eps))
    l32 = (A[2, 1] - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(A[2, 2] - l31 * l31 - l32 * l32, eps))
    z = jnp.zeros_like(l11)
    return jnp.stack([jnp.stack([l11, z, z]),
                      jnp.stack([l21, l22, z]),
                      jnp.stack([l31, l32, l33])])


def _make_slot_reducer(camT, maskT, n: int):
    """Chunked one-hot reduction over flat v-major slots -> `n` bins.

    camT/maskT: (V, P).  Masked slots route to the sentinel bin `n` (their
    values are mask-scaled to 0 anyway) and drop out of the one-hot
    exactly.  Returns reduce(z) taking (k, V, P) -> (k, n) — the pattern
    the CG matvec uses per iteration (reduce_cam9), shared at build time.
    """
    ids_eff = jnp.where(maskT, camT, n).reshape(-1)
    PV = ids_eff.shape[0]
    CH = min(32768, max(128, 1 << (PV - 1).bit_length()))
    padn = (-PV) % CH
    ids2d = jnp.pad(ids_eff, (0, padn), constant_values=n).reshape(-1, CH)

    def reduce(z):
        k = z.shape[0]
        zf = z.reshape(k, PV)
        if padn:
            zf = jnp.pad(zf, ((0, 0), (0, padn)))
        zst = jnp.moveaxis(zf.reshape(k, -1, CH), 1, 0)   # (nch,k,CH)

        def body(acc, sl):
            zch, idc = sl
            oh = (idc[:, None] == jnp.arange(n)[None, :]).astype(zf.dtype)
            return acc + jnp.dot(zch, oh,
                                 precision=jax.lax.Precision.HIGHEST), None
        # `+ 0 * zf[...]` marks the carry shard-varying under shard_map
        acc0 = jnp.zeros((k, n), zf.dtype) + 0.0 * zf.reshape(-1)[0]
        out, _ = jax.lax.scan(body, acc0, (zst, ids2d))
        return out
    return reduce


def _track_terms(problem: BAProblem, lam, cfg: LMConfig):
    """Per-track tensors + rhs for the CG path — everything O(P*V), no
    (D, D) matrix and no O(P*C) factor.

    LANE-MAJOR THROUGHOUT: every per-slot tensor keeps the big (V, P)
    axes trailing and the tiny 2/3/9 dims leading.  The einsum form this
    replaces materialized (P, V, 9, 9) / (P, V, 9, 3) intermediates with
    tiny minor dims, which padded to tens of GB at the 500-image full-BA
    scale.
    """
    C, M = problem.n_cameras, problem.n_models
    dtype = problem.points.dtype

    r, Jpo, Jin, Jpt = _obs_jacobians(problem)
    rw = robust_weights(r, cfg.huber_delta)[..., None]
    r = r * rw
    Jpo = Jpo * rw[..., None]
    Jin = Jin * rw[..., None]
    Jpt = Jpt * rw[..., None]

    cam = problem.track_cam
    camT = jnp.transpose(cam, (1, 0))                    # (V,P)
    maskT = jnp.transpose(problem.track_mask, (1, 0))
    modelT = problem.cam_model[camT]

    # lane-major views of the per-observation jacobians/residuals
    JpoT = jnp.transpose(Jpo, (2, 3, 1, 0))              # (2,6,V,P)
    JinT = jnp.transpose(Jin, (2, 3, 1, 0))              # (2,3,V,P)
    JptT = jnp.transpose(Jpt, (2, 3, 1, 0))              # (2,3,V,P)
    rT = jnp.transpose(r, (2, 1, 0))                     # (2,V,P)
    JcT = jnp.concatenate([JpoT, JinT], axis=1)          # (2,9,V,P)

    pmP = problem.point_mut                              # (P,)

    # ---- point blocks, (3,3,P) leading layout ----
    HppT = jnp.stack([jnp.stack([
        sum((JptT[rr, i] * JptT[rr, j]).sum(0) for rr in range(2))
        for j in range(3)]) for i in range(3)])          # (3,3,P)
    diag_pp = jnp.stack([HppT[i, i] for i in range(3)])  # (3,P)
    damp = lam * jnp.maximum(diag_pp, 1e-12) + 1e-12
    eyeP = jnp.eye(3, dtype=dtype)[:, :, None]
    Hpp_d = HppT + eyeP * damp[None, :, :]               # damp on diagonal
    # frozen points: identity block (inverse benign; d_pt forced 0 later)
    Hpp_d = Hpp_d * pmP[None, None, :] + eyeP * (1.0 - pmP)[None, None, :]
    HiT = _inv3x3_lead(Hpp_d)                            # (3,3,P)

    # ---- W / U, (9,3,V,P) leading layout ----
    WT = jnp.stack([jnp.stack([
        sum(JcT[rr, i] * JptT[rr, k] for rr in range(2))
        for k in range(3)]) for i in range(9)])          # (9,3,V,P)
    WT = WT * pmP[None, None, None, :]
    LpT = _chol3x3_lead(HiT)                             # (3,3,P)
    UT = jnp.stack([jnp.stack([
        sum(WT[i, j] * LpT[j, k][None, :] for j in range(3))
        for k in range(3)]) for i in range(9)])          # (9,3,V,P)

    # ---- gradient + Schur rhs correction ----
    g_ptT = jnp.stack([sum((JptT[rr, i] * rT[rr]).sum(0) for rr in range(2))
                       for i in range(3)])               # (3,P)
    yT = jnp.stack([sum(HiT[i, j] * g_ptT[j] for j in range(3))
                    for i in range(3)])                  # (3,P)
    g_viewT = jnp.stack([sum(JcT[rr, i] * rT[rr] for rr in range(2))
                         for i in range(9)])             # (9,V,P)
    corrT = jnp.stack([sum(WT[i, k] * yT[k][None, :] for k in range(3))
                       for i in range(9)])               # (9,V,P)
    rvT = corrT - g_viewT

    reduce_cam = _make_slot_reducer(camT, maskT, C)
    reduce_mod = _make_slot_reducer(modelT, maskT, M)
    rhs_pose = reduce_cam(rvT[:6]).T                     # (C,6)
    rhs_intr = reduce_mod(rvT[6:]).T                     # (M,3)
    rhs = jnp.concatenate([rhs_pose.reshape(-1), rhs_intr.reshape(-1)])

    # ---- block-Jacobi pieces of S (Hcc minus Schur part, per view) ----
    def blk_map(i, j):
        return (sum(JcT[rr, i] * JcT[rr, j] for rr in range(2))
                - sum(UT[i, k] * UT[j, k] for k in range(3)))  # (V,P)

    z36 = jnp.stack([blk_map(i, j) for i in range(6) for j in range(6)])
    blk_pose = reduce_cam(z36).T.reshape(C, 6, 6)
    z9 = jnp.stack([blk_map(6 + i, 6 + j)
                    for i in range(3) for j in range(3)])
    blk_intr = reduce_mod(z9).T.reshape(M, 3, 3)

    aux = {"WT": WT, "HiT": HiT, "camT": camT, "g_ptT": g_ptT}
    terms = {"JcT": JcT, "WT": WT, "HiT": HiT, "camT": camT,
             "maskT": maskT, "blk_pose": blk_pose, "blk_intr": blk_intr}
    return terms, rhs, aux


def _gps_prior_blocks(problem: BAProblem):
    """Camera-indexed Hessian blocks of the GPS/prior/triple terms (cheap,
    O(C)); returned as dense per-camera pieces for the CG matvec and the
    preconditioner, plus their rhs contribution."""
    C, M = problem.n_cameras, problem.n_models

    def gps_rj(pose, gpos, gw):
        def r(p):
            return gw * (projection.camera_center(p) - gpos)
        return r(pose), jax.jacfwd(r)(pose)

    rg, Jg = jax.vmap(gps_rj)(problem.poses, problem.gps_pos,
                              problem.gps_weight)
    Hg = jnp.einsum("cri,crj->cij", Jg, Jg)              # (C,6,6)
    gg = jnp.einsum("cri,cr->ci", Jg, rg)

    rp = pose_prior_residuals(problem)
    wp = problem.pose_prior_weight
    Hg = Hg + jax.vmap(jnp.diag)(wp * wp)
    gg = gg + wp * rp

    def triple_rj(poses3, gps3, w2):
        rt = _triple_residual(poses3, gps3, w2)
        Jt = jax.jacfwd(_triple_residual)(poses3, gps3, w2)
        return rt, Jt

    rt, Jt = jax.vmap(triple_rj)(problem.poses[problem.gps_triple],
                                 problem.gps_pos[problem.gps_triple],
                                 problem.gps_triple_weight)
    Ht = jnp.einsum("trai,trbj->taibj", Jt, Jt)          # (T,3,6,3,6)
    gt = jnp.einsum("trai,tr->tai", Jt, rt)              # (T,3,6)

    rhs_extra = jnp.zeros((6 * C + 3 * M,), problem.points.dtype)
    pose_rows = 6 * jnp.arange(C)[:, None] + jnp.arange(6)[None, :]
    rhs_extra = rhs_extra.at[pose_rows].add(-gg)
    trip_rows = (6 * problem.gps_triple[:, :, None]
                 + jnp.arange(6)[None, None, :])
    for a in range(3):
        rhs_extra = rhs_extra.at[trip_rows[:, a, :]].add(-gt[:, a, :])
    return Hg, Ht, rhs_extra


def _cg_solve(problem: BAProblem, terms, Hg, Ht, rhs, lam, cfg: LMConfig,
              axis_name=None, tol_rel=None):
    """Block-Jacobi PCG on the damped, freeze-masked reduced system.

    With `axis_name` set (inside shard_map over a track shard), the only
    communication is ONE psum of the (D,) track-term matvec partial per CG
    iteration: per-track terms are shard-local, the one-hot reduction
    partials are additive, and the camera-indexed GPS/prior/damping terms
    are replicated so each shard adds them to its post-psum copy
    identically.  `rhs` and the preconditioner blocks must already be
    psum-complete (see _assemble_and_solve_cg)."""
    C, M = problem.n_cameras, problem.n_models
    D = 6 * C + 3 * M
    dtype = rhs.dtype
    free = jnp.concatenate([
        jnp.repeat(problem.pose_mut, 6), jnp.repeat(problem.intr_mut, 3)])

    blk_pose = terms["blk_pose"] + Hg                    # (C,6,6)
    blk_intr = terms["blk_intr"]                         # (M,3,3)
    # damping on diag(S) (incl. triples' diagonal)
    tdiag = jnp.zeros((D,), dtype)
    trip_rows = (6 * problem.gps_triple[:, :, None]
                 + jnp.arange(6)[None, None, :])
    for a in range(3):
        tdiag = tdiag.at[trip_rows[:, a, :]].add(
            jnp.diagonal(Ht[:, a, :, a, :], axis1=-2, axis2=-1))
    diag_s = jnp.concatenate([
        jax.vmap(jnp.diag)(blk_pose).reshape(-1),
        jax.vmap(jnp.diag)(blk_intr).reshape(-1)]) + tdiag
    dampv = lam * jnp.maximum(diag_s, 1e-12) + 1e-10

    JcT, WT, HiT = terms["JcT"], terms["WT"], terms["HiT"]
    camT, maskT = terms["camT"], terms["maskT"]
    cam_model = problem.cam_model
    gps_triple = problem.gps_triple

    # sum slots into camera bins: (9,V,P) -> (9,C) via chunked one-hot
    # matmuls (f32 at HIGHEST precision: the CG direction is
    # precision-sensitive).  The (C,K) gather-table this replaced needed
    # host-side K validation to not silently drop terms.
    reduce_cam9 = _make_slot_reducer(camT, maskT, C)

    def matvec(x):
        xm = x * free
        xp = xm[:6 * C].reshape(C, 6)
        xi = xm[6 * C:].reshape(M, 3)
        x9 = jnp.concatenate([xp, xi[cam_model]], axis=1)     # (C,9)
        xv = jnp.take(x9.T, camT, axis=1)                     # (9,V,P)
        # unrolled lane-major contractions: every op below is an FMA over
        # the (V,P) lanes — no tiny-dim einsums (those paid ~50x layout
        # padding; see _lane_major_aux)
        xvf = [xv[j] for j in range(9)]
        t = [sum(JcT[r, j] * xvf[j] for j in range(9)) for r in range(2)]
        u = [sum(JcT[r, i] * t[r] for r in range(2)) for i in range(9)]
        a3 = [sum((WT[i, k] * xvf[i]).sum(0) for i in range(9))
              for k in range(3)]                              # 3 x (P,)
        b3 = [sum(HiT[j, k] * a3[k] for k in range(3)) for j in range(3)]
        c9 = [sum(WT[i, k] * b3[k][None, :] for k in range(3))
              for i in range(9)]
        z9 = jnp.stack([u[i] - c9[i] for i in range(9)])      # (9,V,P)
        zc = reduce_cam9(z9)                                  # (9,C)
        zp = zc[:6].T.reshape(-1)
        # model ids are a function of the camera id: fold the C camera
        # rows into M model bins (tiny segment_sum over C rows)
        zi = jax.ops.segment_sum(zc[6:].T, cam_model, M).reshape(-1)
        Sx = jnp.concatenate([zp, zi])
        if axis_name is not None:
            # the one collective per CG iteration: complete the
            # track-term partial over the shard axis
            Sx = jax.lax.psum(Sx, axis_name)
        # GPS/prior blocks
        xp = xm[:6 * C].reshape(C, 6)
        Sx = Sx.at[:6 * C].add(jnp.einsum("cij,cj->ci", Hg, xp).reshape(-1))
        # triples
        xt = xp[gps_triple]                              # (T,3,6)
        tx = jnp.einsum("taibj,tbj->tai", Ht, xt)        # (T,3,6)
        Sxp = jnp.zeros((C, 6), dtype).at[gps_triple].add(tx)
        Sx = Sx.at[:6 * C].add(Sxp.reshape(-1))
        Sx = Sx + dampv * xm
        return Sx * free + (1.0 - free) * x

    # block-Jacobi preconditioner (damped, freeze-safe)
    eye6 = jnp.eye(6, dtype=dtype)
    eye3 = jnp.eye(3, dtype=dtype)
    dp = (lam * jnp.maximum(jax.vmap(jnp.diag)(blk_pose), 1e-12) + 1e-10)
    di = (lam * jnp.maximum(jax.vmap(jnp.diag)(blk_intr), 1e-12) + 1e-10)
    Bp = blk_pose + dp[..., None] * eye6[None]
    Bi = blk_intr + di[..., None] * eye3[None]
    fp = problem.pose_mut[:, None, None]
    fi = problem.intr_mut[:, None, None]
    Bp = Bp * fp + eye6[None] * (1.0 - fp)
    Bi = Bi * fi + eye3[None] * (1.0 - fi)
    Bp_cho = jax.vmap(lambda m: jax.scipy.linalg.cho_factor(m, lower=True)[0])(Bp)
    Bi_inv = _inv3x3(Bi)

    def prec(r):
        rp = r[:6 * C].reshape(C, 6)
        ri = r[6 * C:].reshape(M, 3)
        zp = jax.vmap(lambda l, b: jax.scipy.linalg.cho_solve((l, True), b))(
            Bp_cho, rp)
        zi = jnp.einsum("mij,mj->mi", Bi_inv, ri)
        return jnp.concatenate([zp.reshape(-1), zi.reshape(-1)])

    rhs = rhs * free
    b_norm = jnp.linalg.norm(rhs)
    if tol_rel is None:
        tol_rel = cfg.cg_tol
    tol2 = (tol_rel * b_norm) ** 2

    def cond(state):
        i, x, r, z, p, rz = state
        return (i < cfg.cg_iterations) & (jnp.sum(r * r) > tol2)

    def body(state):
        i, x, r, z, p, rz = state
        Ap = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = prec(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return i + 1, x, r, z, p, rz_new

    x0 = jnp.zeros((D,), dtype)
    z0 = prec(rhs)
    state = (jnp.int32(0), x0, rhs, z0, z0, jnp.sum(rhs * z0))
    _, x, _, _, _, _ = jax.lax.while_loop(cond, body, state)
    return x * free


def _assemble_and_solve_cg(problem: BAProblem, lam, cfg: LMConfig,
                           axis_name=None, tol_rel=None):
    C, M = problem.n_cameras, problem.n_models
    terms, rhs, aux = _track_terms(problem, lam, cfg)
    if axis_name is not None:
        # complete the track-summed pieces once per solve; the per-iteration
        # matvec psum lives inside _cg_solve
        rhs = jax.lax.psum(rhs, axis_name)
        terms["blk_pose"] = jax.lax.psum(terms["blk_pose"], axis_name)
        terms["blk_intr"] = jax.lax.psum(terms["blk_intr"], axis_name)
    Hg, Ht, rhs_extra = _gps_prior_blocks(problem)
    d_cam = _cg_solve(problem, terms, Hg, Ht, rhs + rhs_extra, lam, cfg,
                      axis_name=axis_name, tol_rel=tol_rel)
    d_pt = backsub_points(aux, d_cam, problem)
    d_pose = d_cam[:6 * C].reshape(C, 6) * problem.pose_mut[:, None]
    d_intr = d_cam[6 * C:].reshape(M, 3) * problem.intr_mut[:, None]
    return d_pose, d_intr, d_pt


def _assemble_and_solve(problem: BAProblem, lam, cfg: LMConfig,
                        tol_rel=None):
    """Single-device path: partial system == full system."""
    if cfg.cg_iterations > 0:
        return _assemble_and_solve_cg(problem, lam, cfg, tol_rel=tol_rel)
    C, M = problem.n_cameras, problem.n_models
    S, rhs, aux = partial_camera_system(problem, lam, cfg)
    d_cam = solve_reduced(S, rhs, problem, lam, cfg)
    d_pt = backsub_points(aux, d_cam, problem)
    d_pose = d_cam[:6 * C].reshape(C, 6) * problem.pose_mut[:, None]
    d_intr = d_cam[6 * C:].reshape(M, 3) * problem.intr_mut[:, None]
    return d_pose, d_intr, d_pt


def _apply_step(problem: BAProblem, d_pose, d_intr, d_pt):
    return problem._replace(
        poses=problem.poses + d_pose,
        intrs=problem.intrs + d_intr,
        points=problem.points + d_pt,
    )


def solve_lm(problem: BAProblem, cfg: LMConfig = LMConfig()):
    """Run LM to convergence (jitted; fixed upper bound cfg.max_iterations).

    The device work is HOST-CHUNKED: each jitted call runs at most
    cfg.host_chunk LM iterations, and the host loops (carrying lam / cost
    / forcing-eta across chunks) until convergence or the iteration cap.
    Chunking bounds every XLA execution to a few LM iterations and costs
    one host round trip per chunk.

    Returns (problem, info dict) where info carries final cost, iterations
    used, and final lambda.
    """
    if isinstance(jax.tree.leaves(problem)[0], jax.core.Tracer):
        # called under jit/vmap (e.g. the batched submap solves): the host
        # cannot observe per-chunk convergence, so run the one-shot body —
        # those callers bound max_iterations themselves
        return _solve_lm_jit(problem, cfg)
    if cfg.max_iterations <= 0:
        # 0-iteration solve: still return a valid info dict (cost of the
        # input problem, 0 iterations) — the host while-loop below would
        # never bind `info`
        problem, info, _ = _solve_lm_chunk(
            problem, cfg._replace(max_iterations=1), None, jnp.int32(0))
        info = dict(info)
        info["iterations"] = jnp.asarray(0)
        return problem, info
    # small problems run the full iteration budget as ONE execution (the
    # while_loop still early-exits on rtol); chunking exists to bound
    # device time per call, which only large solves approach
    n_obs = int(problem.track_cam.shape[0]) * int(problem.track_cam.shape[1])
    if n_obs <= cfg.host_chunk_small_obs:
        chunk = cfg.max_iterations
    else:
        chunk = max(1, min(cfg.host_chunk, cfg.max_iterations))
    state = None
    total_it = 0
    initial_cost = None
    while total_it < cfg.max_iterations:
        # the per-chunk cap is a TRACED scalar so the tail chunk reuses
        # the same executable instead of compiling a second variant
        n = min(chunk, cfg.max_iterations - total_it)
        problem, info, state = _solve_lm_chunk(
            problem, cfg._replace(max_iterations=chunk), state,
            jnp.int32(n))
        # ONE host transfer for the whole info dict per chunk, not one
        # per int()/bool() field
        info = jax.device_get(info)
        total_it += int(info["iterations"])
        if initial_cost is None:
            initial_cost = info["initial_cost"]
        if bool(info["converged"]) or int(info["iterations"]) < n:
            break
    info = dict(info)
    info["iterations"] = total_it
    info["initial_cost"] = initial_cost
    return problem, info


def _solve_lm_jit(problem: BAProblem, cfg: LMConfig = LMConfig()):
    """One-shot (unchunked) solve — the building block solve_lm loops."""
    problem, info, _ = _solve_lm_chunk(problem, cfg, None,
                                       jnp.int32(cfg.max_iterations))
    return problem, info


@partial(jax.jit, static_argnames=("cfg",))
def _solve_lm_chunk(problem: BAProblem, cfg: LMConfig, state, n_its):
    """Up to n_its (traced; <= cfg.max_iterations) LM iterations from
    `state` (None = fresh: lambda/eta from cfg, cost evaluated here).
    Returns (problem, info, carry) where carry re-enters the next chunk.

    The full residual/cost pass runs only on the FIRST chunk (state is
    None — a static branch: the state pytree shape differs, so the two
    variants compile separately); continuation chunks re-enter with the
    carried accepted cost instead of paying a redundant evaluation per
    host_chunk iterations."""
    forcing = cfg.cg_forcing and cfg.cg_iterations > 0

    def cond(state):
        it, _, _, _, done, _ = state
        return (it < n_its) & (~done)

    def body(state):
        it, prob, lam, cost, done, eta = state
        d_pose, d_intr, d_pt = _assemble_and_solve(
            prob, lam, cfg, tol_rel=eta if forcing else None)
        cand = _apply_step(prob, d_pose, d_intr, d_pt)
        new_cost = problem_cost(cand, cfg.huber_delta)
        accept = (new_cost < cost) & jnp.isfinite(new_cost)
        prob = jax.tree.map(lambda a, b: jnp.where(accept, b, a), prob, cand)
        lam = jnp.where(accept,
                        jnp.maximum(lam / cfg.lambda_down, cfg.min_lambda),
                        jnp.minimum(lam * cfg.lambda_up, cfg.max_lambda))
        # forcing sequence: tighten superlinearly on acceptance only
        eta = jnp.where(accept,
                        jnp.maximum(eta ** 1.5, cfg.cg_tol), eta)
        rel = jnp.abs(cost - new_cost) / jnp.maximum(cost, 1e-20)
        done = accept & (rel < cfg.rtol)
        cost = jnp.where(accept, new_cost, cost)
        return it + 1, prob, lam, cost, done, eta

    if state is None:
        cost0 = problem_cost(problem, cfg.huber_delta)
        lam0 = jnp.asarray(cfg.init_lambda, problem.points.dtype)
        eta0 = jnp.asarray(cfg.cg_eta0 if forcing else cfg.cg_tol,
                           problem.points.dtype)
        cost_in = cost0
    else:
        lam0, eta0, cost_in = state
        cost0 = cost_in
    it, prob, lam, cost, done, eta = jax.lax.while_loop(
        cond, body,
        (jnp.int32(0), problem, lam0, cost_in, jnp.bool_(False), eta0))
    n_obs = problem.n_observations()
    info = {"initial_cost": cost0, "final_cost": cost, "iterations": it,
            "lambda": lam, "converged": done,
            "rms_px": jnp.sqrt(2.0 * cost / jnp.maximum(n_obs, 1))}
    return prob, info, (lam, eta, cost)
