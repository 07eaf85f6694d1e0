"""Absolute pose (PnP) solvers: P3P, EPnP, unknown-focal grid search.

Re-design of the reference pose solvers
(SfM/src/orientation/absolute_pose_via_p3p.{h,cc},
 absolute_pose_via_epnp.{h,cc}, absolute_pose_via_epnpf.{h,cc},
 absolute_pose_estimation.{h,cc}).

Design (SURVEY.md §7):
* The RANSAC *minimal* solver is Grunert P3P with a Durand-Kerner quartic
  (ops/polynomial.py) — closed-form-free and fully batchable, unlike the
  reference's per-sample EPnP with OpenCV mat internals.
* The *non-minimal* refit on inliers is EPnP (control points + barycentric
  + beta Gauss-Newton), weighted/masked so inlier sets keep static shapes.
* Unknown focal = vmap over a focal grid of the P3P-RANSAC scoring, the
  hardware-matched equivalent of the reference's 350-sample f grid
  (absolute_pose_via_epnpf.cc:35-64).

Conventions: world->camera pose (R, t); observations are centered pixels;
"normalized" observations are centered pixels divided by focal.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import polynomial, umeyama

_EPS = 1e-12


def p3p_grunert(Xw, bearings):
    """Grunert's P3P: up to 4 poses from 3 world points + 3 unit bearings.

    Args:
      Xw: (3, 3) world points.
      bearings: (3, 3) unit camera-frame bearing vectors.
    Returns:
      (R (4,3,3), t (4,3), valid (4,)) candidate world->camera poses.
    """
    f1, f2, f3 = bearings[0], bearings[1], bearings[2]
    P1, P2, P3 = Xw[0], Xw[1], Xw[2]
    a2 = jnp.sum((P2 - P3) ** 2)
    b2 = jnp.sum((P1 - P3) ** 2)
    c2 = jnp.sum((P1 - P2) ** 2)
    cos_a = jnp.dot(f2, f3)
    cos_b = jnp.dot(f1, f3)
    cos_g = jnp.dot(f1, f2)

    b2s = jnp.maximum(b2, _EPS)
    acb = (a2 - c2) / b2s
    apb = (a2 + c2) / b2s

    # Haralick et al., Grunert quartic in v (= s3/s1)
    A4 = (acb - 1.0) ** 2 - 4.0 * (c2 / b2s) * cos_a ** 2
    A3 = 4.0 * (acb * (1.0 - acb) * cos_b
                - (1.0 - apb) * cos_a * cos_g
                + 2.0 * (c2 / b2s) * cos_a ** 2 * cos_b)
    A2 = 2.0 * (acb ** 2 - 1.0
                + 2.0 * acb ** 2 * cos_b ** 2
                + 2.0 * ((b2 - c2) / b2s) * cos_a ** 2
                - 4.0 * apb * cos_a * cos_b * cos_g
                + 2.0 * ((b2 - a2) / b2s) * cos_g ** 2)
    A1 = 4.0 * (-acb * (1.0 + acb) * cos_b
                + 2.0 * (a2 / b2s) * cos_g ** 2 * cos_b
                - (1.0 - apb) * cos_a * cos_g)
    A0 = (1.0 + acb) ** 2 - 4.0 * (a2 / b2s) * cos_g ** 2

    coeffs = jnp.stack([A4, A3, A2, A1, A0])
    v, is_real = polynomial.quartic_real_roots(coeffs)

    # u from v (Haralick eq.)
    den_u = 2.0 * (cos_g - v * cos_a)
    den_u = jnp.where(jnp.abs(den_u) < 1e-9, 1e-9, den_u)
    u = ((-1.0 + acb) * v ** 2 - 2.0 * acb * cos_b * v + 1.0 + acb) / den_u

    s1_den = 1.0 + v ** 2 - 2.0 * v * cos_b
    s1 = jnp.sqrt(b2 / jnp.maximum(s1_den, _EPS))
    s2 = u * s1
    s3 = v * s1
    valid = is_real & (s1 > 0) & (s2 > 0) & (s3 > 0)

    # camera-frame points per root, then 3-point absolute orientation
    Xc = jnp.stack([s1[:, None] * f1[None, :].repeat(4, 0),
                    s2[:, None] * f2[None, :].repeat(4, 0),
                    s3[:, None] * f3[None, :].repeat(4, 0)], axis=1)  # (4,3,3)

    def orient(Xc_one):
        s, R, t = umeyama.rigid_align(Xw, Xc_one)
        return R, t

    R, t = jax.vmap(orient)(Xc)
    return R, t, valid


def _control_points(Xw, w):
    """EPnP world control points: weighted centroid + principal axes."""
    wn = w / jnp.maximum(jnp.sum(w), _EPS)
    c0 = jnp.sum(Xw * wn[:, None], axis=0)
    C = Xw - c0
    cov = jnp.einsum("n,ni,nj->ij", wn, C, C)
    lam, V = jnp.linalg.eigh(cov)
    lam = jnp.maximum(lam, _EPS)
    axes = V * jnp.sqrt(lam)[None, :]  # columns scaled
    cw = jnp.stack([c0, c0 + axes[:, 2], c0 + axes[:, 1], c0 + axes[:, 0]])
    return cw


def _barycentric(Xw, cw):
    A = (cw[1:] - cw[0]).T  # 3x3
    Ainv = jnp.linalg.inv(A + _EPS * jnp.eye(3, dtype=Xw.dtype))
    a123 = jnp.einsum("ij,nj->ni", Ainv, Xw - cw[0])
    a0 = 1.0 - jnp.sum(a123, axis=-1, keepdims=True)
    return jnp.concatenate([a0, a123], axis=-1)  # (N,4)


def _beta_case1(v1, dist_w):
    """Scale of single nullvector: least-squares beta for case N=1."""
    cc = v1.reshape(4, 3)
    dc = jnp.linalg.norm(cc[:, None] - cc[None, :], axis=-1)
    iu = jnp.triu_indices(4, 1)
    num = jnp.sum(dc[iu] * dist_w)
    den = jnp.sum(dc[iu] ** 2)
    return num / jnp.maximum(den, _EPS)


def _gauss_newton_betas(Vm, dist_w, beta0, iters: int = 8):
    """Refine betas (4,) minimizing control-point distance residuals.

    Vm: (12, 4) nullspace basis; dist_w: (6,) world control distances.
    """
    iu = jnp.triu_indices(4, 1)

    def residual(betas):
        cc = (Vm @ betas).reshape(4, 3)
        d = cc[:, None] - cc[None, :]
        d2 = jnp.sum(d * d, axis=-1)
        return d2[iu] - dist_w ** 2

    def body(_, betas):
        r = residual(betas)
        J = jax.jacfwd(residual)(betas)  # (6,4)
        JtJ = J.T @ J + 1e-9 * jnp.eye(4, dtype=betas.dtype)
        step = jnp.linalg.solve(JtJ, J.T @ r)
        return betas - step

    return jax.lax.fori_loop(0, iters, body, beta0)


def epnp(Xw, norm_obs, weights=None):
    """EPnP pose from N>=6 world points and normalized observations.

    Re-design of absolute_pose_via_epnp.cc (Lepetit EPnP): case-N=1 beta
    init + 4-beta Gauss-Newton, weighted rows for masked inlier refits.

    Args:
      Xw: (N, 3); norm_obs: (N, 2) centered-pixels / focal; weights: (N,).
    Returns:
      (R, t) world->camera.
    """
    N = Xw.shape[0]
    w = jnp.ones((N,), Xw.dtype) if weights is None else weights
    cw = _control_points(Xw, w)
    alphas = _barycentric(Xw, cw)  # (N,4)

    u, v = norm_obs[:, 0], norm_obs[:, 1]
    # M rows: sum_j a_j * [1, 0, -u] and [0, 1, -v] per control point (f=1)
    zeros = jnp.zeros_like(u)
    ones = jnp.ones_like(u)
    rx = jnp.stack([ones, zeros, -u], axis=-1)   # (N,3)
    ry = jnp.stack([zeros, ones, -v], axis=-1)
    Mx = alphas[:, :, None] * rx[:, None, :]     # (N,4,3)
    My = alphas[:, :, None] * ry[:, None, :]
    M = jnp.concatenate([Mx.reshape(N, 12), My.reshape(N, 12)], axis=0)  # (2N,12)
    ww = jnp.concatenate([w, w])[:, None]
    MtM = (M * ww).T @ M
    lam, V = jnp.linalg.eigh(MtM)
    Vm = V[:, :4]  # 4 smallest eigenvectors, (12,4)

    iu = jnp.triu_indices(4, 1)
    dist_w = jnp.linalg.norm(cw[iu[0]] - cw[iu[1]], axis=-1)

    b1 = _beta_case1(Vm[:, 0], dist_w)
    betas = jnp.array([1.0, 0.0, 0.0, 0.0], Xw.dtype) * b1
    betas = _gauss_newton_betas(Vm, dist_w, betas)

    cc = (Vm @ betas).reshape(4, 3)
    Xc = alphas @ cc  # (N,3)
    # cheirality: flip if weighted mean depth negative
    mean_z = jnp.sum(Xc[:, 2] * w) / jnp.maximum(jnp.sum(w), _EPS)
    Xc = Xc * jnp.where(mean_z < 0, -1.0, 1.0)
    _, R, t = umeyama.rigid_align(Xw, Xc, weights=w)
    return R, t


@partial(jax.jit, static_argnames=("iters",))
def epnp_robust(Xw, obs_px, f, key, mask=None, iters: int = 10,
                subset_frac: float = 0.9):
    """Subset-consensus EPnP (ref EPNPRobust, absolute_pose_via_epnp.cc:45-99).

    The reference fits EPnP on 10 random 90% subsets, accumulates each
    point's reprojection error across the fits, then refits once on the
    90% of points with the lowest accumulated error.  This version keeps
    fixed shapes: subsets are Bernoulli(subset_frac) weight masks, the
    final keep-set is thresholded at the floor(frac * n_valid)-th smallest
    accumulated error (truncation, matching the reference's
    idx_outlier = 0.9 * size()).

    Returns dict: R, t, inlier_mask, avg_err (mean kept-point error px).
    """
    N = Xw.shape[0]
    m = jnp.ones((N,), bool) if mask is None else mask.astype(bool)
    norm_obs = obs_px / f

    def body(acc, k):
        u = jax.random.uniform(k, (N,))
        keep = (u < subset_frac) & m
        R, t = epnp(Xw, norm_obs, weights=keep.astype(Xw.dtype))
        err = reproj_errors_px(R, t, f, Xw, obs_px)
        return acc + jnp.where(jnp.isfinite(err), err, 1e6), None

    acc, _ = jax.lax.scan(body, jnp.zeros((N,), Xw.dtype),
                          jax.random.split(key, iters))
    acc = jnp.where(m, acc, jnp.inf)
    n_valid = jnp.sum(m)
    k_keep = jnp.clip((subset_frac * n_valid).astype(jnp.int32), 4, N)
    thresh = jnp.sort(acc)[k_keep - 1]
    inl = m & (acc <= thresh)
    w = inl.astype(Xw.dtype)
    R, t = epnp(Xw, norm_obs, weights=w)
    err = reproj_errors_px(R, t, f, Xw, obs_px)
    err = jnp.where(jnp.isfinite(err), err, 1e6)
    avg = jnp.sum(err * w) / jnp.maximum(jnp.sum(w), 1.0)
    return {"R": R, "t": t, "inlier_mask": inl, "avg_err": avg}


def reproj_errors_px(R, t, f, Xw, obs_px):
    """Per-point reprojection error in px for pose candidates (no distortion)."""
    Xc = jnp.einsum("...ij,nj->...ni", R, Xw) + t[..., None, :]
    z = Xc[..., 2]
    zsafe = jnp.where(jnp.abs(z) < _EPS, _EPS, z)
    uv = f * Xc[..., :2] / zsafe[..., None]
    err = jnp.linalg.norm(uv - obs_px, axis=-1)
    return jnp.where(z > 0, err, jnp.inf)


@partial(jax.jit, static_argnames=("num_hypotheses",))
def pnp_ransac(Xw, obs_px, f, key, mask=None, num_hypotheses: int = 256,
               th_inlier_px: float = 10.0):
    """Batched P3P-RANSAC + EPnP refit (ref EPNPRansac, absolute_pose_via_epnp.cc:101-184).

    Args:
      Xw: (N, 3) world points; obs_px: (N, 2) centered pixels; f: focal.
      key: PRNG key; mask: (N,) valid-correspondence mask.
      num_hypotheses: RANSAC budget (ref: 200 minimal samples).
      th_inlier_px: inlier gate (ref: 10 px).
    Returns dict: R, t, inlier_mask, n_inliers, avg_err (mean inlier err px).
    """
    N = Xw.shape[0]
    m = jnp.ones((N,), bool) if mask is None else mask.astype(bool)
    # sample 3 distinct-ish indices per hypothesis, biased to valid entries
    logits = jnp.where(m, 0.0, -1e9)
    keys = jax.random.split(key, num_hypotheses)
    idx = jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(3,), replace=False, p=jax.nn.softmax(logits)))(keys)

    bear = jnp.concatenate([obs_px / f, jnp.ones_like(obs_px[:, :1])], axis=-1)
    bear = bear / jnp.linalg.norm(bear, axis=-1, keepdims=True)

    def solve_one(sample_idx):
        R, t, valid = p3p_grunert(Xw[sample_idx], bear[sample_idx])
        return R, t, valid

    Rs, ts, valids = jax.vmap(solve_one)(idx)      # (H,4,3,3), (H,4,3), (H,4)
    Rs = Rs.reshape(-1, 3, 3)
    ts = ts.reshape(-1, 3)
    valids = valids.reshape(-1)

    errs = reproj_errors_px(Rs, ts, f, Xw, obs_px)  # (H*4, N)
    inl = (errs < th_inlier_px) & m[None, :]
    n_inl = jnp.sum(inl, axis=-1) * valids.astype(jnp.int32)
    best = jnp.argmax(n_inl)

    best_inl = inl[best]
    # EPnP refit on inliers (2 rounds of re-gating), weighted
    def refit(carry, _):
        inlier_mask = carry
        w = inlier_mask.astype(Xw.dtype)
        R, t = epnp(Xw, obs_px / f, weights=w)
        e = reproj_errors_px(R, t, f, Xw, obs_px)
        new_mask = (e < th_inlier_px) & m
        # keep refit only if it doesn't collapse
        ok = jnp.sum(new_mask) >= jnp.maximum(jnp.sum(inlier_mask) // 2, 4)
        return jnp.where(ok, new_mask, inlier_mask), (R, t, ok)

    final_mask, (R_ref, t_ref, ok) = jax.lax.scan(refit, best_inl, None, length=2)
    R_fin = jnp.where(ok[-1], R_ref[-1], Rs[best])
    t_fin = jnp.where(ok[-1], t_ref[-1], ts[best])

    e_fin = reproj_errors_px(R_fin, t_fin, f, Xw, obs_px)
    fin_inl = (e_fin < th_inlier_px) & m
    n = jnp.sum(fin_inl)
    avg = jnp.sum(jnp.where(fin_inl, e_fin, 0.0)) / jnp.maximum(n, 1)
    return {"R": R_fin, "t": t_fin, "inlier_mask": fin_inl,
            "n_inliers": n, "avg_err": avg}


def p4pf(Xw, obs_px, f_hyp, num_focal_samples: int = 128,
         newton_iters: int = 6, f_lo: float = 0.3, f_hi: float = 5.0):
    """Pose + focal from exactly 4 points (ref absolute_pose_via_p4pf.{h,cc}).

    The reference uses a 903-line generated Groebner-basis template
    (p4pf_helper.cc); a batched focal sweep is the vectorized
    equivalent: P3P (Grunert quartic) on points 0..2 for every focal sample
    at once, scored by the 4th point's reprojection, then Newton-polished on
    log f.  Same minimal-input capability, no generated code.

    Args:
      Xw: (4, 3) world points; obs_px: (4, 2) centered pixels.
      f_hyp: focal hypothesis (e.g. 1.2 * max(w, h)).
    Returns:
      dict R (3,3), t (3,), f (), err4 () 4th-point reproj err px, valid ().
    """
    fs = f_hyp * jnp.exp(jnp.linspace(jnp.log(f_lo), jnp.log(f_hi),
                                      num_focal_samples))

    def err_for_f(f):
        bear = jnp.concatenate([obs_px[:3] / f,
                                jnp.ones_like(obs_px[:3, :1])], axis=-1)
        bear = bear / jnp.linalg.norm(bear, axis=-1, keepdims=True)
        R, t, valid = p3p_grunert(Xw[:3], bear)        # (4,3,3),(4,3),(4,)
        e4 = reproj_errors_px(R, t, f, Xw[3:4], obs_px[3:4])[:, 0]
        e4 = jnp.where(valid, e4, jnp.inf)
        b = jnp.argmin(e4)
        return e4[b], R[b], t[b]

    e4s, Rs, ts = jax.vmap(err_for_f)(fs)
    bi = jnp.argmin(e4s)

    # Newton on log f: minimize 4th-point error via central differences
    def newton(_, lf):
        h = 1e-3
        e0, _, _ = err_for_f(jnp.exp(lf - h))
        e1, _, _ = err_for_f(jnp.exp(lf))
        e2, _, _ = err_for_f(jnp.exp(lf + h))
        g = (e2 - e0) / (2 * h)
        H = (e2 - 2 * e1 + e0) / (h * h)
        step = jnp.where(H > 1e-9, g / H, 0.0)
        return lf - jnp.clip(step, -0.2, 0.2)

    lf = jax.lax.fori_loop(0, newton_iters, newton, jnp.log(fs[bi]))
    f_fin = jnp.exp(lf)
    e4, R_fin, t_fin = err_for_f(f_fin)
    better = e4 < e4s[bi]
    f_fin = jnp.where(better, f_fin, fs[bi])
    R_fin = jnp.where(better, R_fin, Rs[bi])
    t_fin = jnp.where(better, t_fin, ts[bi])
    e_fin = jnp.minimum(e4, e4s[bi])
    return {"R": R_fin, "t": t_fin, "f": f_fin, "err4": e_fin,
            "valid": jnp.isfinite(e_fin)}


def p3pf(Xw, obs_px, f_hyp, num_focal_samples: int = 128,
         f_lo: float = 0.3, f_hi: float = 5.0):
    """Pose + focal candidates from 3 points (ref absolute_pose_via_p3pf.{h,cc}).

    3 points underdetermine (pose, focal); like the reference, returns the
    candidate set over the focal sweep — callers disambiguate with extra
    correspondences (RANSAC scoring).
    Returns dict R (S,4,3,3), t (S,4,3), f (S,), valid (S,4).
    """
    fs = f_hyp * jnp.exp(jnp.linspace(jnp.log(f_lo), jnp.log(f_hi),
                                      num_focal_samples))

    def solve_f(f):
        bear = jnp.concatenate([obs_px / f, jnp.ones_like(obs_px[:, :1])],
                               axis=-1)
        bear = bear / jnp.linalg.norm(bear, axis=-1, keepdims=True)
        return p3p_grunert(Xw, bear)

    R, t, valid = jax.vmap(solve_f)(fs)
    return {"R": R, "t": t, "f": fs, "valid": valid}


def dlt_oriented(R, Xw, obs_px, f=None, weights=None):
    """Position (+ optional focal) given a known rotation.

    Reference absolute_pose_via_dlt_oriented.{h,cc}: with R fixed (from
    vanishing points / IMU), projection is *linear* in the remaining
    unknowns.  Known f: 2N x 3 least squares for t.  Unknown f: substitute
    s = f*t_xy so the system is linear in (f, s_x, s_y, t_z) — recover
    t_xy = s / f.

    Args:
      R: (3, 3) world->camera rotation; Xw: (N, 3); obs_px: (N, 2).
      f: known focal or None; weights: (N,) optional row weights.
    Returns:
      dict t (3,), f ().
    """
    Xc = jnp.einsum("ij,nj->ni", R, Xw)            # rotated points
    u, v = obs_px[:, 0], obs_px[:, 1]
    N = Xw.shape[0]
    w = jnp.ones((N,), Xw.dtype) if weights is None else weights
    zeros = jnp.zeros_like(u)
    ones = jnp.ones_like(u)
    if f is not None:
        # f*(Xc_x + t_x) = u*(Xc_z + t_z)  ->  rows linear in t
        A = jnp.concatenate([
            jnp.stack([f * ones, zeros, -u], axis=-1),
            jnp.stack([zeros, f * ones, -v], axis=-1)], axis=0)
        b = jnp.concatenate([u * Xc[:, 2] - f * Xc[:, 0],
                             v * Xc[:, 2] - f * Xc[:, 1]])
        ww = jnp.concatenate([w, w])
        AtA = (A * ww[:, None]).T @ A + 1e-9 * jnp.eye(3, dtype=Xw.dtype)
        t = jnp.linalg.solve(AtA, (A * ww[:, None]).T @ b)
        return {"t": t, "f": jnp.asarray(f, Xw.dtype)}
    # unknowns (f, s_x, s_y, t_z): f*Xc_x + s_x - u*t_z = u*Xc_z
    A = jnp.concatenate([
        jnp.stack([Xc[:, 0], ones, zeros, -u], axis=-1),
        jnp.stack([Xc[:, 1], zeros, ones, -v], axis=-1)], axis=0)
    b = jnp.concatenate([u * Xc[:, 2], v * Xc[:, 2]])
    ww = jnp.concatenate([w, w])
    AtA = (A * ww[:, None]).T @ A + 1e-9 * jnp.eye(4, dtype=Xw.dtype)
    x = jnp.linalg.solve(AtA, (A * ww[:, None]).T @ b)
    f_est = x[0]
    fsafe = jnp.where(jnp.abs(f_est) < _EPS, _EPS, f_est)
    t = jnp.stack([x[1] / fsafe, x[2] / fsafe, x[3]])
    return {"t": t, "f": f_est}


@partial(jax.jit, static_argnames=("num_hypotheses", "num_focal_samples"))
def pnp_ransac_unknown_focal(Xw, obs_px, f_hyp, key, mask=None,
                             num_hypotheses: int = 64,
                             num_focal_samples: int = 64,
                             th_inlier_px: float = 10.0,
                             f_lo: float = 0.5, f_hi: float = 4.0):
    """Unknown-focal PnP: focal grid x shared P3P hypotheses (ref EPnP-f).

    The reference samples f in [0.5, 4.0]*f_hyp at step 0.01 with a full
    EPnP-RANSAC each (absolute_pose_via_epnpf.cc:35-64); here the focal grid
    is a vmapped axis sharing one P3P sample set, then the winner is refit.
    Returns dict: R, t, f, inlier_mask, n_inliers, avg_err.
    """
    fs = f_hyp * jnp.linspace(f_lo, f_hi, num_focal_samples)
    N = Xw.shape[0]
    m = jnp.ones((N,), bool) if mask is None else mask.astype(bool)
    logits = jnp.where(m, 0.0, -1e9)
    keys = jax.random.split(key, num_hypotheses)
    idx = jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(3,), replace=False, p=jax.nn.softmax(logits)))(keys)

    def score_focal(f):
        bear = jnp.concatenate([obs_px / f, jnp.ones_like(obs_px[:, :1])], axis=-1)
        bear = bear / jnp.linalg.norm(bear, axis=-1, keepdims=True)
        Rs, ts, valids = jax.vmap(lambda si: p3p_grunert(Xw[si], bear[si]))(idx)
        Rs = Rs.reshape(-1, 3, 3)
        ts = ts.reshape(-1, 3)
        valids = valids.reshape(-1)
        errs = reproj_errors_px(Rs, ts, f, Xw, obs_px)
        inl = (errs < th_inlier_px) & m[None, :]
        n_inl = jnp.sum(inl, axis=-1) * valids.astype(jnp.int32)
        b = jnp.argmax(n_inl)
        return n_inl[b], Rs[b], ts[b], inl[b]

    n_best, R_best, t_best, inl_best = jax.vmap(score_focal)(fs)
    bi = jnp.argmax(n_best)
    f_best = fs[bi]

    w = inl_best[bi].astype(Xw.dtype)
    R, t = epnp(Xw, obs_px / f_best, weights=w)
    e = reproj_errors_px(R, t, f_best, Xw, obs_px)
    fin_inl = (e < th_inlier_px) & m
    ok = jnp.sum(fin_inl) >= jnp.maximum(n_best[bi] // 2, 4)
    R_fin = jnp.where(ok, R, R_best[bi])
    t_fin = jnp.where(ok, t, t_best[bi])
    e_fin = reproj_errors_px(R_fin, t_fin, f_best, Xw, obs_px)
    fin_inl = (e_fin < th_inlier_px) & m
    n = jnp.sum(fin_inl)
    avg = jnp.sum(jnp.where(fin_inl, e_fin, 0.0)) / jnp.maximum(n, 1)
    return {"R": R_fin, "t": t_fin, "f": f_best, "inlier_mask": fin_inl,
            "n_inliers": n, "avg_err": avg}
