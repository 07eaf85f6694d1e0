"""Nister 5-point essential-matrix minimal solver, XLA-native.

Capability parity with the reference's 5-point solver
(SfM/src/orientation/essential_matrix_five_point.{h,cc}: Gauss-Jordan on the
10x20 cubic-constraint system + 10th-degree polynomial), re-derived for
batched f32 execution:

* The 4-dim nullspace of the 5x9 epipolar system comes from `eigh` of Q^T Q
  (symmetric eig is available on every JAX backend; general eig is not).
* The 10 cubic constraints (det(E)=0 and the 9 trace constraints
  2 E E^T E - tr(E E^T) E = 0) are expanded over the 20 monomials of
  (x, y, z) at *trace time* with plain Python polynomial bookkeeping — the
  compiled graph is pure batched arithmetic, no generated-code template.
* Elimination: solve A[:, :10] X = A[:, 10:] (one 10x10 LU), then Nister's
  z-polynomial 3x3 determinant gives the degree-10 polynomial whose real
  roots are found by dense sign-change bracketing + fixed-iteration
  bisection (polynomial.real_roots_bracketed) — replacing the reference's
  companion-matrix eigen root finder
  (utils/find_polynomial_roots_companion_matrix.cc), which needs the
  non-symmetric eig JAX lacks on accelerators.  Grid evaluation is embarrassingly
  vectorizable, and unlike simultaneous-iteration methods it cannot stall
  on clustered roots.
* All <=10 candidate E's are returned with a validity mask; RANSAC scores
  every candidate of every sample in one einsum (hypotheses are cheap in
  batch, so no per-sample candidate selection is needed).

Unlike the 8-point path (ops/epipolar.py), this solver is exact for planar
scenes and needs only 5 correspondences.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import epipolar, polynomial

_EPS = 1e-12

# Monomial order for the 10x20 constraint matrix (Nister's order):
# first 10 (eliminated):  x^3, y^3, x^2 y, x y^2, x^2 z, x^2, y^2 z, y^2, x y z, x y
# last 10 (kept):         x z^2, x z, x, y z^2, y z, y, z^3, z^2, z, 1
_MONOMIALS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0), (2, 0, 1),
    (2, 0, 0), (0, 2, 1), (0, 2, 0), (1, 1, 1), (1, 1, 0),
    (1, 0, 2), (1, 0, 1), (1, 0, 0), (0, 1, 2), (0, 1, 1),
    (0, 1, 0), (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_MONO_INDEX = {m: i for i, m in enumerate(_MONOMIALS)}


def _nullspace4(norm1, norm2):
    """4 basis E's spanning the nullspace of the 5x9 epipolar system.

    norm1/norm2: (5, 2) K-normalized correspondences, x2^T E x1 = 0.
    Returns (4, 3, 3).
    """
    x1, y1 = norm1[:, 0], norm1[:, 1]
    x2, y2 = norm2[:, 0], norm2[:, 1]
    ones = jnp.ones_like(x1)
    Q = jnp.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
                  axis=-1)                       # (5, 9)
    # full SVD (not eigh of Q^T Q, which squares the condition number — a
    # real accuracy loss in f32): right singular vectors 5..8 span the
    # nullspace.
    _, _, Vt = jnp.linalg.svd(Q, full_matrices=True)
    return Vt[5:9].reshape(4, 3, 3)


class _Poly:
    """Trace-time polynomial in (x, y, z): dict exponent-triple -> jnp scalar.

    Exists only while tracing; the compiled graph sees plain adds/muls.
    """

    __slots__ = ("terms",)

    def __init__(self, terms=None):
        self.terms = dict(terms or {})

    @staticmethod
    def linear(cx, cy, cz, c1):
        return _Poly({(1, 0, 0): cx, (0, 1, 0): cy, (0, 0, 1): cz,
                      (0, 0, 0): c1})

    def __add__(self, other):
        out = dict(self.terms)
        for k, v in other.terms.items():
            out[k] = out[k] + v if k in out else v
        return _Poly(out)

    def __sub__(self, other):
        out = dict(self.terms)
        for k, v in other.terms.items():
            out[k] = out[k] - v if k in out else -v
        return _Poly(out)

    def __mul__(self, other):
        out = {}
        for ka, va in self.terms.items():
            for kb, vb in other.terms.items():
                k = (ka[0] + kb[0], ka[1] + kb[1], ka[2] + kb[2])
                prod = va * vb
                out[k] = out[k] + prod if k in out else prod
        return _Poly(out)

    def scale(self, s):
        return _Poly({k: v * s for k, v in self.terms.items()})

    def to_row(self, dtype):
        return jnp.stack([self.terms.get(m, jnp.zeros((), dtype))
                          for m in _MONOMIALS])


def _constraint_matrix(basis):
    """(10, 20) coefficient matrix of the det + trace cubic constraints.

    basis: (4, 3, 3) nullspace E's; E = x*B0 + y*B1 + z*B2 + B3.
    """
    dtype = basis.dtype
    E = [[_Poly.linear(basis[0, i, j], basis[1, i, j], basis[2, i, j],
                       basis[3, i, j]) for j in range(3)] for i in range(3)]

    # det(E) = 0
    det = (E[0][0] * (E[1][1] * E[2][2] - E[1][2] * E[2][1])
           - E[0][1] * (E[1][0] * E[2][2] - E[1][2] * E[2][0])
           + E[0][2] * (E[1][0] * E[2][1] - E[1][1] * E[2][0]))

    # 2 E E^T E - tr(E E^T) E = 0  (9 equations)
    EEt = [[sum((E[i][k] * E[j][k] for k in range(3)), _Poly())
            for j in range(3)] for i in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]
    rows = [det.to_row(dtype)]
    for i in range(3):
        for j in range(3):
            expr = sum((EEt[i][k] * E[k][j] for k in range(3)),
                       _Poly()).scale(jnp.asarray(2.0, dtype)) - tr * E[i][j]
            rows.append(expr.to_row(dtype))
    return jnp.stack(rows)                        # (10, 20)


def _polymul(a, b):
    """1-D polynomial product, ascending coefficients."""
    la, lb = a.shape[-1], b.shape[-1]
    out = jnp.zeros(a.shape[:-1] + (la + lb - 1,), a.dtype)
    for i in range(la):
        for j in range(lb):
            out = out.at[..., i + j].add(a[..., i] * b[..., j])
    return out


def essential_5pt(norm1, norm2):
    """All essential matrices fitting 5 K-normalized correspondences.

    Args:
      norm1, norm2: (5, 2) correspondences with x2^T E x1 = 0.
    Returns:
      E: (10, 3, 3) candidate essential matrices (Frobenius-normalized).
      valid: (10,) bool — True for candidates from real polynomial roots.
    """
    dtype = norm1.dtype
    basis = _nullspace4(norm1, norm2)
    A = _constraint_matrix(basis)
    eye10 = jnp.eye(10, dtype=dtype)
    B = jnp.linalg.solve(A[:, :10] + 1e-14 * eye10, A[:, 10:])   # (10, 10)

    # Nister rows: pairs (4,5)=(x^2 z, x^2), (6,7)=(y^2 z, y^2), (8,9)=(x y z, x y).
    # row_a - z*row_b = 0 over kept monomials => [P(z)] [x, y, 1]^T = 0 with
    # P 3x3 of z-polynomials: px,py degree 3, p1 degree 4 (ascending coeffs).
    def zrow(a, b):
        # coefficient of monomial j in (B[a] - z B[b]); kept-monomial z-powers:
        # x z^2, x z, x | y z^2, y z, y | z^3, z^2, z, 1
        def shift_combo(idxs, deg):
            # poly(z) = sum_i (B[a, idxs[i]] - z B[b, idxs[i]]) z^powers[i]
            powers = list(range(len(idxs) - 1, -1, -1)) if deg is None else deg
            n = max(powers) + 2
            c = jnp.zeros((n,), dtype)
            for i, p in zip(idxs, powers):
                c = c.at[p].add(B[a, i])
                c = c.at[p + 1].add(-B[b, i])
            return c

        px = shift_combo([0, 1, 2], [2, 1, 0])       # degree 3 -> 4 coeffs
        py = shift_combo([3, 4, 5], [2, 1, 0])
        p1 = shift_combo([6, 7, 8, 9], [3, 2, 1, 0])  # degree 4 -> 5 coeffs
        # per-row scale normalization: det roots are invariant to row
        # scaling, and keeping coefficients O(1) preserves f32 accuracy
        # through the degree-10 polynomial products below
        s = jnp.maximum(jnp.max(jnp.abs(jnp.concatenate([px, py, p1]))), _EPS)
        return px / s, py / s, p1 / s

    P = [zrow(4, 5), zrow(6, 7), zrow(8, 9)]

    def pminus(a, b):
        n = max(a.shape[-1], b.shape[-1])
        return (jnp.pad(a, (0, n - a.shape[-1]))
                - jnp.pad(b, (0, n - b.shape[-1])))

    # det of [[px0,py0,p10],[px1,py1,p11],[px2,py2,p12]] by cofactor expansion
    m01 = pminus(_polymul(P[1][0], P[2][1]), _polymul(P[2][0], P[1][1]))  # x1*y2-x2*y1
    m02 = pminus(_polymul(P[1][0], P[2][2]), _polymul(P[2][0], P[1][2]))
    m12 = pminus(_polymul(P[1][1], P[2][2]), _polymul(P[2][1], P[1][2]))
    det = pminus(_polymul(P[0][0], m12), _polymul(P[0][1], m02))
    det = pminus(det, -_polymul(P[0][2], m01))
    # det has degree 10 -> 11 ascending coeffs; root finder wants descending
    coeffs = det[::-1]
    z, is_real = polynomial.real_roots_bracketed(coeffs, max_roots=10, grid_size=8192)

    # back-substitute: x, y from 2 of the 3 rows evaluated at z
    def eval_poly(c, zz):
        return jnp.polyval(c[::-1], zz)

    def xy_from_z(zz):
        rows = [(eval_poly(P[i][0], zz), eval_poly(P[i][1], zz),
                 eval_poly(P[i][2], zz)) for i in range(3)]
        # least-squares over all 3 rows: [px py][x y]^T = -p1
        Am = jnp.array([[rows[0][0], rows[0][1]],
                        [rows[1][0], rows[1][1]],
                        [rows[2][0], rows[2][1]]])
        bm = -jnp.array([rows[0][2], rows[1][2], rows[2][2]])
        AtA = Am.T @ Am + 1e-12 * jnp.eye(2, dtype=dtype)
        xy = jnp.linalg.solve(AtA, Am.T @ bm)
        return xy[0], xy[1]

    xs, ys = jax.vmap(xy_from_z)(z)

    # Gauss-Newton polish of (x, y, z) on the original 10 constraint
    # equations A m(x,y,z) = 0 — recovers the f32 accuracy lost through the
    # elimination + determinant chain (f64 would need none; the pipeline
    # runs f32).
    exps = jnp.asarray(_MONOMIALS, jnp.int32)                    # (20, 3)

    def monomials(v):
        # m_k = x^ex y^ey z^ez and exact partials (no division — stable at 0)
        pows = v[None, :] ** exps                                # (20, 3)
        pml = v[None, :] ** jnp.maximum(exps - 1, 0)
        m = pows[:, 0] * pows[:, 1] * pows[:, 2]
        e = exps.astype(dtype)
        dm = jnp.stack([
            e[:, 0] * pml[:, 0] * pows[:, 1] * pows[:, 2],
            e[:, 1] * pml[:, 1] * pows[:, 0] * pows[:, 2],
            e[:, 2] * pml[:, 2] * pows[:, 0] * pows[:, 1],
        ], axis=-1)                                              # (20, 3)
        return m, dm

    def polish(v, _):
        m, dm = monomials(v)
        r = A @ m                                                # (10,)
        J = A @ dm                                               # (10, 3)
        JtJ = J.T @ J + 1e-10 * jnp.eye(3, dtype=dtype)
        step = jnp.linalg.solve(JtJ, J.T @ r)
        return v - step, None

    v0 = jnp.stack([xs, ys, z], axis=-1)                         # (10, 3)
    v_fin, _ = jax.lax.scan(lambda vv, _: (jax.vmap(
        lambda v: polish(v, None)[0])(vv), None), v0, None, length=4)
    xs, ys, z = v_fin[:, 0], v_fin[:, 1], v_fin[:, 2]

    Es = (xs[:, None, None] * basis[0] + ys[:, None, None] * basis[1]
          + z[:, None, None] * basis[2] + basis[3])
    nrm = jnp.linalg.norm(Es.reshape(10, 9), axis=-1)
    Es = Es / jnp.maximum(nrm[:, None, None], _EPS)
    return Es, is_real


@partial(jax.jit, static_argnames=("num_hypotheses", "refit_rounds"))
def essential_ransac_5pt(norm1, norm2, key, mask=None,
                         num_hypotheses: int = 128, th_sampson: float = 1e-5,
                         min_inliers: int = 15, refit_rounds: int = 2):
    """Batched 5-point E-RANSAC (reference essential_matrix_five_point.cc:30-93).

    Each of the `num_hypotheses` minimal samples yields <=10 candidate E's;
    all `10*num_hypotheses` candidates are Sampson-scored against every
    correspondence at once.  Winner is polished with masked 8-point refits
    (projection back onto the essential manifold), as the reference polishes
    with its inlier refit.

    Returns dict: E, inlier_mask, n_inliers, ok.
    """
    N = norm1.shape[0]
    m = jnp.ones((N,), bool) if mask is None else mask.astype(bool)
    logits = jnp.where(m, 0.0, -1e9)
    keys = jax.random.split(key, num_hypotheses)
    idx = jax.vmap(lambda k: jax.random.choice(
        k, N, shape=(5,), replace=False, p=jax.nn.softmax(logits)))(keys)

    Es, valid = jax.vmap(lambda si: essential_5pt(norm1[si], norm2[si]))(idx)
    Es = Es.reshape(-1, 3, 3)                    # (H*10, 3, 3)
    valid = valid.reshape(-1)
    d = epipolar.sampson_distance(Es, norm1, norm2)   # (H*10, N)
    inl = (d < th_sampson) & m[None, :] & valid[:, None]
    n_inl = jnp.sum(inl, axis=-1)
    best = jnp.argmax(n_inl)

    def refit(inlier_mask, _):
        w = inlier_mask.astype(norm1.dtype)
        E = epipolar.essential_8pt(norm1, norm2, weights=w)
        dd = epipolar.sampson_distance(E, norm1, norm2)
        new = (dd < th_sampson) & m
        ok = jnp.sum(new) >= jnp.maximum(jnp.sum(inlier_mask) // 2, 5)
        return jnp.where(ok, new, inlier_mask), E

    fin_mask, E_hist = jax.lax.scan(refit, inl[best], None, length=refit_rounds)
    E = jnp.where(jnp.sum(fin_mask) >= 8, E_hist[-1], Es[best])
    n = jnp.sum(fin_mask)
    return {"E": E, "inlier_mask": fin_mask, "n_inliers": n,
            "ok": n >= min_inliers}


def relative_pose_known_focal_5pt(pts1, pts2, f1, f2, key, mask=None,
                                  num_hypotheses: int = 128,
                                  th_sampson_px: float = 2.0):
    """Calibrated relative pose via 5-point RANSAC + cheirality decomposition.

    Robust (planar-safe) alternative to epipolar.relative_pose_known_focal,
    mirroring the reference's calibrated path
    (relative_pose_estimation.cc:90-120 -> essential_matrix_five_point.cc).
    `th_sampson_px` is converted to normalized units via the mean focal.
    Returns dict with R, t, E, n_front, inlier_mask, ok.
    """
    n1 = pts1 / f1
    n2 = pts2 / f2
    fm = 0.5 * (f1 + f2)
    th = (th_sampson_px / fm) ** 2
    out = essential_ransac_5pt(n1, n2, key, mask=mask,
                               num_hypotheses=num_hypotheses, th_sampson=th)
    R, t, votes = epipolar.decompose_essential(
        out["E"], n1, n2, mask=out["inlier_mask"])
    return {"R": R, "t": t, "E": out["E"], "n_front": votes,
            "inlier_mask": out["inlier_mask"], "n_inliers": out["n_inliers"],
            "ok": out["ok"]}
