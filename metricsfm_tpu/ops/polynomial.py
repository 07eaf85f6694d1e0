"""Polynomial root finding, XLA-native.

Replaces the reference's companion-matrix eigen root finders
(SfM/src/utils/polynomial.{h,cc},
 utils/find_polynomial_roots_companion_matrix.{h,cc}).  Non-symmetric
eigendecomposition is unavailable on JAX's accelerator backends, so roots
are found with a fixed
iteration-count Durand-Kerner (Weierstrass) method using *manual* complex
arithmetic (re/im pairs of real arrays) — no complex dtype, fully jittable
and vmappable on any backend.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-20


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    d = jnp.maximum(d, _EPS)
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def _poly_eval(coeffs, zr, zi):
    """Evaluate monic-ordered polynomial coeffs[0]*z^d + ... + coeffs[d] at z.

    coeffs: (..., d+1) real; zr, zi: (..., k) evaluation points.
    """
    pr = jnp.zeros_like(zr) + coeffs[..., 0:1]
    pi = jnp.zeros_like(zi)
    d = coeffs.shape[-1] - 1
    for k in range(1, d + 1):
        pr, pi = _cmul(pr, pi, zr, zi)
        pr = pr + coeffs[..., k:k + 1]
    return pr, pi


def _poly_eval_deriv(coeffs, zr, zi):
    """Evaluate p'(z) for descending-order coeffs at complex z."""
    d = coeffs.shape[-1] - 1
    powers = jnp.arange(d, 0, -1, dtype=coeffs.dtype)
    dcoeffs = coeffs[..., :-1] * powers
    pr = jnp.zeros_like(zr) + dcoeffs[..., 0:1]
    pi = jnp.zeros_like(zi)
    for k in range(1, d):
        pr, pi = _cmul(pr, pi, zr, zi)
        pr = pr + dcoeffs[..., k:k + 1]
    return pr, pi


def roots_durand_kerner(coeffs, iters: int = 60, newton_iters: int = 12):
    """All (complex) roots of a real-coefficient polynomial.

    Args:
      coeffs: (..., d+1) descending-order coefficients (leading may be any
        nonzero value; internally normalized to monic).
      iters: fixed Weierstrass iteration count.
      newton_iters: complex-Newton polish steps after Weierstrass —
        quadratic convergence near simple roots sharpens both the root
        values and the real/complex classification (Weierstrass alone can
        stall when root magnitudes are widely spread).

    Returns:
      (roots_re, roots_im): each (..., d).
    """
    d = coeffs.shape[-1] - 1
    lead = coeffs[..., 0:1]
    lead = jnp.where(jnp.abs(lead) < 1e-12, jnp.where(lead < 0, -1e-12, 1e-12), lead)
    monic = coeffs / lead

    # scale roots into O(1): substitute z = s*w with s = max|a_k|^(1/k)
    powers = jnp.arange(1, d + 1, dtype=coeffs.dtype)
    mags = jnp.abs(monic[..., 1:])
    s = jnp.max(mags ** (1.0 / powers), axis=-1, keepdims=True)
    s = jnp.maximum(s, 1e-6)
    scaled = monic * (s ** -jnp.arange(0, d + 1, dtype=coeffs.dtype)) * 1.0
    # renormalize to monic in w: coefficient k becomes a_k / s^k (monic stays 1)

    # Bini-style initial guesses: spread over the Cauchy-bound annulus
    # [r_lo, r_hi] containing every root, with non-symmetric angles.  An
    # all-on-one-circle init (the textbook (0.4+0.9i)^k) makes Aberth wander
    # for hundreds of iterations when root magnitudes span decades.
    a_last = jnp.abs(scaled[..., -1:])
    a_mid = jnp.max(jnp.abs(scaled[..., 1:]), axis=-1, keepdims=True)
    r_hi = 1.0 + jnp.max(jnp.abs(scaled), axis=-1, keepdims=True)
    r_lo = jnp.maximum(a_last / (a_last + jnp.maximum(a_mid, 1.0)), 1e-3)
    frac = jnp.arange(d, dtype=coeffs.dtype) / max(d - 1, 1)
    radii = r_lo * (r_hi / r_lo) ** frac                  # (..., d) geometric
    angles = jnp.arange(d, dtype=coeffs.dtype) * (2.0 * jnp.pi * 0.382) + 0.4
    zr = radii * jnp.cos(angles)
    zi = radii * jnp.sin(angles)

    def weierstrass(_, zz):
        zr, zi = zz
        pr, pi = _poly_eval(scaled, zr, zi)
        # denom = prod_{j != i} (z_i - z_j)
        dr = zr[..., :, None] - zr[..., None, :]
        di = zi[..., :, None] - zi[..., None, :]
        eye = jnp.eye(d, dtype=coeffs.dtype)
        dr = dr + eye  # diagonal -> 1 (excluded from product)
        qr = jnp.ones_like(zr)
        qi = jnp.zeros_like(zi)
        for j in range(d):
            qr, qi = _cmul(qr, qi, dr[..., j], di[..., j])
        wr, wi = _cdiv(pr, pi, qr, qi)
        return zr - wr, zi - wi

    def aberth(_, zz):
        # Ehrlich-Aberth: Newton step with mutual repulsion — cubic
        # convergence, approximations cannot collapse onto one root (which
        # plain Newton polishing does for clustered roots).
        zr, zi = zz
        pr, pi = _poly_eval(scaled, zr, zi)
        dpr, dpi = _poly_eval_deriv(scaled, zr, zi)
        wr, wi = _cdiv(pr, pi, dpr, dpi)              # Newton correction
        dr = zr[..., :, None] - zr[..., None, :]
        di = zi[..., :, None] - zi[..., None, :]
        eye = jnp.eye(d, dtype=coeffs.dtype)
        dr = dr + eye
        den = dr * dr + di * di
        den = jnp.maximum(den, _EPS)
        inv_r = dr / den * (1.0 - eye)                # sum_{j!=i} 1/(z_i-z_j)
        inv_i = -di / den * (1.0 - eye)
        sr = jnp.sum(inv_r, axis=-1)
        si = jnp.sum(inv_i, axis=-1)
        # step = w / (1 - w * S)
        br, bi = _cmul(wr, wi, sr, si)
        stepr, stepi = _cdiv(wr, wi, 1.0 - br, -bi)
        return zr - stepr, zi - stepi

    zr, zi = jax.lax.fori_loop(0, iters, weierstrass, (zr, zi))
    zr, zi = jax.lax.fori_loop(0, newton_iters, aberth, (zr, zi))
    return zr * s, zi * s


def real_roots(coeffs, iters: int = 60, imag_tol: float = 1e-4,
               newton_iters: int = 12):
    """Real roots of a polynomial with validity mask.

    Returns (roots (..., d), is_real (..., d)).  Non-real entries carry their
    real parts; mask them out.
    """
    zr, zi = roots_durand_kerner(coeffs, iters, newton_iters)
    scale = 1.0 + jnp.abs(zr)
    return zr, jnp.abs(zi) < imag_tol * scale


def quartic_real_roots(coeffs, iters: int = 60):
    """Real roots of a quartic (descending coeffs, shape (..., 5))."""
    return real_roots(coeffs, iters)


def _poly_eval_real(coeffs, x):
    """Horner for real x: coeffs (d+1,) descending, x (...,)."""
    p = jnp.zeros_like(x) + coeffs[0]
    for k in range(1, coeffs.shape[-1]):
        p = p * x + coeffs[k]
    return p


def real_roots_bracketed(coeffs, max_roots: int, grid_size: int = 2048,
                         bisect_iters: int = 60, newton_iters: int = 3):
    """All simple real roots via sign-change bracketing + bisection.

    Deterministic and stall-free (unlike simultaneous iteration, which can
    wander for clustered roots): evaluate p on a cubically-spaced symmetric
    grid spanning the Cauchy root bound, bracket sign changes, bisect each
    bracket a fixed number of iterations, then Newton-polish.  Roots of even
    multiplicity (no sign change) are not found — harmless inside RANSAC,
    where tangent configurations are measure-zero.

    Args:
      coeffs: (d+1,) descending real coefficients (single polynomial).
      max_roots: static number of root slots returned (>= expected #real).
    Returns:
      (roots (max_roots,), valid (max_roots,) bool).
    """
    dtype = coeffs.dtype
    lead = coeffs[0]
    lead = jnp.where(jnp.abs(lead) < 1e-14,
                     jnp.where(lead < 0, -1e-14, 1e-14), lead)
    monic = coeffs / lead
    # Fujiwara bound: R <= 2 max_k |a_k|^(1/k) — far tighter than Cauchy's
    # 1 + max|a_k| when coefficients span decades (critical in f32, where an
    # oversized grid range costs resolution near the actual roots).
    d = monic.shape[-1] - 1
    kk = jnp.arange(1, d + 1, dtype=dtype)
    mags = jnp.abs(monic[1:])
    mags = mags.at[-1].multiply(0.5)
    R = 2.0 * jnp.max(mags ** (1.0 / kk))
    R = jnp.maximum(R, 1e-6)

    u = jnp.linspace(-1.0, 1.0, grid_size, dtype=dtype)
    x = R * u * u * u                              # dense near 0, covers ±R
    p = _poly_eval_real(monic, x)
    s = jnp.sign(p)
    s = jnp.where(s == 0, 1.0, s)
    bracket = (s[:-1] * s[1:]) < 0                 # (grid_size-1,)

    # select up to max_roots bracket positions (static shape)
    score = bracket.astype(dtype) * (2.0 - jnp.arange(grid_size - 1, dtype=dtype)
                                     / grid_size)
    _, idx = jax.lax.top_k(score, max_roots)
    valid = bracket[idx]
    lo = x[idx]
    hi = x[idx + 1]
    plo = _poly_eval_real(monic, lo)

    def bisect(_, state):
        lo, hi, plo = state
        mid = 0.5 * (lo + hi)
        pm = _poly_eval_real(monic, mid)
        same = (jnp.sign(pm) == jnp.sign(plo)) | (pm == 0)
        lo2 = jnp.where(same, mid, lo)
        plo2 = jnp.where(same, pm, plo)
        hi2 = jnp.where(same, hi, mid)
        return lo2, hi2, plo2

    lo, hi, _ = jax.lax.fori_loop(0, bisect_iters, bisect, (lo, hi, plo))
    root = 0.5 * (lo + hi)

    dmonic = monic[:-1] * jnp.arange(monic.shape[-1] - 1, 0, -1, dtype=dtype)

    def newton(_, r):
        pr = _poly_eval_real(monic, r)
        dr = _poly_eval_real(dmonic, r)
        dr = jnp.where(jnp.abs(dr) < 1e-30, 1e-30, dr)
        step = pr / dr
        step = jnp.clip(step, -R, R)
        return r - step

    root = jax.lax.fori_loop(0, newton_iters, newton, root)
    return root, valid
