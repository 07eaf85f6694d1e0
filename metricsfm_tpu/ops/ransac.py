"""Batched two-view RANSAC harness.

Batched replacement for the reference's sequential RANSAC loops
(fundamental_matrix_eight_point.cc:30-97 — 200 hypotheses, min total error;
 essential_matrix_five_point.cc:30-93 — 100 hypotheses;
 utils/geo_verification.cc:30-79 — cv::findFundamentalMat @3px, >=30 inliers).

All hypotheses are generated at once (vmap over sampled index sets), scored
against every correspondence in one batched einsum, and the winner refit on
its inlier set with masked weights — static shapes throughout.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import epipolar


def _sample_indices(key, n, mask, num_hypotheses, sample_size):
    """(H, S) index samples drawn from valid entries (without replacement).

    Gumbel top-k: one (H, N) gumbel draw + top_k is an exact uniform
    without-replacement sample over the masked support — the vmapped
    jax.random.choice(p=softmax) this replaces ran a per-hypothesis
    weighted-reservoir chain."""
    logits = jnp.where(mask, 0.0, -1e9)
    g = jax.random.gumbel(key, (num_hypotheses, n), dtype=jnp.float32)
    _, idx = jax.lax.top_k(g + logits[None, :], sample_size)
    return idx


@partial(jax.jit, static_argnames=("num_hypotheses", "refit_rounds"))
def fundamental_ransac(pts1, pts2, key, mask=None, num_hypotheses: int = 256,
                       th_px: float = 3.0, min_inliers: int = 30,
                       refit_rounds: int = 2):
    """Batched 8-point F-RANSAC with epipolar-distance scoring.

    Args:
      pts1, pts2: (N, 2) centered-pixel correspondences (N static, masked).
      mask: (N,) valid rows.  th_px/min_inliers mirror geo_verification.cc.
    Returns dict: F, inlier_mask, n_inliers, ok.
    """
    N = pts1.shape[0]
    m = jnp.ones((N,), bool) if mask is None else mask.astype(bool)
    idx = _sample_indices(key, N, m, num_hypotheses, 8)

    Fs = jax.vmap(lambda si: epipolar.fundamental_8pt(
        pts1[si], pts2[si], exact=False))(idx)
    d = epipolar.epipolar_distance(Fs, pts1, pts2)          # (H, N)
    inl = (d < th_px) & m[None, :]
    n_inl = jnp.sum(inl, axis=-1)
    best = jnp.argmax(n_inl)

    def refit(inlier_mask, _):
        w = inlier_mask.astype(pts1.dtype)
        F = epipolar.fundamental_8pt(pts1, pts2, weights=w)
        dd = epipolar.epipolar_distance(F, pts1, pts2)
        new = (dd < th_px) & m
        ok = jnp.sum(new) >= jnp.maximum(jnp.sum(inlier_mask) // 2, 8)
        return jnp.where(ok, new, inlier_mask), F

    fin_mask, F_hist = jax.lax.scan(refit, inl[best], None, length=refit_rounds)
    F = F_hist[-1]
    n = jnp.sum(fin_mask)
    return {"F": F, "inlier_mask": fin_mask, "n_inliers": n,
            "ok": n >= min_inliers}


@partial(jax.jit, static_argnames=("num_hypotheses", "refit_rounds"))
def essential_ransac(norm1, norm2, key, mask=None, num_hypotheses: int = 256,
                     th_sampson: float = 1e-5, min_inliers: int = 30,
                     refit_rounds: int = 2):
    """Batched E-RANSAC on K-normalized correspondences (Sampson scoring).

    Replaces the reference 5-point RANSAC (essential_matrix_five_point.cc):
    non-minimal 8-point samples with a larger hypothesis budget — the
    batched tradeoff (SURVEY.md §7).
    Returns dict: E, inlier_mask, n_inliers, ok.
    """
    N = norm1.shape[0]
    m = jnp.ones((N,), bool) if mask is None else mask.astype(bool)
    idx = _sample_indices(key, N, m, num_hypotheses, 8)

    Es = jax.vmap(lambda si: epipolar.essential_8pt(
        norm1[si], norm2[si], exact=False))(idx)
    d = epipolar.sampson_distance(Es, norm1, norm2)
    inl = (d < th_sampson) & m[None, :]
    n_inl = jnp.sum(inl, axis=-1)
    best = jnp.argmax(n_inl)

    def refit(inlier_mask, _):
        w = inlier_mask.astype(norm1.dtype)
        E = epipolar.essential_8pt(norm1, norm2, weights=w)
        dd = epipolar.sampson_distance(E, norm1, norm2)
        new = (dd < th_sampson) & m
        ok = jnp.sum(new) >= jnp.maximum(jnp.sum(inlier_mask) // 2, 8)
        return jnp.where(ok, new, inlier_mask), E

    fin_mask, E_hist = jax.lax.scan(refit, inl[best], None, length=refit_rounds)
    E = E_hist[-1]
    n = jnp.sum(fin_mask)
    return {"E": E, "inlier_mask": fin_mask, "n_inliers": n,
            "ok": n >= min_inliers}


def fundamental_ransac_pairs(pts1, pts2, masks, keys, **kw):
    """vmap fundamental_ransac over a batch of pairs: (P, N, 2) x2, (P, N), (P,) keys."""
    fn = lambda a, b, m, k: fundamental_ransac(a, b, k, mask=m, **kw)
    return jax.vmap(fn)(pts1, pts2, masks, keys)
