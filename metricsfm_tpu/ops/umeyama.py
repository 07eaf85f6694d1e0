"""Weighted rigid / similarity alignment (Umeyama).

Re-design of the reference's transformation utilities
(SfM/src/utils/transformation.cpp:49-216): weighted Umeyama for
RigidTransformation (R, t) and SimilarityTransformation (s, R, t), the core
of GPS georeferencing (slam_gps.cc:1596-1674) and of the 3-point absolute
orientation inside P3P.

Solves argmin sum_i w_i |dst_i - (s R src_i + t)|^2.
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def similarity_align(src, dst, weights=None, with_scale=True):
    """Weighted Umeyama alignment.

    Args:
      src, dst: (..., N, 3) paired point sets.
      weights: optional (..., N) nonnegative weights (0 masks a pair).
      with_scale: solve for scale s (similarity) or fix s=1 (rigid).

    Returns:
      (s, R, t): scalars (...,), rotations (..., 3, 3), translations (..., 3)
      with dst ~= s * R @ src + t.
    """
    if weights is None:
        weights = jnp.ones(src.shape[:-1], dtype=src.dtype)
    w = weights / jnp.maximum(jnp.sum(weights, axis=-1, keepdims=True), _EPS)
    mu_s = jnp.sum(src * w[..., None], axis=-2)
    mu_d = jnp.sum(dst * w[..., None], axis=-2)
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    # weighted covariance dst <- src
    Sigma = jnp.einsum("...n,...ni,...nj->...ij", w, cd, cs)
    U, D, Vt = jnp.linalg.svd(Sigma)
    det = jnp.linalg.det(U) * jnp.linalg.det(Vt)
    S = jnp.stack([jnp.ones_like(det), jnp.ones_like(det), jnp.sign(det)], axis=-1)
    R = (U * S[..., None, :]) @ Vt
    if with_scale:
        var_s = jnp.sum(w * jnp.sum(cs * cs, axis=-1), axis=-1)
        s = jnp.sum(D * S, axis=-1) / jnp.maximum(var_s, _EPS)
    else:
        s = jnp.ones_like(det)
    t = mu_d - s[..., None] * jnp.einsum("...ij,...j->...i", R, mu_s)
    return s, R, t


def rigid_align(src, dst, weights=None):
    """Weighted rigid (s=1) alignment — reference RigidTransformation."""
    return similarity_align(src, dst, weights, with_scale=False)


def align_residuals(src, dst, s, R, t):
    """Per-point residual norms after applying the transform."""
    pred = s[..., None, None] * jnp.einsum("...ij,...nj->...ni", R, src) + t[..., None, :]
    return jnp.linalg.norm(dst - pred, axis=-1)
