"""Point undistortion via polynomial root finding.

Re-design of SfM/src/utils/calibration.{h,cc}: invert the radial model
r_d = r_u (1 + k1 r_u^2 + k2 r_u^4) exactly by solving the quintic in r_u
with the Durand-Kerner finder (ops/polynomial.py) — the reference's
companion-matrix approach (calibration.cc:17-19) is a non-symmetric eigen
solve JAX lacks on accelerators.  ops/projection.undistort_radial is the fast
fixed-point alternative used in the hot path.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops import polynomial


def undistort_radius(r_d, k1, k2, iters: int = 80):
    """Solve k2 r^5 + k1 r^3 + r - r_d = 0 for the real root nearest r_d.

    r_d, k1, k2: scalars or broadcastable arrays (vmapped internally).
    """
    def one(rd, a1, a2):
        coeffs = jnp.stack([a2, jnp.zeros_like(a2), a1,
                            jnp.zeros_like(a1), jnp.ones_like(a1), -rd])
        roots, is_real = polynomial.real_roots(coeffs, iters)
        # pick positive real root closest to rd
        score = jnp.where(is_real & (roots > 0), jnp.abs(roots - rd), jnp.inf)
        return roots[jnp.argmin(score)]

    rd = jnp.atleast_1d(jnp.asarray(r_d, jnp.float32))
    a1 = jnp.broadcast_to(jnp.asarray(k1, jnp.float32), rd.shape)
    a2 = jnp.broadcast_to(jnp.asarray(k2, jnp.float32), rd.shape)
    out = jax.vmap(one)(rd, a1, a2)
    return out.reshape(jnp.shape(r_d)) if jnp.ndim(r_d) else out[0]


def undistort_points_exact(xy_d, k1, k2):
    """Undistort centered normalized points via the exact radial inverse."""
    r_d = jnp.linalg.norm(xy_d, axis=-1)
    r_u = undistort_radius(r_d, k1, k2)
    scale = jnp.where(r_d > 1e-9, r_u / jnp.maximum(r_d, 1e-9), 1.0)
    return xy_d * scale[..., None]
