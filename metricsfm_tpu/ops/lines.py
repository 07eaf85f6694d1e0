"""Line-segment detection utilities (LSD-style) + Hough transform.

Re-design of the reference's line utilities (SfM/src/utils/lsd.{h,cc},
houghlines.{h,cpp}, local_orientation.{h,cc} — linked-in capability for
line-feature work, unused in the default pipelines).  Dense XLA
formulation: gradient orientation field, level-line support masks, and an
accumulator-based Hough transform via one-hot matmul binning.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def gradient_field(img):
    """Image gradients + magnitude + level-line angle (LSD convention:
    angle of the level line = gradient angle + pi/2)."""
    gx = jnp.zeros_like(img).at[:, 1:-1].set(0.5 * (img[:, 2:] - img[:, :-2]))
    gy = jnp.zeros_like(img).at[1:-1, :].set(0.5 * (img[2:, :] - img[:-2, :]))
    mag = jnp.sqrt(gx * gx + gy * gy)
    angle = jnp.arctan2(gy, gx)
    return gx, gy, mag, angle


@partial(jax.jit, static_argnames=("n_theta", "n_rho"))
def hough_lines(edge_mask, weights=None, n_theta: int = 180,
                n_rho: int = 256):
    """Weighted Hough accumulator over (theta, rho).

    Accumulation is a one-hot matmul (edge pixels x rho bins per theta),
    the dense equivalent of scatter voting (houghlines.cpp).
    Returns (acc (n_theta, n_rho), thetas, rhos).
    """
    H, W = edge_mask.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    w = edge_mask.astype(jnp.float32)
    if weights is not None:
        w = w * weights
    diag = jnp.sqrt(float(H * H + W * W))
    thetas = jnp.linspace(0.0, jnp.pi, n_theta, endpoint=False)
    rhos = jnp.linspace(-diag, diag, n_rho)

    x = xs.reshape(-1)
    y = ys.reshape(-1)
    wf = w.reshape(-1)

    def per_theta(th):
        rho = x * jnp.cos(th) + y * jnp.sin(th)
        idx = (rho + diag) / (2 * diag) * (n_rho - 1)
        i0 = jnp.clip(jnp.floor(idx).astype(jnp.int32), 0, n_rho - 1)
        frac = idx - i0
        onehot = jax.nn.one_hot(i0, n_rho, dtype=jnp.float32) * (1 - frac)[:, None] \
            + jax.nn.one_hot(jnp.clip(i0 + 1, 0, n_rho - 1), n_rho,
                             dtype=jnp.float32) * frac[:, None]
        return wf @ onehot

    acc = jax.vmap(per_theta)(thetas)
    return acc, thetas, rhos


@partial(jax.jit, static_argnames=("max_lines", "n_theta", "n_rho"))
def detect_lines(img, mag_thresh: float = 0.05, max_lines: int = 32,
                 n_theta: int = 180, n_rho: int = 256):
    """Dominant lines of an image: gradient-magnitude edges -> Hough peaks.

    Returns dict: theta (L,), rho (L,), score (L,) sorted by vote weight.
    """
    _, _, mag, _ = gradient_field(img)
    edges = mag > mag_thresh
    acc, thetas, rhos = hough_lines(edges, weights=mag, n_theta=n_theta,
                                    n_rho=n_rho)
    flat = acc.reshape(-1)
    top, idx = jax.lax.top_k(flat, max_lines)
    ti = idx // acc.shape[1]
    ri = idx % acc.shape[1]
    return {"theta": thetas[ti], "rho": rhos[ri], "score": top}


@partial(jax.jit, static_argnames=("max_segments", "n_theta", "n_rho"))
def detect_segments(img, mag_thresh: float = 0.05, angle_tol: float = 0.3927,
                    band_px: float = 2.0, density_th: float = 0.3,
                    max_segments: int = 32, n_theta: int = 180,
                    n_rho: int = 256):
    """LSD-style line-SEGMENT detection, densely (ref utils/lsd.cc
    LineSegmentDetection: region-grow aligned level-line pixels into
    rectangles with a density gate; here the same ingredients — aligned
    support + density — bound Hough peaks to finite extents).

    For each Hough peak: pixels within `band_px` of the line whose
    level-line angle agrees with the line direction within `angle_tol`
    form the support; the segment spans the 2nd..98th percentile of their
    projections along the line (masked-percentile = robust endpoints, the
    dense analogue of LSD's rectangle bounds), gated by support density.

    Returns dict: p0 (L, 2), p1 (L, 2) endpoint xy, score (L,),
    ok (L,) density gate.
    """
    H, W = img.shape
    _, _, mag, angle = gradient_field(img)
    edges = mag > mag_thresh
    acc, thetas, rhos = hough_lines(edges, weights=mag, n_theta=n_theta,
                                    n_rho=n_rho)
    flat = acc.reshape(-1)
    top, idx = jax.lax.top_k(flat, max_segments)
    th = thetas[idx // acc.shape[1]]
    rho = rhos[idx % acc.shape[1]]

    ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)
    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)
    level = angle + jnp.pi / 2.0

    def one(t, r, score):
        n = jnp.stack([jnp.cos(t), jnp.sin(t)])        # line normal
        d = xs * n[0] + ys * n[1] - r                  # signed distance
        # level-line angle must align with the line DIRECTION (normal+90)
        ddir = level - (t + jnp.pi / 2.0)
        aligned = jnp.abs(jnp.sin(ddir)) < jnp.sin(angle_tol)
        support = (jnp.abs(d) < band_px) & aligned & edges
        proj = -xs * n[1] + ys * n[0]                  # along-line coord
        w = support.astype(jnp.float32)
        cnt = jnp.sum(w)
        lo = jnp.min(jnp.where(support, proj, jnp.inf))
        hi = jnp.max(jnp.where(support, proj, -jnp.inf))
        length = jnp.maximum(hi - lo, 1e-6)
        dirv = jnp.stack([-n[1], n[0]])
        base = r * n
        p0 = base + lo * dirv
        p1 = base + hi * dirv
        # density gate: aligned support per unit length within the band
        ok = (cnt / (length * 2.0 * band_px)) > density_th
        ok = ok & (cnt > 8) & jnp.isfinite(lo) & jnp.isfinite(hi)
        return p0, p1, score, ok

    p0, p1, score, ok = jax.vmap(one)(th, rho, top)
    return {"p0": p0, "p1": p1, "score": score, "ok": ok}


@partial(jax.jit, static_argnames=("win_half",))
def local_orientation(img, pts, win_half: int = 20, sigma_i: float = 0.1):
    """Dominant local gradient direction per point (ref
    utils/local_orientation.cc LocalOrientation::CalOrientation: region-
    grow intensity-similar pixels around pt in a 20-px half-window, then
    average their gradient).

    Dense analogue: a (2w, 2w) window is sliced per point; the hard
    region-growing is relaxed to a soft weight
    exp(-(I - I_seed)^2 / (2 sigma_i^2)) and (dx, dy) is the weighted
    gradient mean, sign-normalized like an average over the grown region.

    Args: img (H, W) float in [0, 1]; pts (N, 2) float xy.
    Returns (N, 2) unit (dx, dy); zero rows where the window is flat.
    """
    gx, gy, mag, _ = gradient_field(img)
    H, W = img.shape
    w = 2 * win_half

    def one(pt):
        x0 = jnp.clip(pt[0].astype(jnp.int32) - win_half, 0, W - w)
        y0 = jnp.clip(pt[1].astype(jnp.int32) - win_half, 0, H - w)
        win_i = jax.lax.dynamic_slice(img, (y0, x0), (w, w))
        win_x = jax.lax.dynamic_slice(gx, (y0, x0), (w, w))
        win_y = jax.lax.dynamic_slice(gy, (y0, x0), (w, w))
        seed = win_i[win_half, win_half]
        wgt = jnp.exp(-((win_i - seed) ** 2) / (2.0 * sigma_i ** 2))
        dx = jnp.sum(wgt * win_x)
        dy = jnp.sum(wgt * win_y)
        nrm = jnp.sqrt(dx * dx + dy * dy)
        scale = jnp.where(nrm > 1e-8, 1.0 / jnp.maximum(nrm, 1e-8), 0.0)
        return jnp.stack([dx, dy]) * scale

    return jax.vmap(one)(pts.astype(jnp.float32))


def line_support_regions(img, angle_tol: float = 0.3927,
                         mag_thresh: float = 0.05):
    """LSD-style aligned-pixel mask per quantized level-line orientation.

    Returns (n_orient, H, W) boolean masks of pixels whose level-line angle
    agrees with the bin center within angle_tol (22.5 deg default) — the
    region-growing seed structure of LSD expressed densely.
    """
    _, _, mag, angle = gradient_field(img)
    level = angle + jnp.pi / 2.0
    n_orient = 8
    centers = jnp.linspace(-jnp.pi, jnp.pi, n_orient, endpoint=False)

    def per_orient(c):
        d = jnp.angle(jnp.exp(1j * (level - c)))
        return (jnp.abs(d) < angle_tol) & (mag > mag_thresh)

    return jax.vmap(per_orient)(centers)
