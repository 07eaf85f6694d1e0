"""Semi-global matching dense stereo, in plain JAX.

Replaces the CUDA libSGM backend (SfM/src/dense/cudasgm/: 9x7 census ->
8-path aggregation (P1=10, P2=120) -> winner-takes-all with uniqueness
0.96 -> 3x3 median -> L/R consistency) and the CPU ELAS capability
(SURVEY.md §7):

* census transform: vectorized window comparisons packed into 2 uint32
  lanes; matching cost = Hamming distance via lax.population_count.
* path aggregation: the wavefront recurrence as `lax.scan` over image
  columns (horizontal paths) and rows (vertical and diagonal paths; a
  diagonal path shifts its carry by one column per row).
* WTA + uniqueness + subpixel + median + LR-check: dense elementwise ops.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def census_transform(img, win_h: int = 9, win_w: int = 7):
    """9x7 census over a (H, W) image -> (2, H, W) uint32 bit-packs.

    Matches dense/cudasgm/src/census_transform.cu semantics: bit = center >
    neighbour, border pixels compare against zero-padded context.

    The two words are a LEADING axis, so no downstream elementwise op
    carries a 2-wide minor dimension.
    """
    H, W = img.shape
    rh, rw = win_h // 2, win_w // 2
    pad = jnp.pad(img, ((rh, rh), (rw, rw)))
    bits = []
    for dy in range(win_h):
        for dx in range(win_w):
            if dy == rh and dx == rw:
                continue
            nb = jax.lax.dynamic_slice(pad, (dy, dx), (H, W))
            bits.append(img > nb)
    lo = jnp.zeros((H, W), jnp.uint32)
    hi = jnp.zeros((H, W), jnp.uint32)
    for k, b in enumerate(bits):
        word = b.astype(jnp.uint32) << jnp.uint32(k % 32)
        if k < 32:
            lo = lo | word
        else:
            hi = hi | word
    return jnp.stack([lo, hi], axis=0)


def matching_cost_volume(census_l, census_r, max_disp: int):
    """(H, W, D) float32 Hamming-distance cost volume, D = max_disp.

    cost(x, y, d) = popcount(census_l(x, y) ^ census_r(x - d, y)); out-of-
    range disparities get the max cost (64). census inputs are (2, H, W).
    Values are small exact integers, stored as f32.

    Built as an (H, D, W) volume by skew-by-reshape — shifted[y, d, x] =
    census_r[y, x - d] from one pad and two reshapes — then ONE transpose;
    on an H100 this measured 12-18x faster than stacking 128 per-disparity
    rolled slices (CHANGES.md).
    """
    _, H, W = census_l.shape
    D = max_disp
    WP = W + D

    def shifted_vol(w):                          # (H, W) -> (H, D, W)
        B = jnp.broadcast_to(w[:, None, :], (H, D, W))
        P = jnp.pad(B, ((0, 0), (0, 0), (0, D)))
        flat = P.reshape(H, D * WP)[:, :D * (WP - 1)]
        return flat.reshape(H, D, WP - 1)[:, :, :W]

    x_lo = jnp.bitwise_xor(shifted_vol(census_r[0]),
                           census_l[0][:, None, :])
    x_hi = jnp.bitwise_xor(shifted_vol(census_r[1]),
                           census_l[1][:, None, :])
    ham = (jax.lax.population_count(x_lo)
           + jax.lax.population_count(x_hi)).astype(jnp.float32)
    col = jax.lax.broadcasted_iota(jnp.int32, (H, D, W), 2)
    dd = jax.lax.broadcasted_iota(jnp.int32, (H, D, W), 1)
    vol = jnp.where(col >= dd, ham, 64.0)
    return jnp.transpose(vol, (0, 2, 1))


_BIG16 = jnp.int16(16000)      # uniform carry value == "path restarts here"


def _sgm_step(prev, c, p1, p2):
    """One SGM recurrence, disparity on the LAST axis.

    L = c + min(prev, prev[d-1]+P1, prev[d+1]+P1, m+P2) - m,  m = min_d prev.
    int16 throughout (costs <= 64, per-path values <= 64 + P2)."""
    big = _BIG16
    m = jnp.min(prev, axis=-1, keepdims=True)
    sp = jnp.concatenate([jnp.full_like(prev[..., :1], big),
                          prev[..., :-1]], axis=-1)
    sn = jnp.concatenate([prev[..., 1:],
                          jnp.full_like(prev[..., :1], big)], axis=-1)
    best = jnp.minimum(jnp.minimum(prev, m + jnp.int16(p2)),
                       jnp.minimum(sp + jnp.int16(p1), sn + jnp.int16(p1)))
    return c + best - m


def _shift_carry(prev, direction: int):
    """Shift a (W, D) carry by one column; shifted-in column is uniform
    (= restart).  A DIAGONAL path is a vertical scan whose carry moves one
    column per row: pred of (y, x) on the down-right path is (y-1, x-1)."""
    fill = jnp.full_like(prev[:1], _BIG16)
    if direction > 0:
        return jnp.concatenate([fill, prev[:-1]], axis=0)
    return jnp.concatenate([prev[1:], fill], axis=0)


def aggregate_paths(cost, p1: int = 10, p2: int = 120,
                    num_paths: int = 8):
    """Sum of 4 or 8 directional aggregations (ref path_aggregation.cu).

    cost: (H, W, D) Hamming volume.  Returns the (H, W, D) int16 sum.
    p1/p2 are integer penalties (ref libsgm uses ints); float inputs are
    truncated via int().

    Horizontal paths scan over columns; vertical AND diagonal paths scan
    over rows, the diagonals via a +-1 column shift of the carry per row
    (no shears/transposes).
    """
    cost = cost.astype(jnp.int16)

    p1i, p2i = int(p1), int(p2)

    # horizontal pair: scan over W, carry (H, D)
    cw = jnp.transpose(cost, (1, 0, 2))                       # (W, H, D)

    def hstep(prev, c):
        out = _sgm_step(prev, c, p1i, p2i)
        return out, out

    init_h = jnp.full_like(cw[0], _BIG16)
    _, hf = jax.lax.scan(hstep, init_h, cw)
    _, hb = jax.lax.scan(hstep, init_h, cw[::-1])
    total = (jnp.transpose(hf, (1, 0, 2))
             + jnp.transpose(hb[::-1], (1, 0, 2)))

    # vertical (+ diagonal) scans over H, carries (W, D)
    diag = num_paths >= 8

    def vstep(carries, c):
        cv, cd1, cd2 = carries
        nv = _sgm_step(cv, c, p1i, p2i)
        if diag:
            nd1 = _sgm_step(_shift_carry(cd1, +1), c, p1i, p2i)
            nd2 = _sgm_step(_shift_carry(cd2, -1), c, p1i, p2i)
            return (nv, nd1, nd2), nv + nd1 + nd2
        return (nv, cd1, cd2), nv

    init_v = (jnp.full_like(cost[0], _BIG16),) * 3
    _, vf = jax.lax.scan(vstep, init_v, cost)
    _, vb = jax.lax.scan(vstep, init_v, cost[::-1])
    return total + vf + vb[::-1]


def winner_takes_all(agg, uniqueness: float = 0.96, subpixel: bool = True):
    """argmin + uniqueness test + parabolic subpixel (ref winner_takes_all.cu).

    Returns (disp (H, W) float32, valid (H, W) bool).
    """
    D = agg.shape[-1]
    is_int = jnp.issubdtype(agg.dtype, jnp.integer)
    big = jnp.asarray(30000 if is_int else 1e9, agg.dtype)
    best = jnp.argmin(agg, axis=-1)
    c0 = jnp.min(agg, axis=-1).astype(jnp.float32)
    # second-best at least 2 disparities away (exclude immediate neighbours)
    d_idx = jnp.arange(D)[None, None, :]
    masked = jnp.where(jnp.abs(d_idx - best[..., None]) <= 1, big, agg)
    c1 = jnp.min(masked, axis=-1).astype(jnp.float32)
    valid = c0 <= uniqueness * c1
    if subpixel:
        bm = jnp.clip(best, 1, D - 2)
        # neighbour costs via masked reductions over the disparity axis
        sel = d_idx - bm[..., None]
        zero = jnp.zeros((), agg.dtype)
        cm = jnp.sum(jnp.where(sel == -1, agg, zero), axis=-1).astype(jnp.float32)
        cc = jnp.sum(jnp.where(sel == 0, agg, zero), axis=-1).astype(jnp.float32)
        cp = jnp.sum(jnp.where(sel == 1, agg, zero), axis=-1).astype(jnp.float32)
        denom = cm - 2 * cc + cp
        # parabola only valid when curvature is positive (a clipped best at
        # 0 / D-1 can make denom <= 0; dividing by a floored denom flipped
        # the offset sign there) — suppress the offset instead
        pos = denom > 1e-6
        off = jnp.where(pos, 0.5 * (cm - cp) / jnp.where(pos, denom, 1.0),
                        0.0)
        disp = bm.astype(jnp.float32) + jnp.clip(off, -1.0, 1.0)
        disp = jnp.where(best == 0, 0.0, disp)
    else:
        disp = best.astype(jnp.float32)
    return disp, valid


def median3(x):
    """3x3 median filter (ref median_filter.cu)."""
    H, W = x.shape
    pad = jnp.pad(x, 1, mode="edge")
    stack = jnp.stack([jax.lax.dynamic_slice(pad, (dy, dx), (H, W))
                       for dy in range(3) for dx in range(3)], axis=-1)
    return jnp.sort(stack, axis=-1)[..., 4]


def lr_consistency(disp_l, disp_r, max_diff: float = 1.0):
    """Left/right check (ref check_consistency.cu): valid where
    |dL(x) - dR(x - dL(x))| <= max_diff."""
    H, W = disp_l.shape
    x = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    xr = jnp.clip(x - jnp.round(disp_l).astype(jnp.int32), 0, W - 1)
    dr = jnp.take_along_axis(disp_r, xr, axis=1)
    return jnp.abs(disp_l - dr) <= max_diff


@partial(jax.jit, static_argnames=("max_disp", "num_paths", "subpixel",
                                   "p1", "p2"))
def stereo_sgm(left, right, max_disp: int = 128, p1: int = 10,
               p2: int = 120, uniqueness: float = 0.96,
               num_paths: int = 8, subpixel: bool = True):
    """Full SGM pipeline on a rectified pair (public API mirrors
    sgm::StereoSGM::execute, dense/cudasgm/include/libsgm.h).

    Args:
      left, right: (H, W) float images in [0, 1].
      p1, p2: integer SGM penalties (static jit args, like the reference's
        libsgm params; non-integer values are truncated).
    Returns:
      (disp (H, W) float32 with invalid = -1, valid (H, W) bool).
    """
    p1, p2 = int(p1), int(p2)
    D = max_disp
    H, W = left.shape

    cl = census_transform(left)
    cr = census_transform(right)
    cost_l = matching_cost_volume(cl, cr, max_disp)
    agg_l = aggregate_paths(cost_l, p1, p2, num_paths)
    disp_l, uniq_l = winner_takes_all(agg_l, uniqueness, subpixel)

    # right disparity from the same volume: cost_r(x, d) = agg_l(x+d, d)
    big_r = jnp.asarray(30000, agg_l.dtype)
    # skew-by-reshape: pad the W axis by D then the flat (D*(W+D)) axis
    # by D and re-split at width W+D+1 — shifts row d by exactly d
    # columns (diagonal-extraction trick) in one bulk pad/reshape
    aggT = jnp.transpose(agg_l, (0, 2, 1))                # (H, D, W)
    WD = W + D
    P = jnp.pad(aggT, ((0, 0), (0, 0), (0, D)), constant_values=big_r)
    flat = jnp.pad(P.reshape(H, D * WD), ((0, 0), (0, D)),
                   constant_values=big_r)
    cost_r = jnp.transpose(flat.reshape(H, D, WD + 1)[:, :, :W],
                           (0, 2, 1))                     # (H, W, D)
    disp_r, _ = winner_takes_all(cost_r, uniqueness, subpixel)

    disp_l = median3(disp_l)
    disp_r = median3(disp_r)
    valid = uniq_l & lr_consistency(disp_l, disp_r)
    return jnp.where(valid, disp_l, -1.0), valid


def disparity_to_depth(disp, focal: float, baseline: float,
                       scale: float = 20.0, clamp: float = 600.0):
    """depth = scale * f * B / d, clamped (ref dense_reconstruction.cc:243-263)."""
    d = jnp.maximum(disp, 1e-6)
    depth = scale * focal * baseline / d
    depth = jnp.where(disp > 0, jnp.minimum(depth, clamp), 0.0)
    return depth


def depth_to_points(depth, K_inv, R, t, stride: int = 1):
    """Depth map -> world points Xw = R^T (Xc - t)
    (ref Depth2Points, dense_reconstruction.cc:364-453)."""
    H, W = depth.shape
    ys = jax.lax.broadcasted_iota(jnp.float32, (H, W), 0)[::stride, ::stride]
    xs = jax.lax.broadcasted_iota(jnp.float32, (H, W), 1)[::stride, ::stride]
    z = depth[::stride, ::stride]
    ones = jnp.ones_like(xs)
    pix = jnp.stack([xs, ys, ones], axis=-1)
    rays = jnp.einsum("ij,hwj->hwi", K_inv, pix)
    Xc = rays * z[..., None]
    Xw = jnp.einsum("ji,hwj->hwi", R, Xc - t[None, None, :])
    mask = z > 0
    return Xw, mask
