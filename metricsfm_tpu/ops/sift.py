"""SIFT feature detection + description, dense-masked for batched devices.

Re-design of the reference extractors
(SfM/src/feature/feature_extractor_vl_sift.cpp — vlfeat CPU SIFT, 4 octaves
x 5 levels, edge_thresh 10, peak_thresh 0;
 feature_extractor_cuda_sift.cpp — CudaSift GPU, 60k keypoint cap).

The scattered, data-dependent parts of SIFT (extrema lists, per-keypoint
loops) become dense masked computation (SURVEY.md §7 "hard parts" #3):

* Gaussian pyramid: separable depthwise convs (XLA fuses these well).
* DoG extrema: 3x3x3 neighbourhood max/min via reduce_window, computed
  everywhere; candidate strength is a dense response map; selection is a
  fixed per-octave budget via lax.approx_max_k (a full top_k sorts the
  whole response volume).
* 3D quadratic subpixel/scale refinement (vlfeat vl_sift semantics,
  feature_extractor_vl_sift.cpp:75-216): one (K, 27) gather of the DoG
  neighbourhoods + a closed-form 3x3 solve, offsets clamped to +-1.
* Orientation + descriptor are PATCH-based: one vmapped dynamic_slice
  per keypoint extracts an integer-aligned (P, P) gradient patch at the
  keypoint's own gaussian level (per-level gradient stacks); all P^2
  pixels contribute with trilinear soft-binning — vlfeat's every-pixel
  accumulation, not a 16x16 subsample — and the 4x4x8 histogram is a
  batched (4, P^2) @ (P^2, 8) matmul per spatial row, replacing a
  per-keypoint bilinear-gather path.
* Multiple orientations per keypoint (vlfeat 80%-peak rule): up to 2
  slots per detection, the second masked unless its histogram peak is
  >= 0.8x the primary.

Output coordinates are *centered* at the principal point (w/2, h/2),
matching the reference convention (database.cc:522-527).
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp


class SiftConfig(NamedTuple):
    n_octaves: int = 4
    n_scales: int = 3           # intervals per octave (ref: 5 DoG levels)
    sigma0: float = 1.6
    peak_thresh: float = 0.5 / 255.0  # DoG response gate (vlfeat peak 0 => tiny)
    edge_thresh: float = 10.0   # Hessian edge ratio (ref edge_thresh=10)
    max_keypoints: int = 2048   # fixed budget (ref cap 60000)
    desc_width: int = 4         # 4x4 spatial bins
    desc_bins: int = 8          # 8 orientation bins
    desc_mag: float = 3.0       # spatial bin size in units of sigma
    clip: float = 0.2           # descriptor clipping before renorm
    patch: int = 48             # gradient patch side (desc + orientation)
    n_orientations: int = 2     # max orientations per keypoint
    ori_peak_frac: float = 0.8  # 80%-peak rule (vlfeat)


def _gauss_kernel1d(sigma, radius):
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def _blur(img, sigma):
    """Separable Gaussian blur of (H, W) image with static radius."""
    radius = max(1, int(math.ceil(3.0 * float(sigma))))
    k = _gauss_kernel1d(sigma, radius)
    pad = [(radius, radius)]
    # rows
    imgp = jnp.pad(img, ((radius, radius), (0, 0)), mode="edge")
    out = jax.vmap(lambda col: jnp.convolve(col, k, mode="valid"),
                   in_axes=1, out_axes=1)(imgp)
    imgp = jnp.pad(out, ((0, 0), (radius, radius)), mode="edge")
    out = jax.vmap(lambda row: jnp.convolve(row, k, mode="valid"))(imgp)
    return out


def gaussian_pyramid(img, cfg: SiftConfig):
    """List (per octave) of (S+3, H_o, W_o) Gaussian stacks."""
    S = cfg.n_scales
    k = 2.0 ** (1.0 / S)
    base = _blur(img, cfg.sigma0)
    octaves = []
    cur = base
    for o in range(cfg.n_octaves):
        levels = [cur]
        sigma_prev = cfg.sigma0
        for s in range(1, S + 3):
            sigma_total = cfg.sigma0 * (k ** s)
            sigma_extra = math.sqrt(max(sigma_total ** 2 - sigma_prev ** 2, 0.01))
            levels.append(_blur(levels[-1], sigma_extra))
            sigma_prev = sigma_total
        stack = jnp.stack(levels)               # (S+3, H, W)
        octaves.append(stack)
        # next octave seeds from level S (sigma doubled), downsample 2x
        cur = stack[S][::2, ::2]
    return octaves


def _dog_extrema_response(dog):
    """Dense extrema response for a (L, H, W) DoG stack.

    Returns (resp, is_extremum): resp = |dog| on interior levels; extremum
    requires strict 26-neighbourhood max or min.
    """
    # 3x3x3 max/min pools
    mx = jax.lax.reduce_window(dog, -jnp.inf, jax.lax.max, (3, 3, 3),
                               (1, 1, 1), "SAME")
    mn = jax.lax.reduce_window(dog, jnp.inf, jax.lax.min, (3, 3, 3),
                               (1, 1, 1), "SAME")
    is_max = dog >= mx - 1e-12
    is_min = dog <= mn + 1e-12
    is_ext = is_max | is_min
    # only interior levels can be extrema in scale
    L = dog.shape[0]
    lvl = jnp.arange(L)[:, None, None]
    interior = (lvl >= 1) & (lvl <= L - 2)
    return jnp.abs(dog), is_ext & interior


def _edge_mask(dog, edge_thresh):
    """Hessian edge-response rejection (trace^2/det < (r+1)^2/r)."""
    dxx = dog[:, 1:-1, 2:] + dog[:, 1:-1, :-2] - 2 * dog[:, 1:-1, 1:-1]
    dyy = dog[:, 2:, 1:-1] + dog[:, :-2, 1:-1] - 2 * dog[:, 1:-1, 1:-1]
    dxy = 0.25 * (dog[:, 2:, 2:] - dog[:, 2:, :-2] - dog[:, :-2, 2:] + dog[:, :-2, :-2])
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_thresh
    ok = (det > 0) & (tr * tr * r < (r + 1.0) ** 2 * det)
    return jnp.pad(ok, ((0, 0), (1, 1), (1, 1)))


def _refine_extrema(dog, lvl, y, x):
    """3D quadratic subpixel/scale refinement at (lvl, y, x) (vectorized).

    Gathers the 27-neighbourhood, solves H d = -g in closed form (adjugate),
    clamps the offset to [-1, 1] per axis (vlfeat iterates instead; one
    clamped step is the CudaSift-style dense equivalent).  Returns
    (dx, dy, ds, refined response).
    """
    L, H, W = dog.shape
    flat = dog.reshape(-1)
    base = (lvl * H + y) * W + x                           # (K,)
    offs = jnp.array([(dl * H + dy) * W + dx
                      for dl in (-1, 0, 1)
                      for dy in (-1, 0, 1)
                      for dx in (-1, 0, 1)], jnp.int32)     # (27,)
    n = jnp.take(flat, base[:, None] + offs[None, :],
                 mode="clip").reshape(-1, 3, 3, 3)          # (K, l, y, x)

    c = n[:, 1, 1, 1]
    gs = 0.5 * (n[:, 2, 1, 1] - n[:, 0, 1, 1])
    gy = 0.5 * (n[:, 1, 2, 1] - n[:, 1, 0, 1])
    gx = 0.5 * (n[:, 1, 1, 2] - n[:, 1, 1, 0])
    Hss = n[:, 2, 1, 1] + n[:, 0, 1, 1] - 2 * c
    Hyy = n[:, 1, 2, 1] + n[:, 1, 0, 1] - 2 * c
    Hxx = n[:, 1, 1, 2] + n[:, 1, 1, 0] - 2 * c
    Hsy = 0.25 * (n[:, 2, 2, 1] - n[:, 2, 0, 1] - n[:, 0, 2, 1] + n[:, 0, 0, 1])
    Hsx = 0.25 * (n[:, 2, 1, 2] - n[:, 2, 1, 0] - n[:, 0, 1, 2] + n[:, 0, 1, 0])
    Hyx = 0.25 * (n[:, 1, 2, 2] - n[:, 1, 2, 0] - n[:, 1, 0, 2] + n[:, 1, 0, 0])

    # solve [[Hxx,Hyx,Hsx],[Hyx,Hyy,Hsy],[Hsx,Hsy,Hss]] d = -(gx,gy,gs)
    det = (Hxx * (Hyy * Hss - Hsy * Hsy)
           - Hyx * (Hyx * Hss - Hsy * Hsx)
           + Hsx * (Hyx * Hsy - Hyy * Hsx))
    a00 = Hyy * Hss - Hsy * Hsy
    a01 = Hsx * Hsy - Hyx * Hss
    a02 = Hyx * Hsy - Hsx * Hyy
    a11 = Hxx * Hss - Hsx * Hsx
    a12 = Hsx * Hyx - Hxx * Hsy
    a22 = Hxx * Hyy - Hyx * Hyx
    safe = jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    dx = -(a00 * gx + a01 * gy + a02 * gs) / safe
    dy = -(a01 * gx + a11 * gy + a12 * gs) / safe
    ds = -(a02 * gx + a12 * gy + a22 * gs) / safe
    ok = jnp.abs(det) > 1e-12
    dx = jnp.where(ok, jnp.clip(dx, -1.0, 1.0), 0.0)
    dy = jnp.where(ok, jnp.clip(dy, -1.0, 1.0), 0.0)
    ds = jnp.where(ok, jnp.clip(ds, -1.0, 1.0), 0.0)
    resp = c + 0.5 * (gx * dx + gy * dy + gs * ds)
    return dx, dy, ds, resp


def detect_octave(stack, octave, cfg: SiftConfig, budget):
    """Top-`budget` keypoints from one octave's Gaussian stack.

    Returns dict with per-keypoint arrays (length budget): subpixel-refined
    full-res coords `xy`, integer octave coords (x, y), DoG level `lvl`,
    refined `sigma`, selection score `score`, refined `resp`, `mask`.
    """
    dog = stack[1:] - stack[:-1]               # (S+2, H, W)
    resp, is_ext = _dog_extrema_response(dog)
    edge_ok = _edge_mask(dog, cfg.edge_thresh)
    H, W = dog.shape[1], dog.shape[2]
    border = 8
    yy = jnp.arange(H)[None, :, None]
    xx = jnp.arange(W)[None, None, :]
    inb = (yy >= border) & (yy < H - border) & (xx >= border) & (xx < W - border)
    valid = is_ext & edge_ok & inb & (resp > cfg.peak_thresh)
    score = jnp.where(valid, resp, -1.0)
    flat = score.reshape(-1)
    # budgeted selection: approx_max_k is a partial reduction
    # (top_k lowers to a full sort of the L*H*W volume)
    top, idx = jax.lax.approx_max_k(flat, budget, recall_target=0.95)
    lvl = idx // (H * W)
    rem = idx % (H * W)
    y = rem // W
    x = rem % W
    mask = top > 0
    ddx, ddy, dds, resp_ref = _refine_extrema(dog, lvl, y, x)
    scale_mult = 2.0 ** octave
    xy = (jnp.stack([x, y], axis=-1).astype(jnp.float32)
          + jnp.stack([ddx, ddy], axis=-1)) * scale_mult
    # sigma at the refined scale (DoG level l sits between gauss l and l+1)
    k = 2.0 ** (1.0 / cfg.n_scales)
    sigma = cfg.sigma0 * (k ** (lvl.astype(jnp.float32) + dds)) * scale_mult
    return {"xy": xy, "x": x, "y": y, "dx": ddx, "dy": ddy, "lvl": lvl,
            "sigma": sigma, "score": top, "resp": resp_ref, "mask": mask}


def _bilinear(img, xy):
    """Bilinear sample (H, W) image at (..., 2) float (x, y) coords."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return (v00 * (1 - fx) * (1 - fy) + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy + v11 * fx * fy)


def _grad_stack(stack):
    """Central-difference gradients of a (L, H, W) Gaussian stack."""
    gx = jnp.zeros_like(stack)
    gx = gx.at[:, :, 1:-1].set(0.5 * (stack[:, :, 2:] - stack[:, :, :-2]))
    gy = jnp.zeros_like(stack)
    gy = gy.at[:, 1:-1, :].set(0.5 * (stack[:, 2:, :] - stack[:, :-2, :]))
    return gx, gy


def _extract_patches(field3, lvl, y, x, P: int):
    """Integer-aligned (P, P) patches of a (L, H, W) field at each
    keypoint's own level — one vmapped dynamic_slice per keypoint.

    Returns (patches (K, P, P), oy (K,), ox (K,)); origins are clamped to
    the field so patches near borders shift but stay aligned (per-sample
    offsets are computed from the true origin downstream)."""
    L, H, W = field3.shape
    oy = jnp.clip(y - P // 2, 0, max(H - P, 0))
    ox = jnp.clip(x - P // 2, 0, max(W - P, 0))

    def one(l, oy_, ox_):
        return jax.lax.dynamic_slice(field3, (l, oy_, ox_), (1, P, P))[0]

    return jax.vmap(one)(lvl, oy, ox), oy, ox


def _patch_offsets(oy, ox, yf, xf, P: int):
    """Per-pixel offsets (dy, dx) of patch pixels from the subpixel
    keypoint centre: (K, P, P) each."""
    rows = jnp.arange(P, dtype=jnp.float32)
    dy = oy[:, None].astype(jnp.float32) + rows[None, :] - yf[:, None]
    dx = ox[:, None].astype(jnp.float32) + rows[None, :] - xf[:, None]
    return dy[:, :, None] * jnp.ones((1, 1, P)), dx[:, None, :] * jnp.ones((1, P, 1))


def orientation_peaks(mag, ang, dy, dx, sigma_oct, cfg: SiftConfig,
                      n_bins: int = 36):
    """Top-2 orientation peaks per keypoint from gradient patches.

    mag/ang/dy/dx: (K, P, P).  Gaussian window 1.5*sigma, radius cut
    4.5*sigma, circular tent binning, box-smooth x2, parabolic peak refine,
    80%-peak second orientation (vlfeat semantics).
    Returns (theta1, theta2, has2): (K,) each.
    """
    K, P, _ = mag.shape
    sig_w = 1.5 * sigma_oct[:, None, None]
    r2 = dy * dy + dx * dx
    w = jnp.exp(-r2 / (2.0 * sig_w ** 2)) * (r2 <= (3.0 * sig_w) ** 2)
    contrib = (mag * w).reshape(K, P * P)
    binf = ((ang + jnp.pi) / (2 * jnp.pi) * n_bins).reshape(K, P * P)
    bins = jnp.arange(n_bins, dtype=jnp.float32)
    # circular tent weights (K, P^2, nb): 1 - min(|b - binf|, nb - |.|)
    d = jnp.abs(binf[:, :, None] - bins[None, None, :])
    tri = jnp.maximum(0.0, 1.0 - jnp.minimum(d, n_bins - d))
    hist = jnp.einsum("kp,kpb->kb", contrib, tri)
    for _ in range(2):
        hist = (jnp.roll(hist, 1, axis=1) + hist
                + jnp.roll(hist, -1, axis=1)) / 3.0

    def refine(peak_idx):
        l = jnp.take_along_axis(hist, ((peak_idx - 1) % n_bins)[:, None], 1)[:, 0]
        c = jnp.take_along_axis(hist, peak_idx[:, None], 1)[:, 0]
        r = jnp.take_along_axis(hist, ((peak_idx + 1) % n_bins)[:, None], 1)[:, 0]
        den = l - 2 * c + r
        off = jnp.where(jnp.abs(den) > 1e-9, 0.5 * (l - r) / den, 0.0)
        theta = ((peak_idx.astype(jnp.float32) + off + 0.5) / n_bins
                 * 2 * jnp.pi - jnp.pi)
        return theta, c

    p1 = jnp.argmax(hist, axis=1)
    theta1, h1 = refine(p1)
    # second peak: a circular local max, not adjacent to p1
    left = jnp.roll(hist, 1, axis=1)
    right = jnp.roll(hist, -1, axis=1)
    is_max = (hist > left) & (hist >= right)
    idxs = jnp.arange(n_bins)[None, :]
    dist = jnp.abs(idxs - p1[:, None])
    dist = jnp.minimum(dist, n_bins - dist)
    cand = jnp.where(is_max & (dist > 1), hist, -1.0)
    p2 = jnp.argmax(cand, axis=1)
    theta2, h2 = refine(p2)
    has2 = (jnp.max(cand, axis=1) >= cfg.ori_peak_frac * h1) & (h1 > 0)
    return theta1, theta2, has2


def descriptors_from_patches(mag, ang, dy, dx, sigma_oct, theta,
                             cfg: SiftConfig):
    """128-D descriptors from gradient patches for one orientation slot.

    Every patch pixel contributes trilinearly (vlfeat's every-pixel
    accumulation); the (y-bin, x-bin, o-bin) histogram is built as 4
    batched (nb, P^2) @ (P^2, no) matmuls.  Returns (K, 128) L2-normalized.
    """
    K, P, _ = mag.shape
    nb, no = cfg.desc_width, cfg.desc_bins
    ct = jnp.cos(theta)[:, None, None]
    st = jnp.sin(theta)[:, None, None]
    bin_size = (cfg.desc_mag * sigma_oct)[:, None, None]
    # rotate offsets into the keypoint frame, in bin units
    ux = (ct * dx + st * dy) / bin_size
    uy = (-st * dx + ct * dy) / bin_size
    wg = jnp.exp(-(ux * ux + uy * uy) / (2.0 * (nb / 2.0) ** 2))
    support = (jnp.abs(ux) < (nb + 1) / 2.0) & (jnp.abs(uy) < (nb + 1) / 2.0)
    c = (mag * wg * support).reshape(K, P * P)

    rel = ang - theta[:, None, None]
    ob = jnp.mod(rel / (2 * jnp.pi) * no, no).reshape(K, P * P)
    obins = jnp.arange(no, dtype=jnp.float32)
    do = jnp.abs(ob[:, :, None] - obins[None, None, :])
    wo = jnp.maximum(0.0, 1.0 - jnp.minimum(do, no - do))     # (K, P^2, no)

    bx = (ux + nb / 2.0 - 0.5).reshape(K, P * P)
    by = (uy + nb / 2.0 - 0.5).reshape(K, P * P)
    sbins = jnp.arange(nb, dtype=jnp.float32)
    wx = jnp.maximum(0.0, 1.0 - jnp.abs(bx[:, :, None] - sbins[None, None, :]))
    rows = []
    for ybin in range(nb):
        wyb = jnp.maximum(0.0, 1.0 - jnp.abs(by - float(ybin))) * c
        rows.append(jnp.einsum("kpx,kpo->kxo", wx * wyb[:, :, None], wo))
    desc = jnp.stack(rows, axis=1).reshape(K, nb * nb * no)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True),
                              1e-12)
    desc = jnp.minimum(desc, cfg.clip)
    return desc / jnp.maximum(jnp.linalg.norm(desc, axis=1, keepdims=True),
                              1e-12)


@partial(jax.jit, static_argnames=("cfg",))
def extract(img, cfg: SiftConfig = SiftConfig()):
    """Full SIFT extraction on an (H, W) float image in [0, 1].

    Returns dict:
      xy (K, 2): centered subpixel coords (principal point at image center),
      sigma (K,), angle (K,), response (K,),
      desc (K, 128) L2-normalized float32,
      mask (K,) validity.
    Up to cfg.n_orientations slots per detection (80%-peak rule); the
    global budget cfg.max_keypoints is enforced by a final top-K.
    """
    H, W = img.shape
    octs = gaussian_pyramid(img, cfg)
    budget = cfg.max_keypoints // cfg.n_octaves
    P = cfg.patch
    S = cfg.n_scales

    all_xy, all_sig, all_resp, all_score, all_mask = [], [], [], [], []
    all_desc, all_angle = [], []
    for o, stack in enumerate(octs):
        det = detect_octave(stack, o, cfg, budget)
        # per-level gradient stacks for the detection levels (gauss 1..S;
        # DoG level l uses gauss level l)
        glevels = stack[1:S + 1]
        if glevels.shape[1] < P or glevels.shape[2] < P:
            glevels = jnp.pad(glevels,
                              ((0, 0), (0, max(P - glevels.shape[1], 0)),
                               (0, max(P - glevels.shape[2], 0))))
        gx3, gy3 = _grad_stack(glevels)
        lvl_idx = jnp.clip(det["lvl"] - 1, 0, S - 1)
        gxp, oy, ox = _extract_patches(gx3, lvl_idx, det["y"], det["x"], P)
        gyp, _, _ = _extract_patches(gy3, lvl_idx, det["y"], det["x"], P)
        mag = jnp.sqrt(gxp * gxp + gyp * gyp)
        ang = jnp.arctan2(gyp, gxp)
        yf = det["y"].astype(jnp.float32) + det["dy"]
        xf = det["x"].astype(jnp.float32) + det["dx"]
        dy, dx = _patch_offsets(oy, ox, yf, xf, P)
        sig_oct = det["sigma"] / (2.0 ** o)

        theta1, theta2, has2 = orientation_peaks(mag, ang, dy, dx, sig_oct,
                                                 cfg)
        d1 = descriptors_from_patches(mag, ang, dy, dx, sig_oct, theta1, cfg)
        slots_desc = [d1]
        slots_theta = [theta1]
        slots_mask = [det["mask"]]
        slots_score = [det["score"]]
        if cfg.n_orientations >= 2:
            d2 = descriptors_from_patches(mag, ang, dy, dx, sig_oct, theta2,
                                          cfg)
            slots_desc.append(d2)
            slots_theta.append(theta2)
            slots_mask.append(det["mask"] & has2)
            # tiny penalty so secondary orientations lose exact-tie breaks
            slots_score.append(det["score"] * 0.999)

        n_slots = len(slots_desc)
        all_xy.append(jnp.tile(det["xy"], (n_slots, 1)))
        all_sig.append(jnp.tile(det["sigma"], (n_slots,)))
        all_resp.append(jnp.tile(det["resp"], (n_slots,)))
        all_score.append(jnp.concatenate(slots_score))
        all_mask.append(jnp.concatenate(slots_mask))
        all_desc.append(jnp.concatenate(slots_desc))
        all_angle.append(jnp.concatenate(slots_theta))

    xy = jnp.concatenate(all_xy)
    sigma = jnp.concatenate(all_sig)
    resp = jnp.concatenate(all_resp)
    score = jnp.concatenate(all_score)
    mask = jnp.concatenate(all_mask)
    desc = jnp.concatenate(all_desc)
    angle = jnp.concatenate(all_angle)

    # global top-K by detection score among valid slots
    K = min(cfg.max_keypoints, int(score.shape[0]))
    sel_score = jnp.where(mask, score, -1.0)
    top, idx = jax.lax.top_k(sel_score, K)
    sel_mask = top > 0
    xy = xy[idx]
    center = jnp.array([W / 2.0, H / 2.0])
    return {
        "xy": xy - center,                    # centered coords (ref convention)
        "xy_pix": xy,
        "sigma": sigma[idx],
        "angle": angle[idx],
        "response": resp[idx],
        "desc": desc[idx].astype(jnp.float32),
        "mask": sel_mask,
    }
