import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metricsfm_tpu.ops import matching, sift


def unit_rows(rng, n, d=128):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def test_knn2_exact(rng):
    d1 = unit_rows(rng, 100)
    d2 = unit_rows(rng, 333)
    d1sq, d2sq, idx = matching.knn2(jnp.asarray(d1), jnp.asarray(d2),
                                    chunk=128, use_bf16=False)
    # brute force numpy
    dist = ((d1[:, None] - d2[None]) ** 2).sum(-1)
    order = np.argsort(dist, axis=1)
    np.testing.assert_array_equal(np.asarray(idx), order[:, 0])
    np.testing.assert_allclose(np.asarray(d1sq), dist[np.arange(100), order[:, 0]], atol=1e-4)
    np.testing.assert_allclose(np.asarray(d2sq), dist[np.arange(100), order[:, 1]], atol=1e-4)


def test_knn2_masked(rng):
    d1 = unit_rows(rng, 50)
    d2 = np.concatenate([unit_rows(rng, 60), d1[:10]])  # best matches at end
    mask2 = np.ones(70, bool)
    mask2[60:] = False  # exclude the exact matches
    _, _, idx = matching.knn2(jnp.asarray(d1), jnp.asarray(d2),
                              jnp.asarray(mask2), chunk=32, use_bf16=False)
    assert np.asarray(idx).max() < 60


def test_match_pair_ratio(rng):
    base = unit_rows(rng, 200)
    noise = rng.normal(size=base.shape).astype(np.float32) * 0.02
    d2 = base + noise
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    perm = rng.permutation(200)
    res = matching.match_pair(jnp.asarray(base), jnp.asarray(d2[perm]))
    idx2 = np.asarray(res["idx2"])
    good = np.asarray(res["good"])
    inv = np.argsort(perm)
    assert good.sum() > 150
    assert (idx2[good] == inv[good]).mean() > 0.99


def test_match_bf16_agrees(rng):
    d1 = unit_rows(rng, 128)
    d2 = unit_rows(rng, 256)
    _, _, i_f32 = matching.knn2(jnp.asarray(d1), jnp.asarray(d2), use_bf16=False)
    _, _, i_bf16 = matching.knn2(jnp.asarray(d1), jnp.asarray(d2), use_bf16=True)
    # bf16 ranking can differ on near-ties only
    assert (np.asarray(i_f32) == np.asarray(i_bf16)).mean() > 0.95


def checkerboard_image(rng, H=128, W=128, n_blobs=30):
    img = np.zeros((H, W), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n_blobs):
        cy, cx = rng.uniform(16, H - 16), rng.uniform(16, W - 16)
        s = rng.uniform(1.5, 4.0)
        a = rng.uniform(0.3, 1.0) * rng.choice([-1, 1])
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img -= img.min()
    img /= img.max()
    return img


def test_sift_detects_blobs(rng):
    img = checkerboard_image(rng)
    cfg = sift.SiftConfig(n_octaves=3, max_keypoints=256)
    out = sift.extract(jnp.asarray(img), cfg)
    n = int(np.asarray(out["mask"]).sum())
    assert n > 10
    # descriptors normalized
    d = np.asarray(out["desc"])[np.asarray(out["mask"])]
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-3)


def test_sift_translation_matching(rng):
    img = checkerboard_image(rng, H=160, W=160)
    shift = 7
    img2 = np.roll(img, (shift, shift), axis=(0, 1))
    cfg = sift.SiftConfig(n_octaves=3, max_keypoints=256)
    o1 = sift.extract(jnp.asarray(img), cfg)
    o2 = sift.extract(jnp.asarray(img2), cfg)
    res = matching.match_pair(o1["desc"], o2["desc"], o1["mask"], o2["mask"],
                              ratio_good=0.7, ratio_all=0.9)
    good = np.asarray(res["good"])
    assert good.sum() >= 10
    xy1 = np.asarray(o1["xy"])[good]
    xy2 = np.asarray(o2["xy"])[np.asarray(res["idx2"])[good]]
    d = xy2 - xy1
    # majority of matches should see the (shift, shift) translation
    err = np.linalg.norm(d - np.array([shift, shift]), axis=1)
    assert np.median(err) < 2.0


def _knn_inputs(rng, n1, n2, n_masked):
    """SIFT-like (non-negative, unit) rows; every query is a noisy copy of a
    database row, so its nearest valid neighbour is unambiguous unless the
    planted row is masked out."""
    d2 = np.abs(rng.normal(size=(n2, 128))).astype(np.float32)
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    mask2 = np.ones(n2, bool)
    mask2[n2 - n_masked:] = False
    planted = rng.integers(0, n2, size=n1)
    d1 = d2[planted] + 0.1 * np.abs(rng.normal(size=(n1, 128)))
    d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(np.float32)
    return d1, d2, mask2, planted


def _check_knn2(got, d1, d2, mask2, planted):
    """Compare a 2-NN result with an f32 numpy brute force."""
    sim = d1 @ d2.T
    sim[:, ~mask2] = -np.inf
    order = np.argsort(-sim, axis=1, kind="stable")
    rows = np.arange(len(d1))
    want1 = 2.0 - 2.0 * sim[rows, order[:, 0]]
    want2 = 2.0 - 2.0 * sim[rows, order[:, 1]]
    g1, g2, gi = (np.asarray(x) for x in got)
    assert gi.shape == (len(d1),) and gi.dtype == np.int32
    assert mask2[gi].all(), "a masked database row was returned"
    clear = mask2[planted]
    np.testing.assert_array_equal(gi[clear], planted[clear])
    # bf16 operands with f32 accumulation: similarities carry ~2^-9
    # relative error, i.e. up to ~1e-2 on d^2 = 2 - 2 s
    np.testing.assert_allclose(g1, want1, atol=2e-2)
    np.testing.assert_allclose(g2, want2, atol=2e-2)


# (N1, N2, chunk, masked database rows)
_KNN_CASES = {
    "n2_not_multiple_of_chunk": (100, 333, 128, 0),
    "masked_rows": (64, 300, 128, 40),
    "n1_ne_n2": (257, 64, 32, 0),
}


@pytest.mark.parametrize("case", sorted(_KNN_CASES))
def test_knn2_matches_bruteforce(rng, case):
    n1, n2, chunk, n_masked = _KNN_CASES[case]
    d1, d2, mask2, planted = _knn_inputs(rng, n1, n2, n_masked)
    got = matching.knn2(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask2),
                        chunk=chunk)
    _check_knn2(got, d1, d2, mask2, planted)


@pytest.mark.parametrize("case", sorted(_KNN_CASES))
def test_knn2_triton_interpret_matches_bruteforce(rng, case):
    """The fused GPU kernel's body, run by the Pallas interpreter."""
    from metricsfm_tpu.ops.pallas.match_kernel import knn2_triton
    n1, n2, _, n_masked = _KNN_CASES[case]
    d1, d2, mask2, planted = _knn_inputs(rng, n1, n2, n_masked)
    got = knn2_triton(jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(mask2),
                      interpret=True)
    _check_knn2(got, d1, d2, mask2, planted)


def test_knn2_triton_interpret_vmapped(rng):
    """vmap over pairs (the match-graph batching) prepends a grid axis."""
    from metricsfm_tpu.ops.pallas.match_kernel import knn2_triton
    batch = [_knn_inputs(rng, 96, 200, 24) for _ in range(3)]
    d1, d2, mask2 = (jnp.asarray(np.stack([b[k] for b in batch]))
                     for k in range(3))
    got = jax.vmap(lambda a, b, m: knn2_triton(a, b, m, interpret=True))(
        d1, d2, mask2)
    for k, (a, b, m, planted) in enumerate(batch):
        _check_knn2([x[k] for x in got], a, b, m, planted)


def test_match_pair_dispatch_off_gpu(rng):
    """Off the GPU, match_pair runs the XLA scan and no Pallas kernel."""
    d1, d2, _, _ = _knn_inputs(rng, 64, 128, 0)
    jaxpr = str(jax.make_jaxpr(matching.match_pair)(jnp.asarray(d1),
                                                     jnp.asarray(d2)))
    assert "pallas_call" not in jaxpr and "scan" in jaxpr


@pytest.mark.gpu
def test_knn2_triton_on_gpu(gpu, rng):
    """The compiled kernel (no interpreter) against the brute force, alone
    and vmapped, and match_pair dispatching to it."""
    from metricsfm_tpu.ops.pallas.match_kernel import knn2_triton
    for n1, n2, _, n_masked in _KNN_CASES.values():
        d1, d2, mask2, planted = _knn_inputs(rng, n1, n2, n_masked)
        got = jax.jit(knn2_triton)(jnp.asarray(d1), jnp.asarray(d2),
                                   jnp.asarray(mask2))
        _check_knn2(got, d1, d2, mask2, planted)
    batch = [_knn_inputs(rng, 1000, 3000, 100) for _ in range(4)]
    d1, d2, mask2 = (jnp.asarray(np.stack([b[k] for b in batch]))
                     for k in range(3))
    got = jax.jit(jax.vmap(knn2_triton))(d1, d2, mask2)
    for k, (a, b, m, planted) in enumerate(batch):
        _check_knn2([x[k] for x in got], a, b, m, planted)
    jaxpr = str(jax.make_jaxpr(matching.match_pair)(d1[0], d2[0]))
    assert "pallas_call" in jaxpr


def _blob_image(centers, H=128, W=128, s=2.5):
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W), np.float32)
    for cy, cx, a in centers:
        img += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    img -= img.min()
    m = img.max()
    return img / m if m > 0 else img


def test_sift_subpixel_repeatability(rng):
    """3D quadratic refinement (vlfeat vl_sift semantics): keypoints on an
    analytically shifted scene must track a 0.5-px shift to < 0.2 px."""
    centers = [(rng.uniform(20, 108), rng.uniform(20, 108),
                rng.uniform(0.5, 1.0) * rng.choice([-1, 1]))
               for _ in range(25)]
    shifted = [(cy + 0.5, cx + 0.5, a) for cy, cx, a in centers]
    cfg = sift.SiftConfig(n_octaves=3, max_keypoints=256)
    o1 = sift.extract(jnp.asarray(_blob_image(centers)), cfg)
    o2 = sift.extract(jnp.asarray(_blob_image(shifted)), cfg)
    xy1 = np.asarray(o1["xy"])[np.asarray(o1["mask"])]
    xy2 = np.asarray(o2["xy"])[np.asarray(o2["mask"])]
    assert len(xy1) > 10 and len(xy2) > 10
    # for each kp in img1, its nearest neighbour in img2 should sit at
    # +(0.5, 0.5) to subpixel accuracy
    d = np.linalg.norm(xy2[None, :, :] - (xy1[:, None, :] + 0.5), axis=-1)
    nn = d.min(axis=1)
    matched = nn[nn < 1.0]
    assert len(matched) >= 0.5 * len(xy1)
    assert np.median(matched) < 0.2


def test_sift_multi_orientation_slots(rng):
    """The 80%-peak rule emits secondary-orientation slots sharing the
    primary's location but with a different angle."""
    img = checkerboard_image(rng, H=160, W=160)
    cfg = sift.SiftConfig(n_octaves=3, max_keypoints=512)
    out = sift.extract(jnp.asarray(img), cfg)
    xy = np.asarray(out["xy"])[np.asarray(out["mask"])]
    ang = np.asarray(out["angle"])[np.asarray(out["mask"])]
    # find location-duplicate pairs (same detection, two orientations)
    d = np.linalg.norm(xy[None] - xy[:, None], axis=-1)
    np.fill_diagonal(d, 1e9)
    i, j = np.where(d < 1e-4)
    dup = [(a, b) for a, b in zip(i, j) if a < b]
    assert len(dup) >= 1
    for a, b in dup[:20]:
        diff = np.abs((ang[a] - ang[b] + np.pi) % (2 * np.pi) - np.pi)
        assert diff > 0.3  # genuinely different orientations


def test_sift_refined_sigma_off_grid(rng):
    """Scale refinement produces sigmas off the discrete k^lvl grid."""
    img = checkerboard_image(rng)
    cfg = sift.SiftConfig(n_octaves=3, max_keypoints=256)
    out = sift.extract(jnp.asarray(img), cfg)
    sig = np.asarray(out["sigma"])[np.asarray(out["mask"])]
    k = 2.0 ** (1.0 / cfg.n_scales)
    # distance to the nearest discrete level in log space
    logs = np.log(sig / cfg.sigma0) / np.log(k)
    off = np.abs(logs - np.round(logs))
    assert (off > 0.05).mean() > 0.5
