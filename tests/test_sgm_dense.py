"""Dense stereo tests: SGM on synthetic rectified pairs with known disparity."""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from metricsfm_tpu.config import DenseOptions
from metricsfm_tpu.models.dense import (DenseReconstruction, read_sure_pose_file,
                                        rectify_pair)
from metricsfm_tpu.ops import sgm


def textured_scene(rng, H=96, W=160, max_disp=24):
    """Random texture + piecewise-constant disparity; right built by forward
    warping the left (left pixel x appears at right pixel x - d)."""
    tex = rng.uniform(0, 1, size=(H, W)).astype(np.float32)
    # smooth the texture a little so census windows are informative
    k = np.ones(3) / 3
    for ax in (0, 1):
        tex = np.apply_along_axis(lambda r: np.convolve(r, k, "same"), ax, tex)
    disp = np.full((H, W), 6.0, np.float32)
    disp[H // 3: 2 * H // 3, W // 4: 3 * W // 4] = 16.0   # foreground block
    left = tex
    right = np.zeros_like(left)
    for y in range(H):
        filled = np.zeros(W, bool)
        for x in range(W):
            xr = x - int(disp[y, x])
            if 0 <= xr < W:
                right[y, xr] = left[y, x]
                filled[xr] = True
        last = left[y, 0]
        for x in range(W):
            if filled[x]:
                last = right[y, x]
            else:
                right[y, x] = last
    return left, right, disp


def _aggregate_bruteforce(cost, p1=10, p2=120, num_paths=8):
    """Literal per-pixel, per-path SGM aggregation (the reference recurrence
    of dense/cudasgm/src/path_aggregation.cu), O(H*W*D*paths) python."""
    H, W, D = cost.shape
    cost = cost.astype(np.int64)
    dirs = [(0, 1), (0, -1), (1, 0), (-1, 0)]
    if num_paths >= 8:
        dirs += [(1, 1), (1, -1), (-1, 1), (-1, -1)]
    total = np.zeros((H, W, D), np.int64)
    for dy, dx in dirs:
        L = np.zeros((H, W, D), np.int64)
        ys = range(H) if dy >= 0 else range(H - 1, -1, -1)
        xs = range(W) if dx >= 0 else range(W - 1, -1, -1)
        for y in ys:
            for x in xs:
                py, px = y - dy, x - dx
                if 0 <= py < H and 0 <= px < W:
                    prev = L[py, px]
                    m = prev.min()
                    best = np.minimum(prev, m + p2)
                    best[1:] = np.minimum(best[1:], prev[:-1] + p1)
                    best[:-1] = np.minimum(best[:-1], prev[1:] + p1)
                    L[y, x] = cost[y, x] + best - m
                else:
                    L[y, x] = cost[y, x]
        total += L
    return total


@pytest.mark.parametrize("num_paths", [4, 8])
def test_aggregate_paths_matches_bruteforce(rng, num_paths):
    """Pins the exact per-direction recurrence incl. the diagonal paths
    (carry-shift formulation) against a literal reference implementation."""
    cost = rng.integers(0, 64, size=(10, 12, 8)).astype(np.int16)
    want = _aggregate_bruteforce(cost, num_paths=num_paths)
    got = np.asarray(sgm.aggregate_paths(jnp.asarray(cost),
                                         num_paths=num_paths)).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def _cost_volume_loop(census_l, census_r, max_disp):
    """Literal per-disparity, per-column Hamming cost (ref libSGM
    matching cost): popcount(cl(x) ^ cr(x - d)), 64 where x - d < 0."""
    _, H, W = census_l.shape
    vol = np.full((H, W, max_disp), 64.0, np.float32)
    for d in range(max_disp):
        for x in range(d, W):
            bits = np.bitwise_xor(census_l[:, :, x], census_r[:, :, x - d])
            vol[:, x, d] = np.bitwise_count(bits).sum(axis=0)
    return vol


@pytest.mark.parametrize("shape", [(20, 33, 8), (37, 61, 48)])
def test_matching_cost_volume_matches_loop(rng, shape):
    H, W, D = shape
    cl = sgm.census_transform(jnp.asarray(rng.uniform(0, 1, (H, W)),
                                          jnp.float32))
    cr = sgm.census_transform(jnp.asarray(rng.uniform(0, 1, (H, W)),
                                          jnp.float32))
    got = np.asarray(sgm.matching_cost_volume(cl, cr, D))
    want = _cost_volume_loop(np.asarray(cl), np.asarray(cr), D)
    np.testing.assert_array_equal(got, want)


def test_census_hamming(rng):
    img = jnp.asarray(rng.uniform(0, 1, size=(32, 40)).astype(np.float32))
    c = sgm.census_transform(img)
    assert c.shape == (2, 32, 40)
    # identical images -> zero cost at d=0
    vol = sgm.matching_cost_volume(c, c, 8)
    assert float(vol[16, 20, 0]) == 0.0
    assert float(vol[16, 20, 3]) > 0.0


def test_sgm_recovers_disparity(rng):
    left, right, disp_gt = textured_scene(rng)
    disp, valid = sgm.stereo_sgm(jnp.asarray(left), jnp.asarray(right),
                                 max_disp=32, num_paths=8)
    disp = np.asarray(disp)
    valid = np.asarray(valid)
    # ignore the left band (occluded / out of range) and block edges
    region = np.zeros_like(valid)
    region[4:-4, 40:-8] = True
    sel = valid & region
    assert sel.mean() > 0.3, f"too few valid pixels: {sel.mean()}"
    err = np.abs(disp - disp_gt)[sel]
    assert np.median(err) < 1.0, f"median disparity error {np.median(err)}"
    assert (err < 2).mean() > 0.8


def test_disparity_depth_roundtrip():
    disp = jnp.asarray(np.array([[10.0, 20.0, -1.0]], np.float32))
    depth = sgm.disparity_to_depth(disp, focal=100.0, baseline=0.5,
                                   scale=20.0, clamp=600.0)
    d = np.asarray(depth)
    assert abs(d[0, 0] - min(20 * 100 * 0.5 / 10, 600)) < 1e-3
    assert d[0, 2] == 0.0


def test_rectification_geometry(rng):
    # two cameras with a lateral baseline: after rectification the new
    # rotation's x-axis is the baseline direction
    K = np.diag([500.0, 500.0, 1.0])
    R1 = np.eye(3)
    t1 = np.zeros(3)
    R2 = np.eye(3)
    t2 = np.array([-1.0, 0.02, 0.01])  # c2 = (1, -0.02, -0.01)
    Rn, Kn, H1, H2, baseline = rectify_pair(K, R1, t1, K, R2, t2)
    c1 = -R1.T @ t1
    c2 = -R2.T @ t2
    b = (c2 - c1) / np.linalg.norm(c2 - c1)
    np.testing.assert_allclose(Rn[0], b, atol=1e-9)
    np.testing.assert_allclose(Rn @ Rn.T, np.eye(3), atol=1e-9)
    assert abs(baseline - np.linalg.norm(c2 - c1)) < 1e-12


def test_dense_driver_end_to_end(tmp_path, rng):
    """Full driver on a synthetic pair written through the SURE format."""
    from metricsfm_tpu.io.exports import write_sure

    left, right, disp_gt = textured_scene(rng, H=64, W=96, max_disp=16)
    H, W = left.shape
    K = np.diag([80.0, 80.0, 1.0])
    poses = {
        "a.png": (np.eye(3), np.zeros(3)),
        "b.png": (np.eye(3), np.array([-0.5, 0.0, 0.0])),
    }
    # write a minimal SURE file by hand
    with open(os.path.join(tmp_path, "sfm_sure.txt"), "w") as f:
        for _ in range(8):
            f.write("#\n")
        for name, (R, t) in poses.items():
            f.write(f"{name} {W} {H}\n")
            for row in K:
                f.write(" ".join(str(v) for v in row) + "\n")
            f.write("0 0 0 0 0\n")
            f.write(" ".join(str(v) for v in t) + "\n")
            for row in R:
                f.write(" ".join(str(v) for v in row) + "\n")

    imgs = {"a.png": left, "b.png": right}
    dr = DenseReconstruction(DenseOptions(disp_size=32))
    clouds = dr.run(str(tmp_path), image_loader=lambda n: imgs[n])
    assert len(clouds) == 1
    assert len(clouds[0]) > 200
    assert os.path.exists(os.path.join(tmp_path, "dense", "depth_0.npy"))
    assert os.path.exists(os.path.join(tmp_path, "dense", "dense_cloud.txt"))
    # parsing roundtrip
    parsed = read_sure_pose_file(os.path.join(tmp_path, "sfm_sure.txt"))
    assert len(parsed) == 2 and parsed[0].name == "a.png"
