"""Match-graph builder tests: batched driver vs per-pair path, resume,
sharded (8-device CPU mesh) execution, candidate strategies.

The reference's fine matching graph (SfM/src/graph/fine_matching_graph.cc)
had no tests of its own; these pin our batched driver's semantics:
dual ratio tests -> F-RANSAC on "good" -> epipolar refilter of "all"
(fine_matching_graph.cc:42-43,104-147).
"""
import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from metricsfm_tpu.config import GraphOptions
from metricsfm_tpu.models.incremental import ImageFeatures
from metricsfm_tpu.models.match_graph import (MatchGraphBuilder,
                                              candidates_all, candidates_bow,
                                              candidates_gps)
from metricsfm_tpu.ops import np_geom
from tests.conftest import make_scene


def synthetic_features(rng, n_imgs=4, n_tracks=64, n_noise=16, desc_dim=128):
    """Images observing common 3D tracks: geometry-consistent keypoints with
    matching descriptors (unit vectors, shared per track), plus per-image
    random distractor keypoints."""
    scene = make_scene(rng, n_cams=n_imgs, n_pts=n_tracks, focal=800.0)
    track_desc = rng.normal(size=(n_tracks, desc_dim)).astype(np.float32)
    track_desc /= np.linalg.norm(track_desc, axis=1, keepdims=True)
    feats = {}
    perms = {}
    for i in range(n_imgs):
        perm = rng.permutation(n_tracks)
        perms[i] = perm
        xy = scene["obs"][i][perm].astype(np.float32)
        desc = track_desc[perm] + rng.normal(0, 0.02,
                                             (n_tracks, desc_dim)).astype(np.float32)
        noise_xy = rng.uniform(-400, 400, (n_noise, 2)).astype(np.float32)
        noise_desc = rng.normal(size=(n_noise, desc_dim)).astype(np.float32)
        xy = np.vstack([xy, noise_xy])
        desc = np.vstack([desc, noise_desc])
        desc /= np.linalg.norm(desc, axis=1, keepdims=True)
        mask = np.ones(len(xy), bool)
        feats[i] = ImageFeatures(xy=xy, desc=desc, mask=mask,
                                 width=1600, height=1200)
    return feats, perms


def _check_matches(out, perms, n_tracks=64):
    """Kept matches must map keypoints of the same track."""
    assert len(out) >= 1
    for (i, j), pm in out.items():
        assert len(pm.kp_i) >= 20
        inv_j = np.argsort(perms[j])
        for ki, kj in zip(pm.kp_i, pm.kp_j):
            if ki < n_tracks and kj < n_tracks:
                assert perms[i][ki] == perms[j][kj]


def test_batched_builder_correct(rng):
    feats, perms = synthetic_features(rng)
    opts = GraphOptions(geoverify_min_inliers=20)
    builder = MatchGraphBuilder(opts, batch_pairs=4)
    out = builder.build(feats, candidates_all(4))
    assert set(out) == set(candidates_all(4))
    _check_matches(out, perms)


def test_batched_matches_per_pair_path(rng):
    """The batched driver must agree with match_one_pair on clean data."""
    feats, perms = synthetic_features(rng, n_imgs=2)
    opts = GraphOptions(geoverify_min_inliers=20)
    builder = MatchGraphBuilder(opts, batch_pairs=2)
    out = builder.build(feats, [(0, 1)])
    single = MatchGraphBuilder(opts).match_one_pair(feats[0], feats[1])
    assert single is not None and (0, 1) in out
    got = set(zip(out[(0, 1)].kp_i.tolist(), out[(0, 1)].kp_j.tolist()))
    want = set(zip(single.kp_i.tolist(), single.kp_j.tolist()))
    # RANSAC keys differ between the two paths; on clean data the true
    # matches survive both — demand near-total agreement
    inter = len(got & want)
    assert inter >= 0.95 * max(len(got), len(want))


def test_builder_budget(rng):
    """max_matches_per_pair caps the kept matches per pair."""
    feats, _ = synthetic_features(rng, n_imgs=2)
    opts = GraphOptions(geoverify_min_inliers=10, max_matches_per_pair=24)
    out = MatchGraphBuilder(opts, batch_pairs=1).build(feats, [(0, 1)])
    assert (0, 1) in out
    assert len(out[(0, 1)].kp_i) <= 24
    assert len(out[(0, 1)].kp_i) >= 10


def test_builder_resume(rng, tmp_path):
    """Pairs already in the store are not recomputed (match_index semantics,
    fine_matching_graph.cc:49-57)."""
    feats, _ = synthetic_features(rng)
    opts = GraphOptions(geoverify_min_inliers=20)
    fold = str(tmp_path)
    b1 = MatchGraphBuilder(opts, out_fold=fold, batch_pairs=4)
    out1 = b1.build(feats, candidates_all(4))

    calls = []
    b2 = MatchGraphBuilder(opts, out_fold=fold, batch_pairs=4)
    orig = b2._batched_verifier

    def counting(chunk):
        fn = orig(chunk)

        def wrapped(*a):
            calls.append(1)
            return fn(*a)
        return wrapped

    b2._batched_verifier = counting
    out2 = b2.build(feats, candidates_all(4))
    assert not calls  # everything cached
    assert {k: len(v.kp_i) for k, v in out1.items()} == \
           {k: len(v.kp_i) for k, v in out2.items()}


def test_builder_sharded_mesh(rng):
    """Pair batches shard over the 8-device CPU mesh and agree with the
    single-device driver."""
    feats, perms = synthetic_features(rng, n_imgs=5)
    opts = GraphOptions(geoverify_min_inliers=20)
    mesh = Mesh(np.array(jax.devices()), ("data",))
    out = MatchGraphBuilder(opts, batch_pairs=8, mesh=mesh).build(
        feats, candidates_all(5))
    # SAME batch size as the sharded builder: per-pair RANSAC keys are a
    # function of the batch layout, so differing batch sizes compare
    # different random draws (borderline pairs flip), not the sharding
    ref = MatchGraphBuilder(opts, batch_pairs=8).build(
        feats, candidates_all(5))
    assert set(out) == set(ref)
    _check_matches(out, perms)
    for k in out:
        got = set(zip(out[k].kp_i.tolist(), out[k].kp_j.tolist()))
        want = set(zip(ref[k].kp_i.tolist(), ref[k].kp_j.tolist()))
        assert len(got & want) >= 0.95 * max(len(got), len(want))


def test_candidates_gps_mutual_knn():
    pts = np.array([[0, 0], [1, 0], [2, 0], [100, 100],
                    [101, 100], [102, 100], [0, 1], [1, 1], [2, 1],
                    [100, 101], [101, 101], [102, 101],
                    [0, 2], [1, 2], [2, 2], [100, 102], [101, 102],
                    [102, 102], [0, 3], [1, 3]], float)
    pairs = candidates_gps(pts, knn=2)
    # no pair should cross the two distant clusters
    left = {i for i, p in enumerate(pts) if p[0] < 50}
    for i, j in pairs:
        assert (i in left) == (j in left)


def test_candidates_bow_topk():
    sim = np.array([[0, 5, 1, 0], [5, 0, 0, 1], [1, 0, 0, 6], [0, 1, 6, 0]],
                   float)
    pairs = candidates_bow(sim, min_c=1, max_c=1)
    assert (0, 1) in pairs and (2, 3) in pairs


def test_image_match_shard_merge(tmp_path):
    """Per-image match shards ({i}_match, ref fine_matching_graph.cc:182)
    keep per-pair resume granularity: a resumed build must skip processed
    pairs (including EMPTY ones) and merge newly-processed pairs into the
    existing shard."""
    from metricsfm_tpu.io import store as fstore
    out = str(tmp_path)
    a = np.arange(5, dtype=np.int64)
    # first partial run: pair (0,1) kept, pair (0,2) processed-but-empty
    fstore.write_image_matches(out, 0, {
        1: (a, a + 1),
        2: (np.empty(0, np.int64), np.empty(0, np.int64))})
    r = fstore.read_image_matches(out, 0)
    assert r["processed"] == {1, 2}
    assert set(r["pairs"]) == {1}
    np.testing.assert_array_equal(r["pairs"][1][1], a + 1)
    # resume: pair (0,3) arrives; merge must keep 1 and the empty 2
    merged = {3: (a[:2], a[:2] + 7)}
    old = fstore.read_image_matches(out, 0)
    for j in old["processed"]:
        if j not in merged:
            merged[j] = old["pairs"].get(
                j, (np.empty(0, np.int64), np.empty(0, np.int64)))
    fstore.write_image_matches(out, 0, merged)
    r2 = fstore.read_image_matches(out, 0)
    assert r2["processed"] == {1, 2, 3}
    assert set(r2["pairs"]) == {1, 3}
    np.testing.assert_array_equal(r2["pairs"][3][0], a[:2])
