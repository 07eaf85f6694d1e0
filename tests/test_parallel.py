"""Multi-device tests on the virtual 8-device CPU mesh."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from metricsfm_tpu.ba import LMConfig, solve_lm
from metricsfm_tpu.parallel import make_mesh, solve_lm_sharded
from metricsfm_tpu.parallel.sharded_matching import match_pairs_sharded
from tests.conftest import make_scene
from tests.test_ba import scene_to_problem, perturb


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_ba_matches_single_device(rng):
    scene = make_scene(rng, n_cams=5, n_pts=128)
    prob = scene_to_problem(scene)
    pose_mut = jnp.ones((5,)).at[0].set(0.0)
    prob = prob._replace(pose_mut=pose_mut,
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)

    cfg = LMConfig(max_iterations=40)
    out_single, info_single = solve_lm(bad, cfg)

    mesh = make_mesh(8)
    out_shard, info_shard = solve_lm_sharded(bad, mesh, cfg)

    # same final cost (identical math, order-of-summation differences only)
    c1 = float(info_single["final_cost"])
    c2 = float(info_shard["final_cost"])
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.05 or max(c1, c2) < 1e-3
    np.testing.assert_allclose(np.asarray(out_shard.poses),
                               np.asarray(out_single.poses), atol=1e-2)


def test_sharded_ba_convergence(rng):
    scene = make_scene(rng, n_cams=6, n_pts=256)
    prob = scene_to_problem(scene)
    prob = prob._replace(pose_mut=jnp.ones((6,)).at[0].set(0.0),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)
    mesh = make_mesh(8)
    out, info = solve_lm_sharded(bad, mesh, LMConfig(max_iterations=40))
    n_obs = int(np.asarray(bad.track_mask).sum())
    rms = np.sqrt(2.0 * float(info["final_cost"]) / n_obs)
    assert rms < 0.1


def _check_sharded_matching(rng, mesh):
    B, N, D = 8, 128, 128
    d = rng.normal(size=(B, N, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    noise = d + 0.02 * rng.normal(size=d.shape).astype(np.float32)
    noise /= np.linalg.norm(noise, axis=-1, keepdims=True)
    mask = np.ones((B, N), bool)
    res = match_pairs_sharded(d, noise, mask, mask, mesh)
    idx2 = np.asarray(res["idx2"])
    good = np.asarray(res["good"])
    # identity matching per pair
    for b in range(B):
        g = good[b]
        assert g.sum() > N * 0.7
        assert (idx2[b][g] == np.arange(N)[g]).mean() > 0.99


def test_sharded_matching(rng):
    _check_sharded_matching(rng, make_mesh(8))


@pytest.mark.gpu
def test_sharded_matching_gpu_kernel(gpu, rng):
    """shard_map's varying-axes check over the Triton 2-NN, traced as on
    four cards (a one-card mesh here)."""
    _check_sharded_matching(rng, make_mesh(1))


# -- multi-host scaffolding (single-process degenerate coverage) -------------

def test_owned_range_partitions():
    from metricsfm_tpu.parallel.mesh import owned_range
    n = 103
    covered = []
    for p in range(4):
        lo, hi = owned_range(n, p, 4)
        covered.extend(range(lo, hi))
    assert covered == list(range(n))
    # single process owns everything
    assert owned_range(n, 0, 1) == (0, n)


def test_initialize_distributed_single_process_noop(monkeypatch):
    import jax
    from metricsfm_tpu.parallel.mesh import (initialize_distributed,
                                             make_global_mesh)
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    monkeypatch.delenv("JAX_NUM_PROCESSES", raising=False)
    assert initialize_distributed() == 0
    mesh = make_global_mesh()
    assert mesh.devices.size == len(jax.devices())


def test_database_owner_shards_extraction(tmp_path, rng):
    """owner=(pid, 2): each Database instance extracts only its image
    shard; together they cover the folder (per-shard resume semantics)."""
    from PIL import Image
    from metricsfm_tpu.config import DatabaseOptions
    from metricsfm_tpu.io import store as fstore
    from metricsfm_tpu.models.database import Database
    from metricsfm_tpu.utils import synth
    fold = str(tmp_path)
    tex = synth.multiscale_texture(rng, 128)
    for i in range(6):
        arr = np.roll((tex * 255).astype(np.uint8), i * 7, axis=1)
        Image.fromarray(arr).save(f"{fold}/im_{i}.png")
    opts = DatabaseOptions(resize=False, max_keypoints=256)
    db0 = Database(fold, opts, owner=(0, 2))
    db0.feature_extraction()
    have = [i for i in range(6) if fstore.has_features(db0.out, i)]
    assert have == [0, 1, 2]
    db1 = Database(fold, opts, owner=(1, 2))
    db1.feature_extraction()
    have = [i for i in range(6) if fstore.has_features(db1.out, i)]
    assert have == list(range(6))


def test_match_builder_owner_filters_pairs(rng):
    from metricsfm_tpu.config import GraphOptions
    from metricsfm_tpu.models.match_graph import MatchGraphBuilder
    from metricsfm_tpu.models.incremental import ImageFeatures
    # 4 images of shared random unit descriptors => everything matches
    base = rng.normal(size=(64, 32)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    feats = {}
    for i in range(4):
        d = base + rng.normal(0, 0.02, base.shape).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        feats[i] = ImageFeatures(
            xy=rng.uniform(-50, 50, (64, 2)).astype(np.float32) if i == 0
            else feats[0].xy + rng.normal(0, 1.0, (64, 2)).astype(np.float32),
            desc=d, mask=np.ones(64, bool))
    pairs = [(0, 1), (0, 2), (1, 2), (2, 3)]
    b = MatchGraphBuilder(GraphOptions(geoverify_min_inliers=8,
                                       ratio_all=0.95, ratio_good=0.9))
    out = b.build(feats, pairs, owner=(1, 2))   # owns images 2..3
    assert all(i >= 2 for (i, j) in out), list(out)
