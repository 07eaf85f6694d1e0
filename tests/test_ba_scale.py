"""Bundle adjustment at scale: sharded-LM parity on a problem where the
psum'd reduced camera system is nontrivial, and the hierarchical submap
solver on a 1k-camera reconstruction.

The reference's only BA scaling mechanism is Ceres threads
(optimizer.cc:47, SURVEY §2.11); these tests cover this build's two
scaling paths: track-sharded distributed LM (parallel/sharded_ba.py) and
submap partitioning + Sim(3) pose-graph merge (parallel/submap_ba.py).
"""
import numpy as np
import jax.numpy as jnp
import pytest

from tests.conftest import make_scene
from metricsfm_tpu.ba import LMConfig, solve_lm
from metricsfm_tpu.models.scene import Scene
from metricsfm_tpu.ops import np_geom
from metricsfm_tpu.parallel import make_mesh
from metricsfm_tpu.parallel import submap_ba
from metricsfm_tpu.parallel.sharded_ba import solve_lm_sharded
from metricsfm_tpu.models.accuracy import assess
from tests.test_parallel import perturb, scene_to_problem


def test_sharded_parity_at_scale(rng):
    """48 cameras / 6k points on the 8-device mesh: the reduced system is
    291x291 and every device holds ~750 tracks — the psum'd (S, rhs) is
    far from trivial.  Final cost and poses must match the single-device
    solver."""
    scene = make_scene(rng, n_cams=48, n_pts=6144)
    prob = scene_to_problem(scene)
    prob = prob._replace(pose_mut=jnp.ones((48,)).at[0].set(0.0),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)

    cfg = LMConfig(max_iterations=30)
    out_single, info_single = solve_lm(bad, cfg)
    out_shard, info_shard = solve_lm_sharded(bad, make_mesh(8), cfg)

    c1 = float(info_single["final_cost"])
    c2 = float(info_shard["final_cost"])
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.05 or max(c1, c2) < 1e-3
    np.testing.assert_allclose(np.asarray(out_shard.poses),
                               np.asarray(out_single.poses), atol=1e-2)
    # and it actually converged to a good reconstruction
    n_obs = int(np.asarray(bad.track_mask).sum())
    rms = np.sqrt(2.0 * c2 / n_obs)
    assert rms < 0.1, rms


def test_cg_camera_solve_matches_dense(rng):
    """The matrix-free block-Jacobi PCG path (cfg.cg_iterations > 0) must
    converge to the same solution as the dense-Schur Cholesky path — both
    with the segment_sum reduction and the (C, K) gather-table one."""
    scene = make_scene(rng, n_cams=12, n_pts=512)
    prob = scene_to_problem(scene)
    prob = prob._replace(pose_mut=jnp.ones((12,)).at[0].set(0.0),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)
    out_d, info_d = solve_lm(bad, LMConfig(max_iterations=30))
    # cg_forcing off: this pins LINEAR-SOLVER path parity (exact CG vs
    # dense Cholesky); the inexact-Newton forcing sequence deliberately
    # takes a different (cheaper) LM trajectory and is covered by
    # test_cg_forcing_converges
    out_c, info_c = solve_lm(bad, LMConfig(
        max_iterations=30, cg_iterations=100, cg_tol=1e-6,
        cg_forcing=False))
    c1 = float(info_d["final_cost"])
    c2 = float(info_c["final_cost"])
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.1 or max(c1, c2) < 1e-3
    np.testing.assert_allclose(np.asarray(out_c.poses),
                               np.asarray(out_d.poses), atol=1e-3)


def test_cg_forcing_converges(rng):
    """The inexact-Newton forcing sequence (loose CG tolerance early,
    tightened on accepted steps — Agarwal et al., BAL) must reach the same
    optimum as exact CG solves, just cheaper."""
    scene = make_scene(rng, n_cams=12, n_pts=512)
    prob = scene_to_problem(scene)
    prob = prob._replace(pose_mut=jnp.ones((12,)).at[0].set(0.0),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)
    _, info_exact = solve_lm(bad, LMConfig(
        max_iterations=40, cg_iterations=100, cg_tol=1e-6,
        cg_forcing=False))
    _, info_force = solve_lm(bad, LMConfig(
        max_iterations=40, cg_iterations=100, cg_tol=1e-6,
        cg_forcing=True))
    c1 = float(info_exact["final_cost"])
    c2 = float(info_force["final_cost"])
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.05 or max(c1, c2) < 1e-3, (c1, c2)
    n_obs = int(np.asarray(bad.track_mask).sum())
    assert np.sqrt(2.0 * c2 / n_obs) < 0.1


@pytest.mark.slow
def test_sharded_cg_1k_parity():
    """1,024 cameras / 131k points on the 8-device mesh with the
    matrix-free PCG camera solve (the only path that survives this scale;
    the dense partial OOMs).  The sharded
    solve — one (D,) psum per CG iteration — must match the single-device
    CG solve."""
    from metricsfm_tpu.utils import synth
    prob = synth.synthetic_ba_problem(n_cams=1024, n_pts=131072,
                                      max_views=6, seed=0)
    cfg = LMConfig(max_iterations=5, cg_iterations=40, cg_tol=1e-5)
    out_single, info_single = solve_lm(prob, cfg)
    out_shard, info_shard = solve_lm_sharded(prob, make_mesh(8), cfg)
    c0 = float(info_single["initial_cost"])
    c1 = float(info_single["final_cost"])
    c2 = float(info_shard["final_cost"])
    # both converged substantially and to the same cost
    assert c1 < 0.2 * c0, (c0, c1)
    assert abs(c1 - c2) / max(c1, 1e-9) < 0.05, (c1, c2)
    np.testing.assert_allclose(np.asarray(out_shard.poses),
                               np.asarray(out_single.poses), atol=1e-2)


def _big_scene(rng, gt, pose_sigma=0.004, pt_sigma=0.05):
    C, P = gt["poses"].shape[0], gt["points"].shape[0]
    scene = Scene(n_images=C)
    m = scene.add_camera_model(__import__(
        "metricsfm_tpu.models.scene", fromlist=["CameraModel"]
    ).CameraModel(f=float(gt["intrs"][0][0]), calibrated=True))
    for i in range(C):
        noisy = gt["poses"][i] + rng.normal(0, pose_sigma, 6)
        scene.register_image(i, noisy, m, n_kps=P)
    for p in range(P):
        obs = {i: p for i in range(C) if gt["vis"][i, p]}
        if len(obs) >= 2:
            scene.add_track(gt["points"][p] + rng.normal(0, pt_sigma, 3),
                            obs)
    return scene


@pytest.mark.slow
def test_hierarchical_ba_1k_cameras(rng):
    """1,024-camera synthetic: partition into ~20 submaps, batched submap
    LM, Sim(3) pose-graph merge — post-merge reprojection error and camera
    ATE must land near ground truth (SURVEY §2.11 north star)."""
    C = 1024
    gt = make_scene(rng, n_cams=C, n_pts=2048, focal=900.0, noise_px=0.2)
    # cap track length so the BA problem stays bounded (long arcs see all)
    vis = gt["vis"]
    keep = np.cumsum(vis, axis=0) <= 12
    gt["vis"] = vis & keep
    scene = _big_scene(rng, gt)
    kp_xy = {i: gt["obs"][i] for i in range(C)}

    before = assess(scene, kp_xy, max_views=12)["avg_err"]
    submap_ba.hierarchical_ba(scene, kp_xy, max_cams=64, overlap=8,
                              max_views=12, cfg=LMConfig(max_iterations=25))
    after = assess(scene, kp_xy, max_views=12)["avg_err"]
    assert after < before, (before, after)
    assert after < 1.0, after

    err = []
    for i in scene.registered:
        c_est = np_geom.camera_center(scene.poses[i])
        c_gt = np_geom.camera_center(gt["poses"][i])
        err.append(np.linalg.norm(c_est - c_gt))
    extent = 16.0   # arc diameter at depth 8
    assert np.median(err) / extent < 0.02, np.median(err)

def test_cg_masked_slots_excluded(rng):
    """Padded tracks/slots all point at camera 0 with garbage uv; the CG
    matvec's one-hot reduction must route them to the sentinel bin so the
    heavily-padded problem solves to the same answer as a dense solve on
    the same (mask-weighted) residuals."""
    from metricsfm_tpu.ba import problem as ba_problem
    C, P, V = 8, 64, 6
    track_cam = np.zeros((P, V), np.int32)
    track_mask = np.zeros((P, V), bool)
    # 10 live tracks, 2 views each, spread over cameras 1..4; everything
    # else is a masked slot aimed at camera 0 with nonsense observations
    track_uv = rng.normal(size=(P, V, 2)) * 1e3
    for p in range(10):
        track_cam[p, 0] = 1 + p % 4
        track_cam[p, 1] = 1 + (p + 1) % 4
        track_mask[p, :2] = True
    prob = ba_problem.build_problem(
        np.zeros((C, 6)), np.tile([[100.0, 0, 0]], (C, 1)), np.arange(C),
        rng.normal(size=(P, 3)), track_cam,
        track_uv, track_mask)
    out_c, info_c = solve_lm(prob, LMConfig(max_iterations=4,
                                            cg_iterations=30, cg_tol=1e-8,
                                            cg_forcing=False))
    out_d, info_d = solve_lm(prob, LMConfig(max_iterations=4))
    c1, c2 = float(info_c["final_cost"]), float(info_d["final_cost"])
    assert np.isfinite(c1)
    assert abs(c1 - c2) / max(abs(c2), 1e-9) < 0.05 or max(c1, c2) < 1e-6, \
        (c1, c2)
