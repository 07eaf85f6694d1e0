import jax
import jax.numpy as jnp
import numpy as np

from metricsfm_tpu.ba import BAProblem, LMConfig, solve_lm
from metricsfm_tpu.ba import problem as ba_problem
from metricsfm_tpu.ba.lm import problem_cost
from tests.conftest import make_scene


def scene_to_problem(scene, V=None, noise=None, rng=None, shared_model=False,
                     weight=None):
    """Build a BAProblem from a synthetic scene where every camera sees every point."""
    C = scene["poses"].shape[0]
    P = scene["points"].shape[0]
    V = V or C
    track_cam = np.tile(np.arange(C)[None, :], (P, 1))[:, :V]
    track_uv = np.transpose(scene["obs"], (1, 0, 2))[:, :V]
    track_mask = np.transpose(scene["vis"], (1, 0))[:, :V]
    if shared_model:
        cam_model = np.zeros(C, np.int32)
        intrs = scene["intrs"][:1]
    else:
        cam_model = np.arange(C, dtype=np.int32)
        intrs = scene["intrs"]
    return ba_problem.build_problem(
        scene["poses"], intrs, cam_model, scene["points"],
        track_cam, track_uv, track_mask, track_weight=weight)


def perturb(problem, rng, sig_pose=0.02, sig_pt=0.05, sig_f=0.0):
    poses = problem.poses + sig_pose * jnp.asarray(rng.normal(size=problem.poses.shape))
    points = problem.points + sig_pt * jnp.asarray(rng.normal(size=problem.points.shape))
    intrs = problem.intrs
    if sig_f:
        intrs = intrs.at[:, 0].mul(1.0 + sig_f * jnp.asarray(rng.normal(size=intrs.shape[0])))
    return problem._replace(poses=poses, points=points, intrs=intrs)


def test_zero_residual_at_ground_truth(scene):
    prob = scene_to_problem(scene)
    cost = problem_cost(prob, 1.0)
    assert float(cost) < 1e-4


def test_lm_converges_points_only(rng):
    scene = make_scene(rng, n_cams=4, n_pts=60)
    prob = scene_to_problem(scene)
    # freeze cameras+intrinsics, perturb points: pure triangulation refinement
    prob = prob._replace(pose_mut=jnp.zeros_like(prob.pose_mut),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.0, sig_pt=0.2)
    out, info = solve_lm(bad, LMConfig(max_iterations=30))
    assert float(info["final_cost"]) < 1e-3
    np.testing.assert_allclose(out.points, prob.points, atol=1e-2)


def test_lm_converges_full(rng):
    scene = make_scene(rng, n_cams=5, n_pts=80)
    prob = scene_to_problem(scene)
    # gauge fixing: freeze first camera
    pose_mut = jnp.ones((5,)).at[0].set(0.0)
    prob = prob._replace(pose_mut=pose_mut,
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.01, sig_pt=0.05)
    cost_before = float(problem_cost(bad, 1.0))
    out, info = solve_lm(bad, LMConfig(max_iterations=50))
    assert float(info["final_cost"]) < 1e-2 * cost_before
    assert float(info["rms_px"]) < 0.1


def test_lm_with_intrinsics(rng):
    scene = make_scene(rng, n_cams=6, n_pts=150)
    prob = scene_to_problem(scene, shared_model=True)
    pose_mut = jnp.ones((6,)).at[0].set(0.0)
    prob = prob._replace(pose_mut=pose_mut)
    bad = perturb(prob, rng, sig_pose=0.005, sig_pt=0.03, sig_f=0.02)
    out, info = solve_lm(bad, LMConfig(max_iterations=60))
    # focal recovered within 0.5%
    np.testing.assert_allclose(float(out.intrs[0, 0]),
                               float(prob.intrs[0, 0]), rtol=5e-3)
    assert float(info["rms_px"]) < 0.2


def test_lm_huber_outliers(rng):
    scene = make_scene(rng, n_cams=5, n_pts=100, noise_px=0.2)
    prob = scene_to_problem(scene)
    # corrupt 5% of observations grossly
    uv = np.array(prob.track_uv)
    flat = uv.reshape(-1, 2)
    idx = rng.choice(len(flat), size=len(flat) // 20, replace=False)
    flat[idx] += 200.0
    prob = prob._replace(track_uv=jnp.asarray(uv))
    pose_mut = jnp.ones((5,)).at[0].set(0.0)
    prob = prob._replace(pose_mut=pose_mut, intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.005, sig_pt=0.02)
    out, info = solve_lm(bad, LMConfig(max_iterations=40))
    # inlier reprojection should still be sub-pixel despite outliers
    from metricsfm_tpu.ba.lm import compute_residuals
    r = np.asarray(compute_residuals(out))
    err = np.linalg.norm(r, axis=-1)[np.asarray(out.track_mask)]
    assert np.median(err) < 1.0


def test_masked_views(rng):
    scene = make_scene(rng, n_cams=4, n_pts=50)
    prob = scene_to_problem(scene)
    # knock out some views; solver must ignore them
    mask = np.array(prob.track_mask)
    mask[:, 3] = False
    uv = np.array(prob.track_uv)
    uv[:, 3] = 1e6  # poison masked slots
    prob = prob._replace(track_mask=jnp.asarray(mask), track_uv=jnp.asarray(uv),
                         pose_mut=jnp.ones((4,)).at[0].set(0.0),
                         intr_mut=jnp.zeros_like(prob.intr_mut))
    bad = perturb(prob, rng, sig_pose=0.005, sig_pt=0.02)
    out, info = solve_lm(bad, LMConfig(max_iterations=30))
    assert float(info["rms_px"]) < 0.1
    assert np.all(np.isfinite(np.asarray(out.poses)))


def test_normalize_denormalize(rng):
    scene = make_scene(rng, n_cams=4, n_pts=50)
    prob = scene_to_problem(scene)
    normed, tf = ba_problem.normalize_problem(prob)
    # projections invariant
    c0 = float(problem_cost(prob, 1.0))
    c1 = float(problem_cost(normed, 1.0))
    assert abs(c0 - c1) < 1e-2
    back = ba_problem.denormalize_problem(normed, tf)
    np.testing.assert_allclose(back.points, prob.points, atol=1e-3)
    np.testing.assert_allclose(back.poses, prob.poses, atol=1e-3)


def test_seed_recovery_after_perturb(rng, key):
    """The reference's seed recipe: normalize, perturb, full BA (optimizer.cc:50-60)."""
    scene = make_scene(rng, n_cams=3, n_pts=60)
    prob = scene_to_problem(scene)
    normed, tf = ba_problem.normalize_problem(prob)
    pert = ba_problem.perturb_problem(normed, key, 0.02, 0.1, 0.1)
    pose_mut = jnp.ones((3,)).at[0].set(0.0)
    pert = pert._replace(pose_mut=pose_mut, intr_mut=jnp.zeros_like(pert.intr_mut))
    out, info = solve_lm(pert, LMConfig(max_iterations=80))
    assert float(info["rms_px"]) < 0.5


def test_gps_triple_constraints(scene, rng):
    """GPS relative angle/distance-ratio residuals over camera triples
    (ref gps_error_pose_raletive_angle.h / gps_error_pose_raletive_dis.h)."""
    from metricsfm_tpu.ba.lm import gps_triple_residuals
    from metricsfm_tpu.ops import projection

    prob = scene_to_problem(scene)
    C = prob.n_cameras
    centers = np.asarray(jax.vmap(projection.camera_center)(prob.poses))
    trip = np.stack([np.arange(C - 2), np.arange(1, C - 1),
                     np.arange(2, C)], axis=1)
    tw = np.ones((len(trip), 2), np.float32)

    # gps = true camera centers -> residuals vanish at ground truth
    p0 = prob._replace(gps_pos=jnp.asarray(centers, jnp.float32),
                       gps_triple=jnp.asarray(trip, jnp.int32),
                       gps_triple_weight=jnp.asarray(tw))
    r0 = np.asarray(gps_triple_residuals(p0))
    np.testing.assert_allclose(r0, 0.0, atol=1e-4)

    # perturbed poses -> nonzero residuals, and LM with the constraints
    # converges back to lower cost than without them
    p_bad = perturb(p0, rng, sig_pose=0.03, sig_pt=0.0)
    r_bad = np.asarray(gps_triple_residuals(p_bad))
    assert np.abs(r_bad).max() > 1e-4

    cfg = LMConfig(max_iterations=30)
    out, info = solve_lm(p_bad, cfg)
    r_fin = np.asarray(gps_triple_residuals(out))
    assert np.abs(r_fin).max() < np.abs(r_bad).max() * 0.5
    assert float(info["final_cost"]) < float(info["initial_cost"])


def test_ba_at_utm_magnitude_with_host_demean(rng):
    """f32 BA at raw UTM magnitudes (easting ~5e5, northing ~4.4e6) vs the
    documented mitigation: demean in f64 on host
    BEFORE building the f32 problem — the SLAM-GPS path's recipe
    (slam_gps.py demeans GPS/UTM in numpy f64).

    Raw UTM in f32 quantizes coordinates to ~0.5 m (worse than the scene's
    structure), so the demeaned solve must reach the clean-problem cost
    while the raw-offset solve must NOT."""
    scene = make_scene(rng, n_cams=8, n_pts=512, noise_px=0.3)
    offset = np.array([5.0e5, 4.4e6, 0.0])

    def build(points64, poses64):
        import jax.numpy as jnp
        uv, vis = scene["obs"], scene["vis"]
        V = 6
        track_cam = np.stack([np.where(vis[:, p])[0][:V] for p in
                              range(512)])
        track_uv = np.stack([uv[track_cam[p], p] for p in range(512)])
        prob = ba_problem.build_problem(
            poses64, scene["intrs"], np.arange(8), points64,
            track_cam.astype(np.int32), track_uv,
            np.ones_like(track_cam, bool))
        return prob._replace(pose_mut=jnp.ones((8,)).at[0].set(0.0),
                             intr_mut=jnp.zeros((8,)))

    # world shifted to UTM magnitude: points + camera centers translate,
    # so t = -R(c + offset) = t - R @ offset (f64 host math)
    from metricsfm_tpu.ops import np_geom
    pts_utm = scene["points"] + offset
    poses_utm = scene["poses"].copy()
    for i in range(8):
        R, t = np_geom.pose_to_Rt(scene["poses"][i])
        poses_utm[i, 3:] = t - R @ offset

    noisy = lambda p: p + rng.normal(0, 0.01, p.shape)
    cfg = LMConfig(max_iterations=25)

    # clean local-frame reference
    prob_local = build(noisy(scene["points"]), noisy(scene["poses"]))
    _, info_local = solve_lm(prob_local, cfg)
    rms_local = float(info_local["rms_px"])
    assert rms_local < 1.0

    # mitigation: demean in f64 -> identical local problem -> same rms
    mean = pts_utm.mean(axis=0)
    pts_dm = pts_utm - mean
    poses_dm = poses_utm.copy()
    for i in range(8):
        R, _ = np_geom.pose_to_Rt(poses_utm[i])
        poses_dm[i, 3:] = poses_utm[i, 3:] + R @ mean
    prob_dm = build(noisy(pts_dm), noisy(poses_dm))
    _, info_dm = solve_lm(prob_dm, cfg)
    assert float(info_dm["rms_px"]) < 2.0 * rms_local + 0.2

    # raw UTM f32: coordinate quantization (~0.5 m at 4.4e6) wrecks the
    # residuals — the solve cannot reach the local-frame accuracy
    prob_raw = build(noisy(pts_utm), noisy(poses_utm))
    _, info_raw = solve_lm(prob_raw, cfg)
    assert float(info_raw["rms_px"]) > 10.0 * rms_local
