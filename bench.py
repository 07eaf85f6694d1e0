"""Benchmark harness: BA iterations/s, matched pairs/s and the pipelines,
on one NVIDIA GPU.

Refuses to run without a GPU (utils/device.py).  Prints the cumulative
result dict as ONE JSON line after EVERY completed key (stdout, flushed),
each line carrying the device JAX reports and the card's name and power
limit, so the last line is the most complete record and an external
timeout can never erase finished measurements.  Every timing waits for the
device with `jax.block_until_ready`.

A wall-clock budget (env BENCH_BUDGET_S, default 3300 s) gates each bench
on an estimated cost; benches that don't fit are recorded as -2.0
("skipped_budget" list) instead of being started and killed mid-run.

The reference publishes no benchmark numbers (BASELINE.md); the baseline
anchor used for vs_baseline is a CPU proxy of the reference's BA hot loop:
Ceres DENSE_SCHUR on one CPU thread sustains O(10) LM iterations/s on a
~64-camera/16k-point problem of this shape (BASELINE.md "Bundle
adjustment" row: <=100 iters per partial BA, 1 thread).
vs_baseline = measured BA iterations/s / 10.0.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np


def bench_ba(n_cams=64, n_pts=16384, max_views=6, iters=30, warmup=True):
    import jax
    import jax.numpy as jnp
    from metricsfm_tpu.ba.lm import (LMConfig, backsub_points,
                                     partial_camera_system, problem_cost,
                                     solve_reduced)
    from __graft_entry__ import _synthetic_problem

    prob = _synthetic_problem(n_cams=n_cams, n_pts=n_pts, max_views=max_views,
                              noise=0.01)
    cfg = LMConfig()

    @jax.jit
    def lm_step(problem, lam):
        C, M = problem.n_cameras, problem.n_models
        S, rhs, aux = partial_camera_system(problem, lam, cfg)
        d_cam = solve_reduced(S, rhs, problem, lam, cfg)
        d_pt = backsub_points(aux, d_cam, problem)
        return problem._replace(
            poses=problem.poses + d_cam[:6 * C].reshape(C, 6) * problem.pose_mut[:, None],
            intrs=problem.intrs + d_cam[6 * C:].reshape(M, 3) * problem.intr_mut[:, None],
            points=problem.points + d_pt)

    lam = jnp.float32(1e-3)
    jax.block_until_ready(lm_step(prob, lam))
    t0 = time.perf_counter()
    cur = prob
    for _ in range(iters):
        cur = lm_step(cur, lam)
    jax.block_until_ready(cur)
    return iters / (time.perf_counter() - t0)


def bench_ba_1k(n_cams=1024, n_pts=131072, max_views=6, iters=8,
                sharded=False, production=True):
    """LM iterations/s at 1,024 cameras / 131k points (the BASELINE.md
    north-star scale).  The dense-Schur path OOMs here (its one-hot factor
    is O(P*C) = 19 GB); this exercises the matrix-free block-Jacobi PCG
    camera solve (ba/lm.py, cfg.cg_iterations > 0).  sharded=True runs the
    same solve through shard_map over all visible devices (one (D,) psum
    per CG iteration — parity tested on the 8-device CPU mesh in
    tests/test_ba_scale.py).

    production=True measures the solver as the pipeline runs it: solve_lm
    with the inexact-Newton forcing sequence (loose CG tolerance early,
    tightened on accepted steps — Agarwal et al., BAL §3), `iters` LM
    iterations of one solve.  production=False pins the raw step cost at a
    FIXED 50 CG iterations per step (ba_iterations_per_s_1k_fixed50).

    Anchor: Ceres SPARSE_SCHUR on a modern multi-core CPU sustains
    ~0.5-2 LM it/s at this problem shape (BAL-class 1k-camera problems;
    the reference runs DENSE_SCHUR on 1 thread, optimizer.cc:47, which
    does not reach this scale at all) — vs_baseline for the 1k metric uses
    the 1.0 it/s midpoint of that range."""
    import jax
    import jax.numpy as jnp
    from metricsfm_tpu.ba.lm import LMConfig, _assemble_and_solve, solve_lm
    from metricsfm_tpu.utils import synth

    prob = synth.synthetic_ba_problem(n_cams=n_cams, n_pts=n_pts,
                                      max_views=max_views, seed=0)

    if production:
        cfg = LMConfig(max_iterations=iters, cg_iterations=50, cg_tol=1e-4,
                       cg_forcing=True, rtol=0.0)
        if sharded:
            # build mesh + sharding + the jitted solver ONCE so the timed
            # second run reuses the compiled executable instead of
            # re-tracing a fresh closure
            from metricsfm_tpu.parallel import make_mesh, shard_tracks
            from metricsfm_tpu.parallel.sharded_ba import make_sharded_lm
            mesh = make_mesh()
            sprob = shard_tracks(prob, mesh)
            solver = make_sharded_lm(mesh, cfg)
            run = lambda: solver(sprob)
        else:
            run = lambda: solve_lm(prob, cfg)
        jax.block_until_ready(run())            # compile + warm
        t0 = time.perf_counter()
        out, info = jax.block_until_ready(run())
        return int(info["iterations"]) / (time.perf_counter() - t0)

    cfg = LMConfig(cg_iterations=50, cg_tol=1e-4)

    if sharded:
        from metricsfm_tpu.parallel import make_mesh, shard_tracks
        from metricsfm_tpu.parallel.sharded_ba import _make_step
        mesh = make_mesh()
        prob = shard_tracks(prob, mesh)
        step = _make_step(cfg, "data")
        from jax.sharding import PartitionSpec as P
        track, repl = P("data"), P()
        from metricsfm_tpu.ba.problem import BAProblem
        spec = BAProblem(
            poses=repl, intrs=repl, cam_model=repl, points=track,
            track_cam=track, track_uv=track, track_mask=track,
            track_weight=track, pose_mut=repl, intr_mut=repl,
            point_mut=track, gps_pos=repl, gps_weight=repl,
            pose_prior=repl, pose_prior_weight=repl, gps_triple=repl,
            gps_triple_weight=repl)
        lm_step = jax.jit(jax.shard_map(
            step, mesh=mesh, in_specs=(spec, repl), out_specs=spec))
    else:
        @jax.jit
        def lm_step(problem, lam):
            d_pose, d_intr, d_pt = _assemble_and_solve(problem, lam, cfg)
            return problem._replace(poses=problem.poses + d_pose,
                                    intrs=problem.intrs + d_intr,
                                    points=problem.points + d_pt)

    lam = jnp.float32(1e-3)
    jax.block_until_ready(lm_step(prob, lam))
    t0 = time.perf_counter()
    cur = prob
    for _ in range(min(iters, 4)):
        cur = lm_step(cur, lam)
    jax.block_until_ready(cur)
    return min(iters, 4) / (time.perf_counter() - t0)


def bench_matching(n_kp=8192, n_pairs=32, iters=6):
    """Pairs/s of full ratio-test matching as the match graph runs it
    (matching.match_pairs_batch: the Triton 2-NN on a GPU), at the default
    keypoint budget and the match-graph verify batch of 32 pairs.

    Descriptors are non-negative L2-normalized (SIFT descriptors are
    non-negative; the reference quantizes them to uint8,
    feature_extractor_vl_sift.cpp:202)."""
    import jax
    import jax.numpy as jnp
    from metricsfm_tpu.ops import matching

    rng = np.random.default_rng(0)
    d = np.abs(rng.normal(size=(2, n_pairs, n_kp, 128))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d1, d2 = jnp.asarray(d[0]), jnp.asarray(d[1])
    m = jnp.ones((n_pairs, n_kp), bool)
    jax.block_until_ready(matching.match_pairs_batch(d1, d2, m, m))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = matching.match_pairs_batch(d1, d2, m, m)
    jax.block_until_ready(out)
    return n_pairs * iters / (time.perf_counter() - t0)


def bench_sift(H=1536, W=2048, iters=6):
    """Images/s of full SIFT extraction (pyramid + DoG + orientation +
    descriptors) at the reference working resolution (2000x1500 default,
    basic_structs.h:155)."""
    import jax
    import jax.numpy as jnp
    from metricsfm_tpu.ops import sift

    from metricsfm_tpu.utils import synth
    rng = np.random.default_rng(0)
    # textured fixture, not uniform noise: multi-scale structure exercises
    # the realistic DoG/top-k load
    tex = synth.multiscale_texture(rng, 1024)
    img = jnp.asarray(np.tile(tex, (-(-H // 1024), -(-W // 1024)))[:H, :W])
    extract = jax.jit(sift.extract)
    jax.block_until_ready(extract(img))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = extract(img)
    jax.block_until_ready(out)
    return iters / (time.perf_counter() - t0)


def bench_sgm(H=512, W=640, max_disp=128, iters=10):
    """Megapixels/s of full SGM stereo (census + 8-path + WTA + median +
    LR check) at the reference disparity size."""
    import jax
    import jax.numpy as jnp
    from metricsfm_tpu.ops import sgm

    rng = np.random.default_rng(0)
    L = jnp.asarray(rng.uniform(0, 1, size=(H, W)).astype(np.float32))
    R = jnp.asarray(rng.uniform(0, 1, size=(H, W)).astype(np.float32))
    jax.block_until_ready(sgm.stereo_sgm(L, R, max_disp=max_disp))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = sgm.stereo_sgm(L, R, max_disp=max_disp)
    jax.block_until_ready(out)
    return iters * H * W / 1e6 / (time.perf_counter() - t0)


def bench_e2e(n_cams=8, width=1024, height=768, max_kp=4096):
    """Images/s of the FULL pipeline (decode -> SIFT -> exhaustive matching
    -> incremental reconstruction) on a rendered synthetic scene with known
    ground truth; the run is only counted if it actually reconstructs
    (ATE < 5% and all cameras registered).  This is the reference's
    documented end-to-end usage (test_sfm.cc:22-73)."""
    import dataclasses
    import shutil
    import tempfile

    from metricsfm_tpu.config import PRESETS
    from metricsfm_tpu.models.database import Database
    from metricsfm_tpu.models.incremental import IncrementalSfM
    from metricsfm_tpu.models.match_graph import build_match_graph
    from metricsfm_tpu.ops import np_geom
    from metricsfm_tpu.utils import synth

    scene = synth.render_scene(seed=0, n_cams=n_cams, width=width,
                               height=height, focal=1.1 * width)
    cfg = PRESETS["web"]()
    cfg = dataclasses.replace(
        cfg,
        database=dataclasses.replace(cfg.database, resize=False,
                                     max_keypoints=max_kp),
        graph=dataclasses.replace(cfg.graph, matching_type="all"))

    def run_once():
        fold = tempfile.mkdtemp(prefix="mtpu_bench_e2e_")
        try:
            synth.write_scene_images(fold, scene)
            t0 = time.perf_counter()
            db = Database(fold, cfg.database)
            db.feature_extraction()
            matches = build_match_graph(db, cfg)
            feats = {i: db.features(i) for i in range(db.n_images)}
            scenes = IncrementalSfM(feats, matches, cfg).run()
            dt = time.perf_counter() - t0
            best = (max(scenes, key=lambda s: len(s.registered))
                    if scenes else None)
            if best is None or len(best.registered) != n_cams:
                return -1.0
            est = np.stack([np_geom.camera_center(best.poses[i])
                            for i in best.registered])
            if synth.ate_vs_gt(est, scene["centers"][best.registered]) > 0.05:
                return -1.0
            return n_cams / dt
        finally:
            shutil.rmtree(fold, ignore_errors=True)

    # warmup run compiles every stage (persistent cache helps across
    # processes but code edits invalidate entries); the timed run measures
    # steady-state pipeline throughput on a fresh store
    if run_once() < 0:
        return -1.0
    return run_once()


def bench_e2e_aerial(rows=10, cols=20, width=640, height=480, max_kp=2048):
    """Images/s of the full pipeline on an aerial survey (BASELINE configs
    3-4 shape: lawnmower grid, GPS-priori candidate selection — the
    reference's documented 1k-image aerial workload, README.md +
    initial_matching_graph.cc:83-162).  rows x cols = 200 is the
    correctness-gate run; 20x25=500 and 25x40=1000 are the BASELINE
    config-3/4 north-star scales.

    Unlike bench_e2e (8 images, exhaustive matching), this is the scale
    probe: O(n) candidate pairs via GPS mutual-kNN, incremental driver at
    rows*cols registrations.  Counted only if >= 95% of cameras register
    into one model with ATE < 5%.  Returns (images_per_s, stage_seconds,
    registered_frac, ate) — the stage table is emitted in the bench JSON
    so the dominant cost is pinned.
    """
    import dataclasses
    import shutil
    import tempfile

    from metricsfm_tpu.config import PRESETS
    from metricsfm_tpu.models.database import Database
    from metricsfm_tpu.models.incremental import IncrementalSfM
    from metricsfm_tpu.models.match_graph import build_match_graph
    from metricsfm_tpu.ops import np_geom
    from metricsfm_tpu.utils import synth
    from metricsfm_tpu.utils.tracing import GLOBAL_TRACER

    n_cams = rows * cols
    scene = synth.render_aerial(seed=0, rows=rows, cols=cols, width=width,
                                height=height)
    cfg = PRESETS["uav"]()
    cfg = dataclasses.replace(
        cfg,
        database=dataclasses.replace(cfg.database, resize=False,
                                     max_keypoints=max_kp),
        graph=dataclasses.replace(cfg.graph, matching_type="priori"))

    fold = tempfile.mkdtemp(prefix="mtpu_bench_aerial_")
    base = dict(GLOBAL_TRACER.totals)
    try:
        synth.write_scene_images(fold, scene)
        t0 = time.perf_counter()
        # the same stage spans as the CLI (cli.py)
        with GLOBAL_TRACER.span("sfm/feature_extraction"):
            db = Database(fold, cfg.database)
            db.feature_extraction()
        with GLOBAL_TRACER.span("sfm/match_graph"):
            matches = build_match_graph(db, cfg,
                                        priori_utm=scene["centers"][:, :2])
        with GLOBAL_TRACER.span("sfm/assemble_inputs"):
            feats = {i: db.features(i) for i in range(db.n_images)}
        scenes = IncrementalSfM(feats, matches, cfg).run()
        dt = time.perf_counter() - t0
    finally:
        shutil.rmtree(fold, ignore_errors=True)
    stages = {k: round(v - base.get(k, 0.0), 2)
              for k, v in GLOBAL_TRACER.totals.items()
              if v - base.get(k, 0.0) > 0.05}
    best = max(scenes, key=lambda s: len(s.registered)) if scenes else None
    if best is None:
        return -1.0, stages, 0.0, -1.0
    reg = sorted(best.registered)
    frac = len(reg) / n_cams
    est = np.stack([np_geom.camera_center(best.poses[i]) for i in reg])
    ate = synth.ate_vs_gt(est, scene["centers"][reg])
    ips = n_cams / dt if (frac >= 0.95 and ate < 0.05) else -1.0
    return ips, stages, frac, float(ate)


SKIPPED = -2.0   # bench not run: budget exhausted (vs -1.0 = ran, failed)


def main():
    import sys

    import jax
    from metricsfm_tpu.utils.cache import enable_compilation_cache
    from metricsfm_tpu.utils.device import card_line, require_gpu

    dev = require_gpu("bench.py")
    enable_compilation_cache()

    budget = float(os.environ.get("BENCH_BUDGET_S", "3300"))
    t_start = time.monotonic()

    baseline_ba_its = 10.0   # Ceres DENSE_SCHUR 1-thread CPU proxy
    baseline_ba_1k = 1.0     # Ceres SPARSE_SCHUR multicore midpoint
    out = {
        "metric": "ba_iterations_per_s",
        "value": SKIPPED,
        "unit": "LM iterations/s (64 cams, 16k pts, 6 views)",
        "vs_baseline": SKIPPED,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "n_devices": jax.device_count(),
        "card": card_line(),
        "bench_budget_s": budget,
        "skipped_budget": [],
    }

    def emit():
        out["bench_elapsed_s"] = round(time.monotonic() - t_start, 1)
        print(json.dumps(out), flush=True)

    def left():
        return budget - (time.monotonic() - t_start)

    def gate(name: str, est_s: float) -> bool:
        """True if `name` fits the remaining budget; records the skip."""
        if left() >= est_s:
            return True
        out["skipped_budget"].append(name)
        print(f"# skip {name}: est {est_s:.0f}s > remaining {left():.0f}s",
              file=sys.stderr, flush=True)
        return False

    # ---- kernel benches (cheap; every one must land in the record) ----
    if gate("ba", 90):
        try:
            ba_its = bench_ba()
        except Exception:
            ba_its = -1.0
        out["value"] = round(ba_its, 3)
        out["vs_baseline"] = round(ba_its / baseline_ba_its, 3)
        emit()

    if gate("matching", 90):
        try:
            out["matched_pairs_per_s"] = round(bench_matching(), 3)
        except Exception:
            out["matched_pairs_per_s"] = -1.0
        emit()

    if gate("sift", 90):
        try:
            out["sift_images_per_s"] = round(bench_sift(), 3)
        except Exception:
            out["sift_images_per_s"] = -1.0
        emit()

    if gate("sgm", 120):
        try:
            out["sgm_megapixels_per_s"] = round(bench_sgm(), 3)
        except Exception:
            out["sgm_megapixels_per_s"] = -1.0
        emit()

    # ---- 1k-camera BA (north-star solver scale) ----
    if gate("ba_1k", 240):
        try:
            ba_1k = bench_ba_1k()
        except Exception:
            ba_1k = -1.0
        out["ba_iterations_per_s_1k"] = round(ba_1k, 3)
        out["ba_1k_vs_ceres_sparse_schur"] = round(ba_1k / baseline_ba_1k, 3)
        emit()
    if gate("ba_1k_fixed50", 120):
        try:
            out["ba_iterations_per_s_1k_fixed50"] = round(
                bench_ba_1k(production=False), 3)
        except Exception:
            out["ba_iterations_per_s_1k_fixed50"] = -1.0
        emit()
    # sharded key is a SCALING datum: only meaningful on >1 device
    if jax.device_count() > 1 and gate("ba_1k_sharded", 240):
        try:
            out["ba_iterations_per_s_1k_sharded"] = round(
                bench_ba_1k(sharded=True), 3)
        except Exception:
            out["ba_iterations_per_s_1k_sharded"] = -1.0
        emit()

    # ---- end-to-end: 8-image web set (+ reference-resolution variant) ----
    if gate("e2e", 240):
        try:
            out["e2e_images_per_s"] = round(bench_e2e(), 3)
        except Exception:
            out["e2e_images_per_s"] = -1.0
        emit()
    if gate("e2e_hires", 420):
        try:
            out["e2e_images_per_s_hires"] = round(
                bench_e2e(width=2000, height=1500, max_kp=8192), 3)
        except Exception:
            out["e2e_images_per_s_hires"] = -1.0
        emit()

    # ---- aerial e2e: warm, then 200 / 500 / 1k (BASELINE configs 3-4) ----
    # warmup run (12 images) populates the compile cache so the timed runs
    # measure pipeline throughput, not compile state;
    # its wall time is recorded as the compile-cost key
    if gate("e2e_aerial_warm", 300):
        t_w = time.monotonic()
        try:
            bench_e2e_aerial(rows=3, cols=4)
        except Exception:
            pass
        out["e2e_aerial_warm_s"] = round(time.monotonic() - t_w, 1)
        emit()

    rate = 0.0   # measured img/s at 200, reused to size the scale runs
    if gate("e2e_200", 700):
        try:
            e2e200, st200, reg200, ate200 = bench_e2e_aerial()
        except Exception:
            e2e200, st200, reg200, ate200 = -1.0, {}, 0.0, -1.0
        out["e2e_images_per_s_200"] = round(e2e200, 3)
        out["e2e_200_registered_frac"] = round(reg200, 3)
        out["e2e_200_ate"] = round(ate200, 4)
        out["e2e_200_stages_s"] = st200
        rate = max(e2e200, 0.0)
        emit()

    # scale keys: estimated from the measured 200-image rate (x1.5 margin
    # for super-linear stages); never started unless they fit
    est500 = 500 / rate * 1.5 if rate > 0 else float("inf")
    if gate("e2e_500", est500):
        try:
            e2e500, st500, reg500, ate500 = bench_e2e_aerial(rows=20,
                                                             cols=25)
        except Exception:
            e2e500, st500, reg500, ate500 = -1.0, {}, 0.0, -1.0
        out["e2e_images_per_s_500"] = round(e2e500, 3)
        out["e2e_500_registered_frac"] = round(reg500, 3)
        out["e2e_500_ate"] = round(ate500, 4)
        out["e2e_500_stages_s"] = st500
        emit()

    est1k = 1000 / rate * 1.5 if rate > 0 else float("inf")
    if gate("e2e_1k", est1k):
        try:
            e2e1k, st1k, reg1k, ate1k = bench_e2e_aerial(rows=25, cols=40)
        except Exception:
            e2e1k, st1k, reg1k, ate1k = -1.0, {}, 0.0, -1.0
        out["e2e_images_per_s_1k"] = round(e2e1k, 3)
        out["e2e_1k_registered_frac"] = round(reg1k, 3)
        out["e2e_1k_ate"] = round(ate1k, 4)
        out["e2e_1k_stages_s"] = st1k
        emit()

    emit()


if __name__ == "__main__":
    main()
