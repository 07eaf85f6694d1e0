"""Smoke run of MetricSfM's main path on NVIDIA GPUs, in one process.

    python chip_smoke.py                # phases a-e on one card
    python chip_smoke.py --four-cards   # the multi-device path on 4 cards only
    python chip_smoke.py --rehearse [--four-cards]
        # the same phases on the CPU at tiny sizes; never prints the ok line

Phases (one card):
  a. device: JAX's first device must be a GPU (utils/device.py); card
     name and power limit.
  b. kernel parity at real widths: the 2-NN as the pipeline runs it (the
     Triton kernel) against an f32 numpy brute force; SGM and two LM
     solves on the GPU against the same jitted code on the CPU device.
  c. sparse main path: `cli.main(["sfm", ..., "--mode", "uav"])` on a
     rendered 6 x 8 aerial survey at 2,000 x 1,500, gated on registration
     and ATE.
  d. dense path: `cli.main(["dense", ..., "--disp", "128"])` over the first
     4 consecutive pairs of phase c's model.
  e. the tests marked `gpu`, through pytest.main in this process.
With --four-cards: phase c's survey with the match graph sharded over 4
cards, the same run on a 1-device mesh, and the track-sharded LM against
one card.

Every phase prints its cold wall time (set-up, compilation included, not a
measurement) and its gates.  Any failed phase makes the exit code 1.  The
last line of a passing run is one JSON object with the device JAX reports.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, ".smoke_out")


class _Gates:
    """Named checks of one phase; printed, and failed as a whole."""

    def __init__(self):
        self.failed = []

    def check(self, name: str, value, ok: bool):
        print(f"  gate {name}: {value} -> {'pass' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            self.failed.append(name)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


# ---------------------------------------------------------------- phase b --

def phase_kernels(jax, g: _Gates, small: bool):
    import jax.numpy as jnp

    from metricsfm_tpu.ba.lm import LMConfig, solve_lm
    from metricsfm_tpu.ops import matching, sgm
    from metricsfm_tpu.utils import synth

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(0)

    # 2-NN at the default keypoint budget (config.py: 8,192) and half it.
    # Queries are noisy copies of database rows with a median distance
    # ratio d1/d2 of ~0.5, like matches that pass the reference's 0.6/0.85
    # ratio tests, so the best neighbour is defined; ties then come only
    # from bf16.
    for n in ((512,) if small else (4096, 8192)):
        d2 = np.abs(rng.normal(size=(n, 128))).astype(np.float32)
        d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
        d1 = d2[rng.permutation(n)] + 0.05 * np.abs(
            rng.normal(size=(n, 128)))
        d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(
            np.float32)
        g1, g2, gi = (np.asarray(x) for x in jax.jit(matching.nearest2)(
            jnp.asarray(d1), jnp.asarray(d2)))
        rows = rng.choice(n, size=512, replace=False)
        sim = d1[rows] @ d2.T
        order = np.argsort(-sim, axis=1)
        r = np.arange(len(rows))
        want1 = 2 - 2 * sim[r, order[:, 0]]
        want2 = 2 - 2 * sim[r, order[:, 1]]
        # bf16 operands: near-ties may flip the best index
        g.check(f"knn2_{n}x{n}x128 best-index agreement",
                float((gi[rows] == order[:, 0]).mean()),
                float((gi[rows] == order[:, 0]).mean()) >= 0.999)
        # bf16 operands with f32 accumulation: ~2^-9 relative error on s
        err = max(np.abs(g1[rows] - want1).max(),
                  np.abs(g2[rows] - want2).max())
        g.check(f"knn2_{n}x{n}x128 max |d^2 error|", float(err), err <= 2e-2)

    # SGM: integer aggregation, so the GPU must reproduce the CPU exactly
    H, W, D = (48, 64, 32) if small else (512, 640, 128)
    tex = synth.multiscale_texture(rng, 1024)[:H, :W + 24]
    left = jnp.asarray(tex[:, 24:])
    right = jnp.asarray(tex[:, :W])             # ~24 px of true disparity

    def sgm_on(dev, subpixel):
        with jax.default_device(dev):
            out = sgm.stereo_sgm(jax.device_put(left, dev),
                                 jax.device_put(right, dev), max_disp=D,
                                 subpixel=subpixel)
            return [np.asarray(x) for x in out]

    gi_d, gi_v = sgm_on(jax.devices()[0], False)
    ci_d, ci_v = sgm_on(cpu, False)
    g.check(f"sgm {H}x{W} D={D} valid share", float(gi_v.mean()),
            gi_v.mean() > 0)
    g.check("sgm integer disparity == cpu",
            int((gi_d != ci_d).sum()), np.array_equal(gi_d, ci_d))
    g.check("sgm valid mask == cpu", int((gi_v != ci_v).sum()),
            np.array_equal(gi_v, ci_v))
    gs_d, gs_v = sgm_on(jax.devices()[0], True)
    cs_d, cs_v = sgm_on(cpu, True)
    both = gs_v & cs_v
    # the parabola divides small integers; only rounding of the division
    # can differ between the two backends
    err = float(np.abs(gs_d - cs_d)[both].max()) if both.any() else 0.0
    g.check("sgm subpixel max |gpu - cpu|", err, err <= 1e-4)
    g.check("sgm subpixel valid mask == cpu", int((gs_v != cs_v).sum()),
            np.array_equal(gs_v, cs_v))

    # BA: the same 2 LM iterations on the GPU and on the CPU device
    print(f"  matmul precision in force: "
          f"{jax.config.jax_default_matmul_precision}", flush=True)
    cases = [("dense Schur", (16, 2048) if small else (64, 16384),
              LMConfig(max_iterations=2, cg_iterations=0)),
             ("matrix-free CG", (128, 8192) if small else (1024, 131072),
              LMConfig(max_iterations=2, cg_iterations=50, cg_tol=1e-4))]
    for name, (n_cams, n_pts), cfg in cases:
        prob = synth.synthetic_ba_problem(n_cams=n_cams, n_pts=n_pts, seed=0)
        costs = []
        for dev in (jax.devices()[0], cpu):
            with jax.default_device(dev):
                _, info = solve_lm(jax.device_put(prob, dev), cfg)
                costs.append(float(info["final_cost"]))
        g.check(f"lm {name} {n_cams} cams/{n_pts} pts final cost "
                f"gpu {costs[0]:.6g} vs cpu {costs[1]:.6g}, rel diff",
                _rel(*costs), _rel(*costs) <= 1e-3)


# ---------------------------------------------------------------- phase c --

def _survey(small: bool):
    from metricsfm_tpu.utils import synth
    if small:
        return synth.render_aerial(seed=0, rows=2, cols=3, width=640,
                                   height=480)
    # the reference's working size (config.py size_image), inside the uav
    # preset's 4000 x 3000, so the pipeline does not resize
    return synth.render_aerial(seed=0, rows=6, cols=8, width=2000,
                               height=1500)


def _sfm_args(small: bool):
    return ["--max-kp", "1024"] if small else []


def _check_model(g: _Gates, scenes, scene_gt, tag: str):
    from metricsfm_tpu.ops import np_geom
    from metricsfm_tpu.utils import synth
    n = len(scene_gt["centers"])
    best = max(scenes, key=lambda s: len(s.registered)) if scenes else None
    reg = sorted(best.registered) if best is not None else []
    g.check(f"{tag} registered into one model", f"{len(reg)}/{n}",
            len(reg) >= 0.95 * n)
    ate = float("inf")
    if len(reg) >= 3:
        est = np.stack([np_geom.camera_center(best.poses[i]) for i in reg])
        ate = synth.ate_vs_gt(est, scene_gt["centers"][reg])
    g.check(f"{tag} ATE / trajectory extent", ate, ate < 0.05)
    return len(reg)


def phase_sfm(jax, g: _Gates, small: bool):
    from metricsfm_tpu import cli
    from metricsfm_tpu.utils import synth

    scene = _survey(small)
    img_dir = os.path.join(OUT, "survey")
    shutil.rmtree(img_dir, ignore_errors=True)
    synth.write_scene_images(img_dir, scene)
    sfm_out = os.path.join(OUT, "sfm")
    shutil.rmtree(sfm_out, ignore_errors=True)
    n = len(scene["centers"])
    h, w = scene["images"].shape[1:]
    print(f"  survey: {n} images at {w}x{h}", flush=True)
    scenes = cli.main(["sfm", img_dir, "--mode", "uav", "--out", sfm_out]
                      + _sfm_args(small))
    _check_model(g, scenes, scene, "sfm")
    return sfm_out


# ---------------------------------------------------------------- phase d --

def phase_dense(jax, g: _Gates, small: bool, sfm_out: str):
    from metricsfm_tpu import cli

    model = os.path.join(sfm_out, "model_0")
    with open(os.path.join(model, "sfm_sure.txt")) as f:
        lines = f.read().splitlines()
    # 8 header lines, then 9 lines per camera: keep 5 cameras = 4 pairs
    pose_file = os.path.join(OUT, "sure_first5.txt")
    with open(pose_file, "w") as f:
        f.write("\n".join(lines[:8 + 5 * 9]) + "\n")
    fold = os.path.join(model, "undistort_images")
    shutil.rmtree(os.path.join(fold, "dense"), ignore_errors=True)
    cli.main(["dense", fold, "--pose-file", pose_file,
              "--disp", "32" if small else "128"])
    for i in range(4):
        depth = np.load(os.path.join(fold, "dense", f"depth_{i}.npy"))
        g.check(f"dense pair {i} {depth.shape[1]}x{depth.shape[0]} "
                f"depth finite", bool(np.isfinite(depth).all()),
                bool(np.isfinite(depth).all()))
        share = float((depth > 0).mean())
        g.check(f"dense pair {i} valid-pixel share", share, share > 0)


# ---------------------------------------------------------------- phase e --

class _Outcomes:
    def __init__(self):
        self.counts = {"passed": 0, "failed": 0, "skipped": 0}

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.counts[report.outcome] = self.counts.get(report.outcome,
                                                          0) + 1


def phase_gpu_tests(jax, g: _Gates, small: bool):
    import pytest
    outcomes = _Outcomes()
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(REPO, "tests")], plugins=[outcomes])
    g.check("pytest -m gpu exit code", int(rc), int(rc) == 0)
    g.check("gpu tests passed / failed",
            f"{outcomes.counts['passed']} / {outcomes.counts['failed']}",
            outcomes.counts["failed"] == 0
            and (small or outcomes.counts["passed"] > 0))


# ------------------------------------------------------------ four cards --

def phase_four_cards(jax, g: _Gates, small: bool):
    from jax.sharding import Mesh

    from metricsfm_tpu import cli
    from metricsfm_tpu.ba.lm import LMConfig, solve_lm
    from metricsfm_tpu.config import PRESETS
    from metricsfm_tpu.io import store as fstore
    from metricsfm_tpu.models.database import Database
    from metricsfm_tpu.models.incremental import IncrementalSfM
    from metricsfm_tpu.models.match_graph import build_match_graph
    from metricsfm_tpu.parallel import make_mesh
    from metricsfm_tpu.parallel.sharded_ba import solve_lm_sharded
    from metricsfm_tpu.utils import synth

    g.check("visible devices", jax.device_count(), jax.device_count() == 4)
    scene = _survey(small)
    img_dir = os.path.join(OUT, "survey")
    shutil.rmtree(img_dir, ignore_errors=True)
    synth.write_scene_images(img_dir, scene)

    # the CLI shards the match graph over every visible device
    out4 = os.path.join(OUT, "sfm_4")
    shutil.rmtree(out4, ignore_errors=True)
    scenes4 = cli.main(["sfm", img_dir, "--mode", "uav", "--out", out4]
                       + _sfm_args(small))
    reg4 = _check_model(g, scenes4, scene, "4-device sfm")

    # the same composition as cli.cmd_sfm, with a 1-device mesh; feature
    # extraction never shards, so its records are reused (match shards and
    # models are not)
    out1 = os.path.join(OUT, "sfm_1")
    shutil.rmtree(out1, ignore_errors=True)
    os.makedirs(out1)
    for name in os.listdir(out4):
        if "_feature." in name:
            shutil.copy2(os.path.join(out4, name), out1)
    cfg = PRESETS["uav"]()
    if small:
        import dataclasses
        cfg = dataclasses.replace(cfg, database=dataclasses.replace(
            cfg.database, max_keypoints=1024))
    db = Database(img_dir, cfg.database, output_fold=out1)
    db.feature_extraction()
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("data",))
    matches = build_match_graph(db, cfg, mesh=mesh1)
    feats = {i: db.features(i) for i in range(db.n_images)}
    scenes1 = IncrementalSfM(feats, matches, cfg).run()
    reg1 = _check_model(g, scenes1, scene, "1-device sfm")
    g.check("registered 4-device == 1-device", f"{reg4} vs {reg1}",
            reg4 == reg1)

    m4 = fstore.read_match_graph(out4) or {}
    m1 = fstore.read_match_graph(out1) or {}
    pairs = sorted(set(m4) | set(m1))
    same = sum(m4.get(p, 0) == m1.get(p, 0) for p in pairs)
    # RANSAC draws may differ where the batch padding differs
    frac = same / max(len(pairs), 1)
    g.check(f"per-pair verified matches equal ({len(pairs)} pairs)", frac,
            frac >= 0.99)

    n_cams, n_pts = (128, 8192) if small else (1024, 131072)
    prob = synth.synthetic_ba_problem(n_cams=n_cams, n_pts=n_pts, seed=0)
    cfg_lm = LMConfig(max_iterations=2, cg_iterations=50, cg_tol=1e-4)
    _, info4 = solve_lm_sharded(prob, make_mesh(4), cfg_lm)
    _, info1 = solve_lm(prob, cfg_lm)
    c4, c1 = float(info4["final_cost"]), float(info1["final_cost"])
    g.check(f"sharded lm {n_cams} cams/{n_pts} pts final cost "
            f"4-device {c4:.6g} vs 1-device {c1:.6g}, rel diff",
            _rel(c4, c1), _rel(c4, c1) <= 1e-3)


# ------------------------------------------------------------------ main --

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card multi-device phase")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at tiny sizes; never reports ok")
    args = ap.parse_args(argv)

    import jax
    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
        if args.four_cards:
            jax.config.update("jax_num_cpu_devices", 4)
    else:
        # the CPU backend stays available for the parity references
        jax.config.update("jax_platforms", "cuda,cpu")
        from metricsfm_tpu.utils.device import card_line, require_gpu
        require_gpu("chip_smoke")
        print(f"card: {card_line()}", flush=True)
    dev = jax.devices()[0]
    print(f"device_kind: {dev.device_kind}  device_count: "
          f"{jax.device_count()}", flush=True)

    from metricsfm_tpu.utils.cache import enable_compilation_cache
    print(f"compile cache: {enable_compilation_cache()}", flush=True)
    os.makedirs(OUT, exist_ok=True)

    small = args.rehearse
    if args.four_cards:
        phases = [("four cards", lambda g: phase_four_cards(jax, g, small))]
    else:
        sfm_out = []
        phases = [
            ("b kernels", lambda g: phase_kernels(jax, g, small)),
            ("c sfm", lambda g: sfm_out.append(phase_sfm(jax, g, small))),
            ("d dense", lambda g: phase_dense(jax, g, small, sfm_out[0])),
            ("e gpu tests", lambda g: phase_gpu_tests(jax, g, small)),
        ]
    failed = []
    for name, fn in phases:
        print(f"== phase {name}", flush=True)
        g = _Gates()
        t0 = time.perf_counter()
        try:
            fn(g)
        except Exception:
            traceback.print_exc()
            g.failed.append("raised")
        print(f"== phase {name}: {'FAIL' if g.failed else 'pass'}; "
              f"cold wall {time.perf_counter() - t0:.1f} s (set-up, "
              f"compilation included)", flush=True)
        if g.failed:
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}", flush=True)
        return 1
    if args.rehearse:
        print("chip_smoke: rehearsal passed (CPU; no device result)")
        return 0
    print(f"card: {card_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
