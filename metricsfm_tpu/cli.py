"""Command-line entry points.

Replaces the reference's manual driver executables
(SfM/test/test_sfm/test_sfm.cc, test_slam, test_dense, test_calib —
hard-coded-path main()s) with one CLI:

  python -m metricsfm_tpu.cli sfm   <image_fold> [--mode web|uav] [--out DIR]
  python -m metricsfm_tpu.cli slam  <fold>       (KeyFramePts.txt/pos.txt/rgb.txt)
  python -m metricsfm_tpu.cli dense <fold>       [--pose-file sfm_sure.txt]
  python -m metricsfm_tpu.cli calib <video> <out_fold> [--frame-step N]
"""
from __future__ import annotations

import argparse
import os
import sys


def cmd_sfm(args):
    import dataclasses

    from .config import PRESETS
    from .models.database import Database
    from .models.match_graph import build_match_graph
    from .models.incremental import IncrementalSfM
    from .io import exports
    from .utils.tracing import GLOBAL_TRACER, span

    cfg = PRESETS[args.mode]()
    # optional overrides (small test scenes / CPU runs)
    if getattr(args, "max_kp", 0):
        cfg = dataclasses.replace(cfg, database=dataclasses.replace(
            cfg.database, max_keypoints=args.max_kp))
    if getattr(args, "no_resize", False):
        cfg = dataclasses.replace(cfg, database=dataclasses.replace(
            cfg.database, resize=False))
    if getattr(args, "matching", None):
        cfg = dataclasses.replace(cfg, graph=dataclasses.replace(
            cfg.graph, matching_type=args.matching))
    db = Database(args.fold, cfg.database, output_fold=args.out)
    print(f"{db.n_images} images")
    with span("sfm/feature_extraction", block_jax=True):
        db.feature_extraction(verbose=True)
    with span("sfm/match_graph", block_jax=True):
        matches = build_match_graph(
            db, cfg, verbose=True,
            debug_render_dir=(os.path.join(db.out, "match_renders")
                              if getattr(args, "debug_matches", False)
                              else None))
    feats = {i: db.features(i) for i in range(db.n_images)}
    with span("sfm/reconstruct", block_jax=True):
        sfm = IncrementalSfM(feats, matches, cfg)
        scenes = sfm.run(verbose=True)
    for k, scene in enumerate(scenes):
        fold = os.path.join(db.out, f"model_{k}")
        os.makedirs(fold, exist_ok=True)
        kp_xy = {i: feats[i].xy for i in scene.registered}
        with span("sfm/exports"):
            exports.write_cams_points(fold, scene)
            exports.write_point_cloud(os.path.join(fold, "cloud.txt"), scene)
            exports.write_bundler(os.path.join(fold, "bundle.rd.out"), scene,
                                  kp_xy)
            exports.write_cmvs(os.path.join(fold, "cmvs"), scene, kp_xy)
            names = {i: os.path.basename(db.image_paths[i])
                     for i in scene.registered}
            principal = {i: (feats[i].width / 2.0, feats[i].height / 2.0)
                         for i in scene.registered}
            sizes = {i: (feats[i].width, feats[i].height)
                     for i in scene.registered}
            exports.write_openmvs(os.path.join(fold, "sfm_openmvs.txt"),
                                  scene, kp_xy, names, principal, sizes)
            exports.write_sure(os.path.join(fold, "sfm_sure.txt"), scene,
                               names, principal, sizes)
            exports.write_undistorted_images(
                os.path.join(fold, "undistort_images"), scene,
                {i: db.image_paths[i] for i in scene.registered})
        print(f"model {k}: {len(scene.registered)} cams, "
              f"{scene.n_points()} points -> {fold}")
    print("-- stage times --")
    print(GLOBAL_TRACER.report())
    return scenes


def cmd_slam(args):
    from .config import street_preset
    from .models.slam_gps import SLAMGPS
    from .utils.tracing import GLOBAL_TRACER, span

    pipe = SLAMGPS(street_preset())
    with span("slam/run", block_jax=True):
        scene = pipe.run(args.fold, verbose=True)
    print(f"{len(scene.registered)} cams, {scene.n_points()} points")
    print("-- stage times --")
    print(GLOBAL_TRACER.report())


def cmd_dense(args):
    from .config import DenseOptions
    from .models.dense import DenseReconstruction
    from .utils.tracing import GLOBAL_TRACER, span

    dr = DenseReconstruction(DenseOptions(disp_size=args.disp,
                                          method=args.method))
    with span("dense/run", block_jax=True):
        clouds = dr.run(args.fold, pose_file=args.pose_file, verbose=True)
    print("-- stage times --")
    print(GLOBAL_TRACER.report())
    return clouds


def cmd_calib(args):
    """Video -> frames + self-calibrating SfM run (ref test_calib.cc:31-140)."""
    os.makedirs(args.out, exist_ok=True)
    try:
        import cv2
    except ImportError:
        sys.exit("calib requires cv2 for video decoding")
    cap = cv2.VideoCapture(args.video)
    i = saved = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        if i % args.frame_step == 0:
            cv2.imwrite(os.path.join(args.out, f"{saved:06d}.jpg"), frame)
            saved += 1
        i += 1
    cap.release()
    print(f"extracted {saved} frames")
    args.fold = args.out
    args.mode = "web"
    args.out = None
    cmd_sfm(args)


def main(argv=None):
    """Run one command; returns what it returns (sfm: the list of Scene
    models, dense: the per-pair point clouds)."""
    from .utils.cache import enable_compilation_cache
    enable_compilation_cache()
    p = argparse.ArgumentParser(prog="metricsfm_tpu")
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("sfm", help="incremental SfM on an image folder")
    ps.add_argument("fold")
    ps.add_argument("--mode", choices=["web", "uav"], default="web")
    ps.add_argument("--out", default=None)
    ps.add_argument("--max-kp", type=int, default=0,
                    help="override keypoint budget per image")
    ps.add_argument("--no-resize", action="store_true",
                    help="skip resize to the working resolution")
    ps.add_argument("--matching", choices=["all", "priori", "feature"],
                    default=None, help="override candidate strategy")
    ps.add_argument("--debug-matches", action="store_true",
                    help="write per-pair match renders (ref "
                    "fine_matching_graph.cc:156-180 debug blocks)")
    ps.set_defaults(fn=cmd_sfm)

    pl = sub.add_parser("slam", help="GPS-aided SLAM refinement")
    pl.add_argument("fold")
    pl.set_defaults(fn=cmd_slam)

    pd = sub.add_parser("dense", help="dense pairwise stereo")
    pd.add_argument("fold")
    pd.add_argument("--pose-file", default=None)
    pd.add_argument("--disp", type=int, default=128)
    pd.add_argument("--method", choices=["sgm", "elas"], default="sgm")
    pd.set_defaults(fn=cmd_dense)

    pc = sub.add_parser("calib", help="video -> frames -> self-calibrating SfM")
    pc.add_argument("video")
    pc.add_argument("out")
    pc.add_argument("--frame-step", type=int, default=10)
    pc.set_defaults(fn=cmd_calib)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
