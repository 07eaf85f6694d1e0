"""GPS-aided SLAM-refinement pipeline (street/GoPro-video workload).

Re-design of the reference SLAMGPS driver (SfM/src/slam_gps.{h,cc},
SURVEY.md §3.4), file-format compatible with its inputs:

  KeyFramePts.txt  — n cams (id, ts, fx fy cx cy, t, R) + n points with
                     per-view observations (slam_gps.cc:139-216); pixel obs
                     are centered at (cx, cy) and rescaled by resize_ratio.
  pos.txt          — 'id lat lon alt' GPS rows; lat/lon -> UTM, altitude
                     replaced by the track average (slam_gps.cc:218-245).
  rgb.txt          — TUM-style frame index used to associate cameras with
                     GPS rows (slam_gps.cc:247-288).

Stages: global weighted-Umeyama alignment SLAM->GPS with turn-aware
weights (slam_gps.cc:1596-1674), optional windowed re-matching +
multi-view triangulation (>=3 views), per-point IDW GPS registration
(GPSRegistration2, :917-983), GPS-anchored full BA (our Schur-LM with
camera-center anchors, weight = #reproj-residuals/#cams, z/5), accuracy
cull, and georeferenced exports with offset re-addition (Convert2GPS).
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import PipelineConfig
from ..ba import LMConfig, solve_lm
from ..io import exports
from ..ops import triangulation, umeyama
from ..utils import utm as utm_util
from .scene import CameraModel, Scene, bucket


@dataclass
class SLAMInput:
    cam_ids: np.ndarray          # (C,) original frame ids
    poses: np.ndarray            # (C, 6) world->cam [aa, t]
    f: float                     # shared focal (rescaled)
    cx: float
    cy: float
    points: np.ndarray           # (P, 3)
    obs: List[Dict[int, Tuple[float, float]]]  # per point: cam_row -> (x, y) centered


def read_slam(path: str, resize_ratio: float = 0.5) -> SLAMInput:
    """Parse KeyFramePts.txt (ref ReadinSLAM, slam_gps.cc:139-216)."""
    import jax.numpy as jnp
    from ..ops import projection

    with open(path) as f:
        tok = f.read().split()
    it = iter(tok)

    def nxt():
        return next(it)

    n = int(nxt())
    ids, poses = [], []
    fx = fy = cx = cy = 0.0
    for _ in range(n):
        ids.append(int(nxt()))
        _ts = float(nxt())
        fx, fy, cx, cy = (float(nxt()) for _ in range(4))
        t = np.array([float(nxt()) for _ in range(3)])
        R = np.array([float(nxt()) for _ in range(9)]).reshape(3, 3)
        poses.append(np.asarray(projection.pose_from_Rt(
            jnp.asarray(R), jnp.asarray(t))))
    id_to_row = {cid: r for r, cid in enumerate(ids)}

    n_pts = int(nxt())
    pts = np.zeros((n_pts, 3))
    obs: List[Dict[int, Tuple[float, float]]] = []
    for i in range(n_pts):
        pts[i] = [float(nxt()) for _ in range(3)]
        n_obs = int(nxt())
        d = {}
        for _ in range(n_obs):
            cid = int(nxt())
            px = float(nxt())
            py = float(nxt())
            if cid in id_to_row:
                # centered then rescaled (ref :199)
                d[id_to_row[cid]] = ((px - cx) / resize_ratio,
                                     (py - cy) / resize_ratio)
        obs.append(d)
    f_shared = (fx + fy) / 2.0 / resize_ratio
    return SLAMInput(cam_ids=np.array(ids), poses=np.stack(poses),
                     f=f_shared, cx=cx / resize_ratio, cy=cy / resize_ratio,
                     points=pts, obs=obs)


def read_gps(path: str, ellipsoid: int = utm_util.WGS84) -> Dict[int, Tuple[float, float, float]]:
    """Parse pos.txt -> {frame_id: (easting, northing, alt_avg)}
    (ref ReadinGPS, slam_gps.cc:218-245: altitude averaged over the track)."""
    rows = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 4:
                continue
            fid = int(parts[0])
            lat, lon, alt = map(float, parts[1:4])
            e, n, _ = utm_util.ll_to_utm(lat, lon, ellipsoid)
            rows.append((fid, e, n, alt))
    if not rows:
        return {}
    alt_avg = sum(r[3] for r in rows) / len(rows)
    return {fid: (e, n, alt_avg) for fid, e, n, _ in rows}


def read_frame_ids(path: str) -> List[int]:
    """Parse rgb.txt frame list (3 header lines; ref :247-288)."""
    out = []
    with open(path) as f:
        lines = f.read().splitlines()
    for line in lines[3:]:
        line = line.strip()
        if not line:
            break
        name = line.split("/")[-1]
        name = name.rsplit(".", 1)[0].split()[-1]
        name = name.split("/")[-1]
        try:
            out.append(int(name))
        except ValueError:
            continue
    return out


def turn_weights(gps: np.ndarray, window: int = 20, max_deg: float = 80.0
                 ) -> np.ndarray:
    """Turn-aware alignment weights w = tan(|angle - pi| clipped to 80deg)
    (ref AbsoluteOrientationWithGPSGlobal, slam_gps.cc:1601-1626)."""
    n = len(gps)
    w = np.zeros(n)
    for i in range(n):
        s = max(i - window, 0)
        e = min(i + window, n - 1)
        dxs, dys = gps[s, 0] - gps[i, 0], gps[s, 1] - gps[i, 1]
        dxe, dye = gps[e, 0] - gps[i, 0], gps[e, 1] - gps[i, 1]
        denom = math.sqrt(dxs * dxs + dys * dys + 0.1) * \
            math.sqrt(dxe * dxe + dye * dye + 0.1)
        ang = math.acos(max(-1.0, min(1.0, (dxs * dxe + dys * dye) / denom)))
        ang = abs(ang - math.pi)
        ang = min(ang, math.radians(max_deg))
        w[i] = math.tan(ang)
    return w


class SLAMGPS:
    """The SLAMGPS::Run pipeline (slam_gps.cc:63-137)."""

    def __init__(self, config: PipelineConfig, seed: int = 0, mesh=None):
        import jax
        self.cfg = config
        self.gps_offset = np.zeros(3)
        self.key = jax.random.PRNGKey(seed)
        self.mesh = mesh
        self._rematch_cache: Dict[tuple, object] = {}

    def _next_key(self):
        import jax
        self.key, sub = jax.random.split(self.key)
        return sub

    def run(self, fold: str, verbose: bool = False,
            features: Optional[Dict[int, object]] = None,
            rematch: Optional[bool] = None) -> Scene:
        """Full pipeline.  When `rematch` is enabled (or keyframe images are
        on disk and self.cfg.slam.rematch is True), keyframe features are
        extracted (ref FeatureExtraction, slam_gps.cc:290-310), re-matched
        within the +-matching_window under prior F/H gates (:312-555), and
        tracks are re-triangulated with the >=min_track_views filter
        (:557-668).  `features` may inject precomputed ImageFeatures keyed
        by camera row (tests / precomputed stores)."""
        from ..utils.tracing import span

        with span("slam/read_inputs"):
            slam = read_slam(os.path.join(fold, "KeyFramePts.txt"),
                             self.cfg.slam.resize_ratio)
            gps_info = read_gps(os.path.join(fold, "pos.txt"))
            frame_ids = read_frame_ids(os.path.join(fold, "rgb.txt"))
            # cams_gps[i] = gps of the cam's frame (ref association quirk
            # kept: index into the gps-bearing frame list by cam id)
            frames_with_gps = [fid for fid in frame_ids if fid in gps_info]
            cams_gps = np.array([gps_info[frames_with_gps[cid]]
                                 if cid < len(frames_with_gps)
                                 else gps_info[frames_with_gps[-1]]
                                 for cid in slam.cam_ids])

        scene = self._build_scene(slam)
        with span("slam/align_global", block_jax=True):
            self._align_global(scene, cams_gps, verbose)
        do_rematch = self.cfg.slam.rematch if rematch is None else rematch
        if do_rematch:
            if features is None:
                with span("slam/feature_extraction", block_jax=True):
                    features = self.feature_extraction(fold, slam, verbose)
            if features:
                with span("slam/windowed_matching", block_jax=True):
                    matches = self.feature_matching(scene, features, verbose)
                with span("slam/retriangulate", block_jax=True):
                    self.retriangulate(scene, matches, features,
                                       use_slam_pt=self.cfg.slam.use_slam_pt,
                                       verbose=verbose)
        with span("slam/gps_registration", block_jax=True):
            self._gps_registration(scene, self._cams_gps_centered)
        with span("slam/gps_bundle", block_jax=True):
            info = self._gps_bundle(scene, self._cams_gps_centered)
        if verbose:
            print("GPS BA:", {k: float(np.asarray(v)) for k, v in info.items()})
        with span("slam/accuracy_cull", block_jax=True):
            self._accuracy_cull(scene, fold)
        with span("slam/exports"):
            self._exports(fold, scene, slam)
        return scene

    # -- keyframe features + windowed matching + re-triangulation ---------
    def feature_extraction(self, fold: str, slam: SLAMInput, verbose=False):
        """SIFT over the keyframe images (ref slam_gps.cc:290-310: Database
        extraction with resize=false).  Returns {cam_row: ImageFeatures} or
        None when the image folder is absent."""
        import dataclasses
        from .database import Database

        img_fold = os.path.join(fold, "image")
        if not os.path.isdir(img_fold):
            return None
        opts = dataclasses.replace(self.cfg.database, resize=False)
        db = Database(img_fold, opts,
                      output_fold=os.path.join(fold, "feature"))
        if db.n_images == 0:
            return None
        db.feature_extraction(verbose=verbose)
        # map cam rows to database rows by keyframe name (zero-padded id)
        by_name = {os.path.basename(p).rsplit(".", 1)[0]: k
                   for k, p in enumerate(db.image_paths)}
        feats = {}
        for r, cid in enumerate(slam.cam_ids):
            k = by_name.get(str(int(cid)).zfill(6))
            if k is None:
                return None
            feats[r] = db.features(k)
        return feats

    def window_match_priors(self, scene: Scene, verbose=False):
        """Step 1 of ref FeatureMatching (slam_gps.cc:324-420): for every
        in-window pair sharing >=20 SLAM tracks, estimate a prior F
        (inliers >= max(0.5 n, 30)) and reject near-planar pairs where the
        homography explains >90% of the F inliers.  Returns
        {(i, j): (F 3x3, H 3x3)} in SLAM observation coordinates."""
        from ..ops import homography as homog, ransac

        win = self.cfg.slam.matching_window
        th_epi = self.cfg.slam.epipolar_px / self.cfg.slam.resize_ratio
        th_dist = 5.0 / self.cfg.slam.resize_ratio
        imgs = scene.registered
        C = len(imgs)
        # per-camera track lists from the SLAM scene
        cam_tracks: Dict[int, Dict[int, int]] = {i: {} for i in imgs}
        for ti, tr in enumerate(scene.tracks):
            for img, kp in tr.obs.items():
                cam_tracks[img][ti] = kp
        priors: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        for a in range(C):
            i = imgs[a]
            for b in range(max(a - win, 0), min(a + win + 1, C)):
                if b <= a:
                    continue
                j = imgs[b]
                shared = [t for t in cam_tracks[i] if t in cam_tracks[j]]
                if len(shared) < 20:
                    continue
                p1 = np.stack([self.kp_xy[i][cam_tracks[i][t]] for t in shared])
                p2 = np.stack([self.kp_xy[j][cam_tracks[j][t]] for t in shared])
                n = len(shared)
                pad = bucket(n, 64) - n
                p1p = np.pad(p1, ((0, pad), (0, 0))).astype(np.float32)
                p2p = np.pad(p2, ((0, pad), (0, 0))).astype(np.float32)
                m = np.zeros(n + pad, bool)
                m[:n] = True
                fr = ransac.fundamental_ransac(
                    jnp.asarray(p1p), jnp.asarray(p2p), self._next_key(),
                    mask=jnp.asarray(m), th_px=th_epi, min_inliers=30)
                n_f = int(fr["n_inliers"])
                if n_f < max(0.5 * n, 30):
                    continue
                hr = homog.homography_ransac(
                    jnp.asarray(p1p), jnp.asarray(p2p), self._next_key(),
                    mask=jnp.asarray(m), th_px=th_dist)
                if int(hr["n_inliers"]) > 0.9 * n_f:
                    continue  # near-planar / degenerate pair
                priors[(i, j)] = (np.asarray(fr["F"]), np.asarray(hr["H"]))
        if verbose:
            print(f"slam-gps priors: {len(priors)} windowed pairs")
        return priors

    def feature_matching(self, scene: Scene, features, verbose=False):
        """Step 2 of ref FeatureMatching (slam_gps.cc:424-553): 2-NN from
        image j's descriptors into image i (ratio 0.8), gated by the prior
        F epipolar distance and the prior-H displacement, then F-RANSAC
        geo-verification.  Returns {(i, j): (kp_i, kp_j) arrays}.

        Batched re-design: the whole chain (2-NN + gates + F-RANSAC) is ONE
        jitted vmapped dispatch per (B, N, D) pair batch over a
        device-resident feature store, not a per-pair host loop (ref
        windows span thousands of keyframes, slam_gps.cc:424-553).
        Pair batches shard over the mesh data axis when one is provided.
        """
        import jax

        priors = self.window_match_priors(scene, verbose)
        if not priors:
            return {}
        th_epi = self.cfg.slam.epipolar_px / self.cfg.slam.resize_ratio
        th_dist = 5.0 / self.cfg.slam.resize_ratio
        ratio = self.cfg.slam.ratio_video

        imgs = sorted({k for p in priors for k in p})
        row_of = {im: r for r, im in enumerate(imgs)}
        kmax = max(int(features[i].mask.shape[0]) for i in imgs)
        N = -(-kmax // 128) * 128
        D = features[imgs[0]].desc.shape[1]
        desc_all = np.zeros((len(imgs), N, D), np.float32)
        xy_all = np.zeros((len(imgs), N, 2), np.float32)
        mask_all = np.zeros((len(imgs), N), bool)
        for r, im in enumerate(imgs):
            f = features[im]
            k = f.mask.shape[0]
            desc_all[r, :k] = f.desc
            xy_all[r, :k] = f.xy
            mask_all[r, :k] = f.mask
        desc_all = jnp.asarray(desc_all)
        xy_all = jnp.asarray(xy_all)
        mask_all = jnp.asarray(mask_all)

        verify = self._rematch_verifier(ratio, th_epi, th_dist,
                                        chunk=min(2048, N))
        pair_list = sorted(priors)
        Fs = np.stack([priors[p][0] for p in pair_list]).astype(np.float32)
        Hs = np.stack([priors[p][1] for p in pair_list]).astype(np.float32)
        B = 32
        out: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}
        for b0 in range(0, len(pair_list), B):
            chunk_pairs = pair_list[b0:b0 + B]
            nb = len(chunk_pairs)
            fill = chunk_pairs + [chunk_pairs[-1]] * (B - nb)
            ii = np.array([row_of[i] for i, _ in fill], np.int32)
            jj = np.array([row_of[j] for _, j in fill], np.int32)
            Fb = np.concatenate([Fs[b0:b0 + nb]] + [Fs[b0 + nb - 1:b0 + nb]]
                                * (B - nb))
            Hb = np.concatenate([Hs[b0:b0 + nb]] + [Hs[b0 + nb - 1:b0 + nb]]
                                * (B - nb))
            keys = jax.random.split(self._next_key(), B)
            keep, idx_i, ok = verify(desc_all, xy_all, mask_all,
                                     jnp.asarray(ii), jnp.asarray(jj),
                                     jnp.asarray(Fb), jnp.asarray(Hb), keys)
            keep = np.asarray(keep)
            idx_i = np.asarray(idx_i)
            ok = np.asarray(ok)
            for b, (i, j) in enumerate(chunk_pairs):
                if not ok[b]:
                    continue
                kp_j = np.where(keep[b])[0]
                out[(i, j)] = (idx_i[b][kp_j].astype(np.int64),
                               kp_j.astype(np.int64))
                if verbose:
                    print(f"  slam match {i}-{j}: {len(kp_j)} matches")
        return out

    def _rematch_verifier(self, ratio, th_epi, th_dist, chunk: int):
        """Build (and cache) the jitted batched rematch chain."""
        import jax
        from ..ops import matching, ransac
        from ..ops import epipolar as epi_ops

        key = (ratio, th_epi, th_dist, chunk)
        if key in self._rematch_cache:
            return self._rematch_cache[key]

        def one(dj, di, mj, mi, xi, xj, F, Hm, k):
            res = matching.match_pair(dj, di, mj, mi, ratio_good=ratio,
                                      ratio_all=ratio, chunk=chunk)
            idx_i = res["idx2"]                    # per kp_j: best kp_i
            keep = res["all"]
            p1 = xi[idx_i]                         # (Kj, 2) in image i
            p2 = xj                                # (Kj, 2) in image j
            # epipolar gate vs the prior F (ref :481-489)
            keep = keep & (epi_ops.epipolar_distance(F, p1, p2) <= th_epi)
            # homography displacement gate (ref :492-499, 40*th_distance)
            ph = jnp.concatenate([p1, jnp.ones_like(p1[:, :1])], 1) @ Hm.T
            w = ph[:, 2:]
            ph2 = ph[:, :2] / jnp.where(jnp.abs(w) < 1e-9,
                                        jnp.where(w < 0, -1e-9, 1e-9), w)
            disp = jnp.linalg.norm(ph2 - p2, axis=1)
            keep = keep & (disp <= 40 * th_dist)
            # final F-RANSAC geo-verification over the gated set
            fr = ransac.fundamental_ransac(p1, p2, k, mask=keep)
            keep = keep & fr["inlier_mask"]
            ok = fr["ok"] & (jnp.sum(keep) >= 8)
            return keep & ok, idx_i, ok

        def gathered(desc, xy, mask, ii, jj, Fb, Hb, keys):
            fn = lambda i, j, F, Hm, k: one(desc[j], desc[i], mask[j],
                                            mask[i], xy[i], xy[j], F, Hm, k)
            return jax.vmap(fn)(ii, jj, Fb, Hb, keys)

        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P
            repl, spec = P(), P("data")
            gathered = jax.shard_map(
                gathered, mesh=self.mesh,
                in_specs=(repl, repl, repl, spec, spec, spec, spec, spec),
                out_specs=(spec, spec, spec))
        fn = jax.jit(gathered)
        self._rematch_cache[key] = fn
        return fn

    def retriangulate(self, scene: Scene, matches, features,
                      use_slam_pt: bool = False, verbose=False):
        """Ref Triangulation (slam_gps.cc:557-668): union tracks over the
        re-matched pairs via global keypoint ids, midpoint-triangulate, and
        keep only tracks with >= min_track_views views that pass the
        3-degree parallax and reprojection gates.  Replaces the SLAM tracks
        (or appends to them when use_slam_pt)."""
        import jax
        from ..ops import triangulation as tri

        idx_max = scene.idx_max
        pts_map: Dict[int, int] = {}
        new_tracks: List[Dict[int, int]] = []
        for (i, j), (kp_i, kp_j) in sorted(matches.items()):
            for a, b in zip(kp_i.tolist(), kp_j.tolist()):
                g1 = i * idx_max + a
                g2 = j * idx_max + b
                t1 = pts_map.get(g1)
                t2 = pts_map.get(g2)
                if t1 is not None:
                    new_tracks[t1][j] = b
                    pts_map[g2] = t1
                elif t2 is not None:
                    new_tracks[t2][i] = a
                    pts_map[g1] = t2
                else:
                    new_tracks.append({i: a, j: b})
                    pts_map[g1] = pts_map[g2] = len(new_tracks) - 1

        if not new_tracks:
            return 0
        # batched midpoint triangulation with gates (ref Trianglate2 +
        # th_tri_angle=3deg; >=min_track_views filter at :643-647)
        V = max(self.cfg.slam.min_track_views,
                max(len(t) for t in new_tracks))
        V = min(V, 16)
        T = len(new_tracks)
        poses_a = np.zeros((T, V, 6), np.float32)
        intrs_a = np.zeros((T, V, 3), np.float32)
        obs_a = np.zeros((T, V, 2), np.float32)
        mask_a = np.zeros((T, V), bool)
        model = scene.models[0]
        for ti, t in enumerate(new_tracks):
            for vi, (img, kp) in enumerate(list(t.items())[:V]):
                poses_a[ti, vi] = scene.poses[img]
                intrs_a[ti, vi] = [model.f, model.k1, model.k2]
                obs_a[ti, vi] = features[img].xy[kp]
                mask_a[ti, vi] = True
        gate = jax.vmap(lambda p, k, o, m: tri.triangulate_and_gate(
            p, k, o, m,
            th_error_px=self.cfg.sfm.th_mse_reprojection,
            th_angle_deg=self.cfg.sfm.th_angle_small))
        xyz, ok, _ = gate(jnp.asarray(poses_a), jnp.asarray(intrs_a),
                          jnp.asarray(obs_a), jnp.asarray(mask_a))
        xyz = np.asarray(xyz)
        ok = np.asarray(ok) & (mask_a.sum(1) >= self.cfg.slam.min_track_views)

        if not use_slam_pt:
            scene.reset_tracks()
            for img in scene.registered:
                scene.kp_to_track[img] = np.full(
                    len(features[img].xy), -1, np.int64)
        else:
            for img in scene.registered:
                old = scene.kp_to_track[img]
                grown = np.full(max(len(old), len(features[img].xy)), -1,
                                np.int64)
                grown[:len(old)] = old
                scene.kp_to_track[img] = grown
        n_added = 0
        for ti, t in enumerate(new_tracks):
            if ok[ti]:
                scene.add_track(xyz[ti], t)
                n_added += 1
        # downstream stages (GPS registration/BA/accuracy) now observe the
        # feature keypoints instead of the synthetic SLAM observations
        self.kp_xy = {r: np.asarray(features[r].xy, np.float64)
                      for r in scene.registered}
        if verbose:
            print(f"slam-gps retriangulation: {n_added}/{T} tracks kept "
                  f"(>= {self.cfg.slam.min_track_views} views)")
        return n_added

    # ------------------------------------------------------------------
    def _build_scene(self, slam: SLAMInput) -> Scene:
        C = len(slam.cam_ids)
        scene = Scene(C)
        mi = scene.add_camera_model(CameraModel(f=slam.f, calibrated=True))
        max_kp = max((max(d.keys(), default=0) for d in slam.obs), default=0)
        # keypoint index bookkeeping: one synthetic kp per (point, cam)
        self._kp_counter = {r: 0 for r in range(C)}
        self._kp_xy: Dict[int, list] = {r: [] for r in range(C)}
        for r in range(C):
            scene.register_image(r, slam.poses[r], mi,
                                 n_kps=len(slam.points))
        for p_idx, d in enumerate(slam.obs):
            if len(d) < 2:
                continue
            obs_map = {}
            for cam_row, (x, y) in d.items():
                kp = len(self._kp_xy[cam_row])
                self._kp_xy[cam_row].append((x, y))
                obs_map[cam_row] = kp
            scene.add_track(slam.points[p_idx], obs_map)
        # materialize kp arrays; widen kp_to_track to actual counts
        self.kp_xy = {r: np.array(self._kp_xy[r]).reshape(-1, 2)
                      for r in range(C)}
        for r in range(C):
            k2t = np.full(len(self.kp_xy[r]), -1, np.int64)
            k2t[:len(scene.kp_to_track[r])] = -1
            scene.kp_to_track[r] = k2t
        for ti, t in enumerate(scene.tracks):
            for img, kp in t.obs.items():
                scene.kp_to_track[img][kp] = ti
        return scene

    def _align_global(self, scene: Scene, cams_gps: np.ndarray, verbose):
        """Weighted similarity SLAM->GPS + offset demeaning (ref :1596-1674)."""
        import jax.numpy as jnp
        from ..ops import np_geom

        centers = np.stack([np_geom.camera_center(scene.poses[i])
                            for i in scene.registered])
        w = turn_weights(cams_gps)
        if w.sum() < 1e-9:
            w = np.ones_like(w)
        # host-side f64 demean keeps UTM-magnitude coordinates f32-safe on
        # device (x64 is disabled, so a jnp.float64 cast would silently
        # truncate — raw UTM eastings ~5e5 m only carry ~3 cm in f32):
        # align the DEMEANED clouds on device, reconstruct the full-frame
        # translation in numpy f64 afterwards.
        mc = np.asarray(centers, np.float64).mean(axis=0)
        mg = np.asarray(cams_gps, np.float64).mean(axis=0)
        s, R, t = umeyama.similarity_align(
            jnp.asarray(np.asarray(centers, np.float64) - mc, jnp.float32),
            jnp.asarray(np.asarray(cams_gps, np.float64) - mg, jnp.float32),
            weights=jnp.asarray(w, jnp.float32))
        s_, R_ = float(s), np.asarray(R, np.float64)
        t_ = np.asarray(t, np.float64) + mg - s_ * (R_ @ mc)
        # transform cameras and points
        for img in scene.registered:
            scene.poses[img] = np_geom.apply_similarity_to_pose(
                scene.poses[img], s_, R_, t_)
        for tr in scene.tracks:
            tr.xyz = s_ * R_ @ tr.xyz + t_
        # demean: subtract mean camera center; keep as gps_offset (ref :1650-1673)
        centers2 = np.stack([np_geom.camera_center(scene.poses[i])
                             for i in scene.registered])
        self.gps_offset = centers2.mean(axis=0)
        for img in scene.registered:
            scene.poses[img] = np_geom.apply_similarity_to_pose(
                scene.poses[img], 1.0, np.eye(3), -self.gps_offset)
        for tr in scene.tracks:
            tr.xyz = tr.xyz - self.gps_offset
        self._cams_gps_centered = cams_gps - self.gps_offset

    def _gps_registration(self, scene: Scene, cams_gps: np.ndarray):
        """Per-point IDW blend of per-camera GPS offsets, then snap cameras
        to GPS positions (ref GPSRegistration2, slam_gps.cc:917-983)."""
        from ..ops import np_geom

        imgs = scene.registered
        centers = {i: np_geom.camera_center(scene.poses[i]) for i in imgs}
        cam_offset = {i: cams_gps[k] - centers[i] for k, i in enumerate(imgs)}
        for tr in scene.tracks:
            if tr.is_bad:
                continue
            wsum, osum = 0.0, np.zeros(3)
            for img in tr.obs:
                d = np.linalg.norm(tr.xyz - centers[img])
                w = 1.0 / (math.sqrt(d) + 5.0)
                wsum += w
                osum += w * cam_offset[img]
            if wsum > 0:
                tr.xyz = tr.xyz + osum / wsum
        # snap each camera's center to its GPS position, keeping rotation
        for k, img in enumerate(imgs):
            scene.poses[img] = np_geom.pose_from_center(
                scene.poses[img][:3], cams_gps[k])

    def _gps_bundle(self, scene: Scene, cams_gps: np.ndarray):
        """GPS-anchored full BA: weight = #reproj-residuals/#cams, z/5
        (ref slam_gps.cc:718-830, gps_error_pose_absolute.h:41)."""
        imgs = scene.registered
        n_res = sum(len(t.obs) for t in scene.tracks if not t.is_bad)
        w = float(n_res) / max(len(imgs), 1)
        gps_w = np.tile(np.array([[w, w, w * self.cfg.slam.gps_weight_z_scale]]),
                        (len(imgs), 1))
        prob, maps = scene.to_ba_problem(
            self.kp_xy, max_views=16,
            mutable_images=imgs)  # no gauge freeze: GPS anchors fix it
        # pad camera-indexed arrays to the bucketed camera axis (padded
        # rows have zero weight and contribute nothing)
        Cp = prob.n_cameras
        gps_pos_p = np.zeros((Cp, 3), np.float32)
        gps_pos_p[: len(imgs)] = cams_gps
        gps_w_p = np.zeros((Cp, 3), np.float32)
        gps_w_p[: len(imgs)] = gps_w
        prob = prob._replace(gps_pos=jnp.asarray(gps_pos_p),
                             gps_weight=jnp.asarray(gps_w_p))
        if self.cfg.slam.use_gps_relative and len(imgs) >= 3:
            # consecutive keyframe triples (i-1, i, i+1), scaled like the
            # absolute term (ref slam_gps.cc:824 weight heuristic)
            trip = np.stack([np.arange(len(imgs) - 2),
                             np.arange(1, len(imgs) - 1),
                             np.arange(2, len(imgs))], axis=1)
            tw = np.tile(np.array([[
                w * self.cfg.slam.gps_relative_angle_weight,
                w * self.cfg.slam.gps_relative_dist_weight]]),
                (len(trip), 1))
            prob = prob._replace(
                gps_triple=jnp.asarray(trip, jnp.int32),
                gps_triple_weight=jnp.asarray(tw, jnp.float32))
        lm_cfg = LMConfig(max_iterations=self.cfg.ba.max_iterations,
                          huber_delta=self.cfg.ba.huber_delta,
                          rtol=self.cfg.ba.rtol,
                          cg_iterations=self.cfg.ba.cg_iterations,
                          cg_tol=self.cfg.ba.cg_tol)
        prob, info = solve_lm(prob, lm_cfg)
        scene.update_from_ba(prob, maps)
        return info

    def _accuracy_cull(self, scene: Scene, fold: str):
        """Reprojection stats + outlier cull + accuracy.txt
        (ref GetAccuracy, slam_gps.cc:1573-1594)."""
        from ..ba.lm import compute_residuals
        prob, maps = scene.to_ba_problem(self.kp_xy, max_views=16)
        r = np.asarray(compute_residuals(prob))
        msk = np.asarray(prob.track_mask)
        err = np.linalg.norm(r, axis=-1)
        n_obs = int(msk.sum())
        avg = float(err[msk].mean()) if n_obs else 0.0
        mse = float((err[msk] ** 2).mean()) if n_obs else 0.0
        exports.write_accuracy(os.path.join(fold, "accuracy.txt"),
                               avg, mse, n_obs)
        mse_row = (err ** 2 * msk).sum(1) / np.maximum(msk.sum(1), 1)
        for row in np.where(np.sqrt(mse_row) > self.cfg.sfm.th_mse_outliers * 3)[0]:
            if row < len(maps["tracks"]):
                scene.mark_bad(maps["tracks"][row])

    def convert_to_gps(self, xyz: np.ndarray) -> np.ndarray:
        """Re-add the UTM offset (ref Convert2GPS, slam_gps.cc:1915-1948)."""
        return xyz + self.gps_offset

    def _exports(self, fold: str, scene: Scene, slam: SLAMInput):
        out = os.path.join(fold, "mtpu_out")
        os.makedirs(out, exist_ok=True)
        exports.write_cams_points(out, scene)
        exports.write_point_cloud(os.path.join(out, "cloud.txt"), scene)
        names = {i: str(int(slam.cam_ids[k])).zfill(6)
                 for k, i in enumerate(scene.registered)}
        principal = {i: (slam.cx, slam.cy) for i in scene.registered}
        sizes = {i: (int(2 * slam.cx), int(2 * slam.cy))
                 for i in scene.registered}
        exports.write_qin(os.path.join(out, "pose.qin"), scene, names,
                          cols=int(2 * slam.cx), rows=int(2 * slam.cy))
        exports.write_sure(os.path.join(out, "sfm_sure.txt"), scene, names,
                           principal, sizes)
        exports.write_openmvs(os.path.join(out, "sfm_openmvs.txt"), scene,
                              self.kp_xy, names, principal, sizes)
        # undistorted keyframe copies (ref SaveUndistortedImage call at
        # slam_gps.cc:130-136); skips silently when image files are absent
        rgb_file = os.path.join(fold, "rgb.txt")
        frame_path: Dict[int, str] = {}
        if os.path.exists(rgb_file):
            with open(rgb_file) as f:
                for line in f.read().splitlines()[3:]:
                    parts = line.split()
                    if len(parts) < 2:
                        continue
                    rel = parts[-1]
                    stem = os.path.basename(rel).rsplit(".", 1)[0]
                    try:
                        frame_path[int(stem)] = os.path.join(fold, rel)
                    except ValueError:
                        pass
        img_paths = {i: frame_path.get(int(slam.cam_ids[k]), "")
                     for k, i in enumerate(scene.registered)}
        exports.write_undistorted_images(
            os.path.join(out, "undistort_images"), scene, img_paths)
        # gps_pos.txt overlay (ref :1885-1905)
        with open(os.path.join(out, "gps_pos.txt"), "w") as f:
            from ..ops import np_geom
            for k, img in enumerate(scene.registered):
                c = np_geom.camera_center(scene.poses[img])
                c = self.convert_to_gps(c)
                g = self.convert_to_gps(self._cams_gps_centered[k])
                f.write(f"{c[0]:.4f} {c[1]:.4f} {c[2]:.4f} "
                        f"{g[0]:.4f} {g[1]:.4f} {g[2]:.4f}\n")
        # GrawGPS/GrawSLAM-style overlay render (ref slam_gps.cc:1107-1213)
        from ..ops import np_geom as _npg
        est = np.stack([_npg.camera_center(scene.poses[i])
                        for i in scene.registered])
        exports.write_track_overlay_image(
            os.path.join(out, "gps_overlay.png"), est,
            np.asarray(self._cams_gps_centered))
