"""Hierarchical submap bundle adjustment with pose-graph merge.

The scaling path for BASELINE configs 4-5 (1k-image aerial survey, 5k-image
mixed set): partition the registered cameras into overlapping submaps,
solve every submap's bundle adjustment as ONE batched jitted call (vmapped
Schur-LM; the batch axis shards over the device mesh so each chip solves
its own submaps), then stitch the submaps with a Sim(3) pose-graph
optimization over the shared cameras.

The reference has no distributed counterpart — its analogue is the CMVS
clustering of <=500 cameras for dense work (sfm_incremental.cc:1255-1256)
and the multi-model outer loop; SURVEY §2.11/§7 defines this design: the
reduced camera system stays dense *per submap*, and cross-submap coupling
is handled by the pose graph instead of a global dense solve.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ba import problem as ba_problem
from ..ba.lm import LMConfig, _solve_lm_chunk, solve_lm
from ..models.scene import bucket
from ..ops import np_geom


# ---------------------------------------------------------------- partition
def partition_images(imgs: Sequence[int], max_cams: int = 64,
                     overlap: int = 8) -> List[List[int]]:
    """Contiguous overlapping windows over the registration order.

    Consecutive submaps share `overlap` cameras — the glue the pose graph
    optimizes over.
    """
    imgs = list(imgs)
    if len(imgs) <= max_cams:
        return [imgs]
    parts = []
    step = max_cams - overlap
    start = 0
    while start < len(imgs):
        end = min(start + max_cams, len(imgs))
        parts.append(imgs[start:end])
        if end == len(imgs):
            break
        start += step
    return parts


# ------------------------------------------------------- batched problems
def build_submap_problems(scene, kp_xy: Dict[int, np.ndarray],
                          parts: List[List[int]], max_views: int = 8,
                          gauge_weight: float = 1.0, dtype=np.float32):
    """Stack one fixed-shape BAProblem per submap along a batch axis.

    Per submap: cameras = its window, tracks = scene tracks with >=2
    observations inside the window, observations truncated to window
    cameras. Intrinsics are frozen at this stage (global refinement owns
    them).

    Gauge: every camera carries a WEAK pose prior toward its parent-frame
    value instead of two hard-frozen cameras — freezing noisy anchors
    forces the structure to bend around their error (measured: center
    error growing linearly with distance from the anchors), while the soft
    prior averages the anchor noise over the whole window and leaves the
    reprojection terms in charge.

    Returns (problems dict-of-stacked-arrays, index info per submap).
    """
    S = len(parts)
    Cp = bucket(max(len(p) for p in parts), 8)
    V = max_views

    # ---- vectorized observation harvest off the scene's flat log ----
    # (the per-track Python loops this replaces were O(S * tracks * obs)
    # — minutes of host time per hierarchical full BA at the 1k scale)
    t_all, i_all, k_all = scene._obs_arrays()
    bad = scene.bad_mask()
    n_tr = len(scene.tracks)
    # keep-LAST per (track, img): Track.obs dict-overwrite semantics
    pos = np.arange(len(t_all))
    key = t_all * np.int64(scene.n_images) + i_all
    srt = np.lexsort((pos, key))
    key_s = key[srt]
    last = np.ones(len(srt), bool)
    if len(srt) > 1:
        last[:-1] = key_s[1:] != key_s[:-1]
    sel = srt[last]
    tD, iD, kD = t_all[sel], i_all[sel], k_all[sel]   # track-major order
    liveD = ~bad[tD] if bad.size else np.ones(len(tD), bool)
    tD, iD, kD = tD[liveD], iD[liveD], kD[liveD]

    # concatenated keypoint store for uv lookups
    all_imgs = sorted(kp_xy.keys())
    base = np.full(scene.n_images + 1, -1, np.int64)
    off = 0
    uv_parts = []
    for im in all_imgs:
        base[im] = off
        xy = np.asarray(kp_xy[im], np.float64).reshape(-1, 2)
        uv_parts.append(xy)
        off += len(xy)
    uv_all = np.concatenate(uv_parts) if uv_parts else np.zeros((0, 2))

    sub_tracks: List[List[int]] = []
    sub_obs = []           # per part: (p_row, cam_row, uv) arrays
    for s, part in enumerate(parts):
        row_of_arr = np.full(scene.n_images, -1, np.int64)
        row_of_arr[np.asarray(part, np.int64)] = np.arange(len(part))
        cam_row = row_of_arr[iD]
        m = cam_row >= 0
        tw, cw, kw = tD[m], cam_row[m], kD[m]
        # tracks with >= 2 observations inside the window
        cnt = np.bincount(tw, minlength=n_tr)
        keep_tr = np.nonzero(cnt >= 2)[0]
        sub_tracks.append(keep_tr.tolist())
        prow_of = np.full(n_tr, -1, np.int64)
        prow_of[keep_tr] = np.arange(len(keep_tr))
        pr = prow_of[tw]
        ok = pr >= 0
        tw, cw, kw, pr = tw[ok], cw[ok], kw[ok], pr[ok]
        # per-track slot index (tw is track-major sorted within the dedup)
        ord2 = np.argsort(tw, kind="stable")
        tw, cw, kw, pr = tw[ord2], cw[ord2], kw[ord2], pr[ord2]
        uniq, start, n_per_t = np.unique(tw, return_index=True,
                                         return_counts=True)
        slot = np.arange(len(tw)) - np.repeat(start, n_per_t)
        n_per = np.repeat(n_per_t, n_per_t)
        # V-cap: spread kept views across the track, rotated by p_row
        # (fixed subsampling starves the same cameras in every track)
        u = (slot - pr) % n_per
        c1 = -(-(u * V) // n_per)
        c2 = -(-((u + 1) * V) // n_per)
        keepv = (n_per <= V) | ((c1 < c2) & (c1 < V))
        tw, cw, kw, pr = tw[keepv], cw[keepv], kw[keepv], pr[keepv]
        uniq3, start3, cnt3 = np.unique(tw, return_index=True,
                                        return_counts=True)
        vslot = np.arange(len(tw)) - np.repeat(start3, cnt3)
        uv = uv_all[base[iD[m][ok][ord2][keepv]] + kw]
        sub_obs.append((pr, vslot, cw, uv))
    Pp = bucket(max(max((len(r) for r in sub_tracks), default=1), 1))

    poses = np.zeros((S, Cp, 6), dtype)
    intrs = np.tile(np.array([1.0, 0.0, 0.0], dtype), (S, Cp, 1))
    cam_model = np.tile(np.arange(Cp, dtype=np.int32), (S, 1))
    points = np.zeros((S, Pp, 3), dtype)
    track_cam = np.zeros((S, Pp, V), np.int32)
    track_uv = np.zeros((S, Pp, V, 2), dtype)
    track_mask = np.zeros((S, Pp, V), bool)
    pose_mut = np.zeros((S, Cp), dtype)
    point_mut = np.zeros((S, Pp), dtype)

    prior_w = np.zeros((S, Cp, 6), dtype)

    xyz_all = (np.stack([t.xyz for t in scene.tracks])
               if scene.tracks else np.zeros((0, 3)))
    infos = []
    for s, part in enumerate(parts):
        for r, im in enumerate(part):
            poses[s, r] = scene.poses[im]
            m = scene.models[scene.model_of_image[im]]
            intrs[s, r] = [m.f, m.k1, m.k2]
            pose_mut[s, r] = 1.0
            prior_w[s, r] = gauge_weight
        rows = np.asarray(sub_tracks[s], np.int64)
        if rows.size:
            points[s, :rows.size] = xyz_all[rows]
            point_mut[s, :rows.size] = 1.0
            pr, vslot, cw, uv = sub_obs[s]
            track_cam[s, pr, vslot] = cw.astype(np.int32)
            track_uv[s, pr, vslot] = uv
            track_mask[s, pr, vslot] = True
        infos.append({"images": part, "tracks": sub_tracks[s]})

    probs = ba_problem.build_problem(
        poses[0], intrs[0], cam_model[0], points[0], track_cam[0],
        track_uv[0], track_mask[0], point_mut=point_mut[0],
        pose_mut=pose_mut[0], intr_mut=np.zeros(Cp, dtype))
    # rebuild as a stacked pytree with a leading batch axis
    stacked = probs._replace(
        poses=jnp.asarray(poses), intrs=jnp.asarray(intrs),
        cam_model=jnp.asarray(cam_model), points=jnp.asarray(points),
        track_cam=jnp.asarray(track_cam), track_uv=jnp.asarray(track_uv),
        track_mask=jnp.asarray(track_mask),
        track_weight=jnp.ones((S, Pp), dtype),
        pose_mut=jnp.asarray(pose_mut),
        intr_mut=jnp.zeros((S, Cp), dtype),
        point_mut=jnp.asarray(point_mut),
        gps_pos=jnp.zeros((S, Cp, 3), dtype),
        gps_weight=jnp.zeros((S, Cp, 3), dtype),
        pose_prior=jnp.asarray(poses),
        pose_prior_weight=jnp.asarray(prior_w),
        gps_triple=jnp.zeros((S, 1, 3), jnp.int32),
        gps_triple_weight=jnp.zeros((S, 1, 2), dtype),
    )
    return stacked, infos


@partial(jax.jit, static_argnames=("cfg",))
def _solve_batched_chunk(problems, cfg: LMConfig, state, n_its):
    """One vmapped LM chunk over the submap batch axis; `state` is None
    (fresh) or the vmapped (lam, eta, cost) carry from the prior chunk."""
    if state is None:
        return jax.vmap(
            lambda p: _solve_lm_chunk(p, cfg, None, n_its))(problems)
    return jax.vmap(
        lambda p, s: _solve_lm_chunk(p, cfg, s, n_its))(problems, state)


def _solve_group(problems, cfg: LMConfig):
    """HOST-CHUNKED solve of one fixed-size vmapped submap group.

    Host-chunked like solve_lm: each XLA execution runs at most
    cfg.host_chunk LM iterations per submap (lm.py LMConfig.host_chunk).
    Small groups (total observations under
    cfg.host_chunk_small_obs) run the full budget in one execution.
    Already-converged submaps re-entering a later chunk reject one step
    and idle in the while_loop, so the waste per extra chunk is one LM
    iteration on a converged (cheap to reject) problem.
    """
    Sb, Pp, V = problems.track_cam.shape
    total_obs = Sb * Pp * V
    if total_obs <= cfg.host_chunk_small_obs:
        chunk = cfg.max_iterations
    else:
        chunk = max(1, min(cfg.host_chunk, cfg.max_iterations))
    ccfg = cfg._replace(max_iterations=chunk)

    state = None
    total_it = 0
    initial_cost = None
    out = problems
    info = None
    while total_it < cfg.max_iterations:
        n_its = min(chunk, cfg.max_iterations - total_it)
        out, info, state = _solve_batched_chunk(out, ccfg, state,
                                                jnp.int32(n_its))
        host = jax.device_get({"it": info["iterations"],
                               "conv": info["converged"]})
        total_it += int(host["it"].max())
        if initial_cost is None:
            initial_cost = info["initial_cost"]
        if bool(host["conv"].all()) or int(host["it"].max()) < n_its:
            break
    info = dict(info)
    info["initial_cost"] = initial_cost
    return out, info


def solve_submaps(problems, cfg: LMConfig = LMConfig(),
                  mesh: Optional[Mesh] = None, axis_name: str = "data",
                  vmap_chunk: int = 8):
    """Solve all submaps as fixed-size vmapped groups of `vmap_chunk`.

    Two reasons for the fixed group size (each group padded to exactly
    vmap_chunk with copies of its last submap, results sliced off):
    * ONE compiled shape regardless of the submap count — the incremental
      driver's growth schedule produces a different S at almost every
      full BA (S = 8, 9, 10, ...) and each distinct S recompiles the
      vmapped solver (~40 s per shape);
    * bounded HLO temps — the dense per-submap Schur path materializes
      (S, P, V, 9, 3)-class intermediates with tiny minor dims, which ran
      out of device memory at the 500-image scale.

    With a mesh, each group's batch axis is sharded over it — submaps are
    independent, so XLA needs no collectives (the pose graph on host does
    the cross-submap coupling).
    """
    S = problems.poses.shape[0]
    if mesh is not None:
        n = mesh.shape[axis_name]
        vmap_chunk = -(-vmap_chunk // n) * n
    outs, infos = [], []
    for s0 in range(0, S, vmap_chunk):
        grp = jax.tree.map(lambda x: x[s0:s0 + vmap_chunk], problems)
        g = grp.poses.shape[0]
        if g < vmap_chunk:
            grp = jax.tree.map(
                lambda x: jnp.concatenate(
                    [x] + [x[-1:]] * (vmap_chunk - g), axis=0), grp)
        if mesh is not None:
            shard = NamedSharding(mesh, P(axis_name))
            grp = jax.tree.map(lambda x: jax.device_put(x, shard), grp)
        out_g, info_g = _solve_group(grp, cfg)
        if g < vmap_chunk:
            out_g = jax.tree.map(lambda x: x[:g], out_g)
            info_g = {k: v[:g] for k, v in info_g.items()}
        outs.append(out_g)
        infos.append(info_g)
    if len(outs) == 1:
        return outs[0], infos[0]
    out = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
    info = {k: jnp.concatenate([jnp.atleast_1d(i[k]) for i in infos])
            for k in infos[0]}
    return out, info


# ------------------------------------------------------------ pose graph
def _aa_to_R(aa):
    from ..ops import lie
    return lie.angle_axis_to_matrix(aa)


def _apply_sim3(p7, pts):
    """pts (N, 3) under [aa, t, log_s]."""
    R = _aa_to_R(p7[:3])
    s = jnp.exp(p7[6])
    return s * pts @ R.T + p7[3:6]


def optimize_pose_graph(centers_by_submap: List[np.ndarray],
                        pairs: List[tuple],
                        iters: int = 30, lam: float = 1e-4,
                        rot_weight: float = 1.0,
                        identity_weight: float = 1e-2):
    """Sim(3) pose graph over submaps.

    centers_by_submap[k]: (Nk, 3) camera centers of submap k (solved frame).
    pairs: (i, j, ci, cj[, Ri, Rj]) — matched centers (and optionally
    world->cam rotation matrices (N, 3, 3)) of cameras shared by submaps i
    and j. Rotation residuals matter: overlapping cameras are often
    near-collinear, and centers alone leave the Sim(3) rotation about that
    line unconstrained — Gauss-Newton then returns a transform that matches
    the shared centers while shearing the rest of the submap. A weak
    identity prior pins the remaining gauge (submap frames are already
    near the parent frame thanks to the soft-gauge submap BA).

    Returns (S, 7) transforms T_k = [aa, t, log_s] (submap 0 pinned to
    identity) minimizing the stacked residual by damped Gauss-Newton.
    """
    S = len(centers_by_submap)
    if S == 1 or not pairs:
        return np.zeros((S, 7))

    pair_i = jnp.asarray([p[0] for p in pairs], jnp.int32)
    pair_j = jnp.asarray([p[1] for p in pairs], jnp.int32)
    n_shared = max(p[2].shape[0] for p in pairs)
    E = len(pairs)
    ci = np.zeros((E, n_shared, 3), np.float64)
    cj = np.zeros((E, n_shared, 3), np.float64)
    Ri = np.tile(np.eye(3), (E, n_shared, 1, 1))
    Rj = np.tile(np.eye(3), (E, n_shared, 1, 1))
    have_rot = np.zeros((E,), bool)
    msk = np.zeros((E, n_shared), np.float64)
    for r, p in enumerate(pairs):
        a, b = p[2], p[3]
        ci[r, :a.shape[0]] = a
        cj[r, :b.shape[0]] = b
        msk[r, :a.shape[0]] = 1.0
        if len(p) >= 6:
            Ri[r, :p[4].shape[0]] = p[4]
            Rj[r, :p[5].shape[0]] = p[5]
            have_rot[r] = True
    ci = jnp.asarray(ci, jnp.float32)
    cj = jnp.asarray(cj, jnp.float32)
    Ri = jnp.asarray(Ri, jnp.float32)
    Rj = jnp.asarray(Rj, jnp.float32)
    msk = jnp.asarray(msk, jnp.float32)
    rot_msk = jnp.asarray(msk * have_rot[:, None] * rot_weight, jnp.float32)
    # scale rotation residuals to center units (typical scene extent)
    extent = float(np.std(np.concatenate(centers_by_submap, axis=0))) + 1e-6

    def residuals(T):                          # T: (S, 7)
        Ti = T[pair_i]                         # (E, 7)
        Tj = T[pair_j]
        ai = jax.vmap(_apply_sim3)(Ti, ci)     # (E, N, 3)
        aj = jax.vmap(_apply_sim3)(Tj, cj)
        r_c = ((ai - aj) * msk[..., None]).reshape(-1)
        # camera rotation after the world similarity: R' = R R_T^T
        RTi = jax.vmap(lambda p7: _aa_to_R(p7[:3]))(Ti)   # (E, 3, 3)
        RTj = jax.vmap(lambda p7: _aa_to_R(p7[:3]))(Tj)
        bi = jnp.einsum("enab,ecb->enac", Ri, RTi)        # (E, N, 3, 3)
        bj = jnp.einsum("enab,ecb->enac", Rj, RTj)
        r_r = ((bi - bj) * rot_msk[..., None, None] * extent).reshape(-1)
        r_id = (identity_weight * extent) * T[1:].reshape(-1)
        return jnp.concatenate([r_c, r_r, r_id])

    def gn_step(T, _):
        free = T[1:].reshape(-1)               # submap 0 pinned

        def r_of(free_flat):
            Tfull = jnp.concatenate(
                [jnp.zeros((1, 7), T.dtype), free_flat.reshape(S - 1, 7)])
            return residuals(Tfull)

        r = r_of(free)
        J = jax.jacfwd(r_of)(free)
        H = J.T @ J
        H = H + lam * jnp.diag(jnp.maximum(jnp.diagonal(H), 1e-8))
        g = J.T @ r
        d = jnp.linalg.solve(H, -g)
        T_new = T.at[1:].add(d.reshape(S - 1, 7))
        better = jnp.sum(r_of(free + d) ** 2) < jnp.sum(r ** 2)
        return jnp.where(better, T_new, T), None

    T0 = jnp.zeros((S, 7), jnp.float32)
    T, _ = jax.lax.scan(gn_step, T0, None, length=iters)
    return np.asarray(T, np.float64)


# ------------------------------------------------------------- driver
def hierarchical_ba(scene, kp_xy: Dict[int, np.ndarray],
                    max_cams: int = 64, overlap: int = 8,
                    max_views: int = 8, cfg: LMConfig = LMConfig(),
                    mesh: Optional[Mesh] = None, verbose: bool = False):
    """Partition -> batched submap BA -> Sim(3) pose-graph merge.

    Mutates `scene` in place (poses + track xyz); each camera is owned by
    the submap where it sits furthest from the window edges, each track by
    the submap holding most of its observations.
    """
    imgs = scene.registered
    parts = partition_images(imgs, max_cams, overlap)
    probs, infos = build_submap_problems(scene, kp_xy, parts, max_views)
    if cfg.cg_iterations == 0:
        # batched submap solves always use the matrix-free PCG camera
        # solve: the dense per-submap Schur path materializes O(P*C)
        # one-hot factors and (P, V, 9, 3) temps with tiny minor dims
        # under vmap — out of memory at the 500-image scale; the
        # lane-major CG terms stay O(P*V)
        cfg = cfg._replace(cg_iterations=50)
    solved, info = solve_submaps(probs, cfg, mesh=mesh)
    poses_out = np.asarray(solved.poses, np.float64)    # (S, Cp, 6)
    points_out = np.asarray(solved.points, np.float64)  # (S, Pp, 3)

    # camera centers + rotations per submap (solved frame)
    centers, rots = [], []
    for s, part in enumerate(parts):
        centers.append(np.stack([np_geom.camera_center(poses_out[s, r])
                                 for r in range(len(part))]))
        rots.append(np.stack([np_geom.pose_to_Rt(poses_out[s, r])[0]
                              for r in range(len(part))]))

    # shared-camera pairs between every overlapping submap pair
    pairs = []
    for i in range(len(parts)):
        set_i = {im: r for r, im in enumerate(parts[i])}
        for j in range(i + 1, len(parts)):
            shared = [(set_i[im], r) for r, im in enumerate(parts[j])
                      if im in set_i]
            if len(shared) >= 3:
                ri = [a for a, _ in shared]
                rj = [b for _, b in shared]
                pairs.append((i, j, centers[i][ri], centers[j][rj],
                              rots[i][ri], rots[j][rj]))

    T = optimize_pose_graph(centers, pairs)
    if verbose:
        print(f"hierarchical_ba: {len(parts)} submaps, {len(pairs)} "
              f"overlap pairs")

    # ownership: camera -> submap where it is most interior
    owner_cam: Dict[int, Tuple[int, int]] = {}
    for s, part in enumerate(parts):
        for r, im in enumerate(part):
            depth = min(r, len(part) - 1 - r)
            if im not in owner_cam or depth > owner_cam[im][1]:
                owner_cam[im] = (s, depth)

    # track ownership: submap holding the most of the track's observations
    # (first such submap wins a tie)
    part_sets = [set(p) for p in parts]
    owner_track: Dict[int, int] = {}
    count_track: Dict[int, int] = {}
    for s in range(len(parts)):
        for ti in infos[s]["tracks"]:
            n_here = sum(1 for im in scene.tracks[ti].obs
                         if im in part_sets[s])
            if n_here > count_track.get(ti, 0):
                count_track[ti] = n_here
                owner_track[ti] = s

    for s, part in enumerate(parts):
        R_s = np_geom.angle_axis_to_matrix(T[s, :3])
        t_s = T[s, 3:6]
        sc = float(np.exp(T[s, 6]))
        for r, im in enumerate(part):
            if owner_cam[im][0] != s:
                continue
            scene.poses[im] = np_geom.apply_similarity_to_pose(
                poses_out[s, r], sc, R_s, t_s)
        for p_row, ti in enumerate(infos[s]["tracks"]):
            if owner_track.get(ti) == s:
                scene.tracks[ti].xyz = sc * R_s @ points_out[s, p_row] + t_s
    return info
