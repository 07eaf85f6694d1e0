"""Match-graph construction: candidate selection + fine matching + F-verify.

Re-design of the reference graph layer (SfM/src/graph.{h,cc},
graph/similarity_graph.cc, graph/initial_matching_graph.cc,
graph/fine_matching_graph.cc):

* Candidate pairs by one of three strategies (initial_matching_graph.cc:54-78):
  "all" exhaustive, "priori" GPS mutual-kNN in UTM, "feature" BoW top-k.
* Fine matching: brute-force 2-NN on the tensor cores with dual ratio tests
  (fine_matching_graph.cc:42-43) instead of FLANN KD-trees; "good" matches
  (ratio<0.6) estimate F via batched RANSAC, then "all" matches
  (ratio<0.85) are re-filtered by epipolar distance < 3 px
  (fine_matching_graph.cc:137-147).
* The driver is BATCHED: candidate pairs are stacked into (B, N, ...) pair
  batches and the whole match->RANSAC->refilter chain runs as ONE jitted
  dispatch per batch (optionally shard_mapped over the mesh `data` axis) —
  the batched replacement for the reference's OpenMP loop over pairs
  (fine_matching_graph.cc:87).
* Per-pair match shards persist for resume (match_index semantics).
"""
from __future__ import annotations

import itertools
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import GraphOptions
from ..io import store as fstore
from ..ops import epipolar, matching, ransac
from .incremental import PairMatches


def candidates_all(n: int) -> List[Tuple[int, int]]:
    """Exhaustive pairs (ref :57-64, UAV preset matching_type='all')."""
    return list(itertools.combinations(range(n), 2))


def candidates_gps(gps_utm: np.ndarray, knn: int) -> List[Tuple[int, int]]:
    """GPS prior: mutual k-NN in the UTM plane (ref :83-162).

    gps_utm: (n, 2) easting/northing. k = min(knn, n/10) as in the ref.
    """
    n = len(gps_utm)
    k = max(2, min(knn, max(n // 10, 2)))
    d2 = ((gps_utm[:, None, :] - gps_utm[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nbrs = np.argsort(d2, axis=1)[:, :k]
    pairs = set()
    for i in range(n):
        for j in nbrs[i]:
            if i in nbrs[j]:
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def candidates_bow(sim: np.ndarray, min_c: int = 200, max_c: int = 500
                   ) -> List[Tuple[int, int]]:
    """BoW similarity: per-image top min(max(min_c, n/10), max_c) candidates
    (ref :164-294, count rule :168-169)."""
    n = sim.shape[0]
    k = min(max(min_c, n // 10), max_c, n - 1)
    pairs = set()
    order = np.argsort(-sim, axis=1)
    for i in range(n):
        for j in order[i, :k]:
            if sim[i, j] > 0:
                pairs.add((min(i, int(j)), max(i, int(j))))
    return sorted(pairs)


def _pair_verifier(ratio_good: float, ratio_all: float, th_px: float,
                   min_inliers: int, budget: int, chunk: int):
    """The per-pair fine-matching + verification chain as a pure function
    suitable for vmap/shard_map (ref fine_matching_graph.cc:104-147).

    Returns (keep (N,) bool, idx2 (N,) int32, n_keep int32, ok bool).
    """
    import jax.numpy as jnp

    def one(d1, d2, m1, m2, p1, p2, key):
        res = matching.match_pair(d1, d2, m1, m2, ratio_good, ratio_all,
                                  chunk=chunk)
        p2g = p2[res["idx2"]]
        fr = ransac.fundamental_ransac(p1, p2g, key, mask=res["good"],
                                       th_px=th_px, min_inliers=min_inliers)
        d = epipolar.epipolar_distance(fr["F"], p1, p2g)
        keep = res["all"] & (d < th_px)
        # fixed per-pair match budget (GraphOptions.max_matches_per_pair):
        # keep the `budget` smallest descriptor distances among survivors
        if budget < keep.shape[0]:
            dist = jnp.where(keep, res["dist_sq"], jnp.inf)
            kth = jnp.sort(dist)[budget - 1]
            keep = keep & (dist <= kth)
        ok = (fr["ok"] & (jnp.sum(res["good"]) >= 8)
              & (jnp.sum(keep) >= min_inliers))
        keep = keep & ok
        return keep, res["idx2"], jnp.sum(keep), ok

    return one


class MatchGraphBuilder:
    """Build the verified match graph over candidate pairs (batched)."""

    def __init__(self, options: GraphOptions, out_fold: Optional[str] = None,
                 seed: int = 0, batch_pairs: int = 32, mesh=None):
        import jax
        self.opts = options
        self.out = out_fold
        self.key = jax.random.PRNGKey(seed)
        self.batch_pairs = batch_pairs
        self.mesh = mesh
        self._verify_cache = {}

    def _next_key(self):
        import jax
        self.key, sub = jax.random.split(self.key)
        return sub

    def _batched_verifier(self, chunk: int):
        """jit(vmap(gather + one)) over a device-resident feature store.

        The per-batch (B, N, D) descriptor tensors are GATHERED ON DEVICE
        from the uploaded-once store instead of being restacked on the
        host per batch (~130 MB per batch).  Only the (B,) pair indices
        cross the link.
        """
        import jax
        if chunk in self._verify_cache:
            return self._verify_cache[chunk]
        one = _pair_verifier(self.opts.ratio_good, self.opts.ratio_all,
                             self.opts.epipolar_px,
                             self.opts.geoverify_min_inliers,
                             self.opts.max_matches_per_pair, chunk)

        def gathered(desc, xy, mask, ii, jj, keys):
            fn = lambda i, j, key: one(desc[i], desc[j], mask[i], mask[j],
                                       xy[i], xy[j], key)
            return jax.vmap(fn)(ii, jj, keys)

        fn = gathered
        if self.mesh is not None:
            from jax.sharding import PartitionSpec as P
            spec = P("data")
            repl = P()
            fn = jax.shard_map(gathered, mesh=self.mesh,
                               in_specs=(repl, repl, repl, spec, spec, spec),
                               out_specs=(spec, spec, spec, spec))
        fn = jax.jit(fn)
        self._verify_cache[chunk] = fn
        return fn

    def match_one_pair(self, feat_i, feat_j) -> Optional[PairMatches]:
        """Fine matching for one pair (ref fine_matching_graph.cc:104-147)."""
        import jax.numpy as jnp
        res = matching.match_pair(
            jnp.asarray(feat_i.desc), jnp.asarray(feat_j.desc),
            jnp.asarray(feat_i.mask), jnp.asarray(feat_j.mask),
            ratio_good=self.opts.ratio_good, ratio_all=self.opts.ratio_all)
        good = np.asarray(res["good"])
        allm = np.asarray(res["all"])
        idx2 = np.asarray(res["idx2"])
        if good.sum() < 8:
            return None
        # F from "good" matches via batched RANSAC
        p1 = jnp.asarray(feat_i.xy)
        p2 = jnp.asarray(feat_j.xy[idx2])
        fr = ransac.fundamental_ransac(
            p1, p2, self._next_key(), mask=jnp.asarray(good),
            th_px=self.opts.epipolar_px,
            min_inliers=self.opts.geoverify_min_inliers)
        if not bool(fr["ok"]):
            return None
        # re-filter "all" matches by epipolar distance under the fixed F
        d = np.asarray(epipolar.epipolar_distance(fr["F"], p1, p2))
        keep = allm & (d < self.opts.epipolar_px)
        if keep.sum() < self.opts.geoverify_min_inliers:
            return None
        kp_i = np.where(keep)[0]
        return PairMatches(kp_i=kp_i.astype(np.int64),
                           kp_j=idx2[kp_i].astype(np.int64))

    def build(self, features, pairs: List[Tuple[int, int]],
              verbose: bool = False, owner=None
              ) -> Dict[Tuple[int, int], PairMatches]:
        """Match every candidate pair (resume-aware when out_fold set).

        `features` maps image id -> ImageFeatures with descriptors.  Pairs
        are processed in (B, N, D) batches through ONE jitted dispatch per
        batch — the whole 2-NN + ratio + F-RANSAC + epipolar-refilter chain
        stays on device; only the compressed (kp_i, kp_j) lists come back.

        owner=(process_id, process_count): multi-host sharding — this
        process matches only the pairs whose FIRST image falls in its
        contiguous image shard (the reference keys {i}_match files by i;
        per-shard resume works unchanged).
        """
        import jax
        import jax.numpy as jnp

        if owner is not None:
            from ..parallel.mesh import owned_range
            n_imgs = 1 + max((max(i, j) for i, j in pairs), default=0)
            lo, hi = owned_range(n_imgs, *owner)
            pairs = [(i, j) for (i, j) in pairs if lo <= i < hi]

        out: Dict[Tuple[int, int], PairMatches] = {}
        todo: List[Tuple[int, int]] = []
        # per-image match shards ({i}_match like the reference,
        # fine_matching_graph.cc:182-193), per-pair resume granularity
        # kept via the shard's processed-j list
        recs: Dict[int, dict] = {}
        if self.out is not None:
            for i in sorted({i for (i, _) in pairs}):
                r = fstore.read_image_matches(self.out, i)
                if r is not None:
                    recs[i] = r
        for (i, j) in pairs:
            r = recs.get(i)
            if r is not None and j in r["processed"]:
                if j in r["pairs"]:
                    a, b = r["pairs"][j]
                    out[(i, j)] = PairMatches(kp_i=a, kp_j=b)
                continue
            todo.append((i, j))
        pending: Dict[int, int] = {}
        for (i, _) in todo:
            pending[i] = pending.get(i, 0) + 1
        fresh: Dict[int, Dict[int, tuple]] = {}

        if todo:
            # one shared keypoint budget N: all images pad to the max K
            # (rounded up to a lane multiple) so every batch hits one
            # compiled shape; the store is uploaded to the device ONCE and
            # batches gather from it by index
            imgs = sorted({i for p in todo for i in p})
            row_of = {im: r for r, im in enumerate(imgs)}
            kmax = max(int(features[i].mask.shape[0]) for i in imgs)
            N = -(-kmax // 128) * 128
            D = features[imgs[0]].desc.shape[1]
            desc_all = np.zeros((len(imgs), N, D), np.float32)
            xy_all = np.zeros((len(imgs), N, 2), np.float32)
            mask_all = np.zeros((len(imgs), N), bool)
            for r, i in enumerate(imgs):
                f = features[i]
                k = f.mask.shape[0]
                desc_all[r, :k] = f.desc
                xy_all[r, :k] = f.xy
                mask_all[r, :k] = f.mask
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                repl = NamedSharding(self.mesh, P())
                put = lambda a: jax.device_put(jnp.asarray(a), repl)
            else:
                put = jnp.asarray
            desc_all = put(desc_all)
            xy_all = put(xy_all)
            mask_all = put(mask_all)

            B = self.batch_pairs
            if self.mesh is not None:
                nd = int(np.prod([self.mesh.shape[a] for a in
                                  self.mesh.axis_names]))
                B = -(-B // nd) * nd
            verify = self._batched_verifier(chunk=min(2048, N))
            n_batches = -(-len(todo) // B)
            for bi in range(n_batches):
                chunk_pairs = todo[bi * B:(bi + 1) * B]
                nb = len(chunk_pairs)
                fill = chunk_pairs + [chunk_pairs[-1]] * (B - nb)
                ii = np.array([row_of[i] for i, _ in fill], np.int32)
                jj = np.array([row_of[j] for _, j in fill], np.int32)
                keys = jax.random.split(self._next_key(), B)
                if self.mesh is not None:
                    from jax.sharding import NamedSharding, PartitionSpec as P
                    sh = NamedSharding(self.mesh, P("data"))
                    ii, jj, keys = (jax.device_put(jnp.asarray(a), sh)
                                    for a in (ii, jj, keys))
                keep, idx2, n_keep, ok = verify(desc_all, xy_all, mask_all,
                                                ii, jj, keys)
                # one host transfer for all three arrays
                keep, idx2, ok = jax.device_get((keep, idx2, ok))
                for b, (i, j) in enumerate(chunk_pairs):
                    if ok[b]:
                        kp_i = np.where(keep[b])[0]
                        m = PairMatches(kp_i=kp_i.astype(np.int64),
                                        kp_j=idx2[b][kp_i].astype(np.int64))
                        out[(i, j)] = m
                    else:
                        m = None
                    if self.out is not None:
                        fresh.setdefault(i, {})[j] = (
                            m.kp_i if m else np.empty(0, np.int64),
                            m.kp_j if m else np.empty(0, np.int64))
                        pending[i] -= 1
                        if pending[i] == 0:
                            # image i complete: merge with any prior shard
                            # and persist once (partial-progress semantics
                            # like the reference's per-image writes)
                            merged = dict(fresh.pop(i))
                            old = recs.get(i)
                            if old is not None:
                                for j2 in old["processed"]:
                                    if j2 not in merged:
                                        merged[j2] = old["pairs"].get(
                                            j2, (np.empty(0, np.int64),
                                                 np.empty(0, np.int64)))
                            fstore.write_image_matches(self.out, i, merged)
                if verbose:
                    print(f"matching batch {bi + 1}/{n_batches} "
                          f"({min((bi + 1) * B, len(todo))}/{len(todo)} pairs)")

        if self.out is not None:
            fstore.write_match_graph(
                self.out, {k: len(v.kp_i) for k, v in out.items()})
        return out


def render_pair_matches(database, matches, render_dir: str,
                        features=None, max_pairs: int = 50,
                        max_lines: int = 200) -> List[str]:
    """Write side-by-side match renders for verified pairs (the
    reference's commented-out cv::line debug blocks,
    fine_matching_graph.cc:156-180, as a shipped affordance).

    Renders up to `max_pairs` pairs (evenly subsampled) as
    match_{i}_{j}.png in render_dir.  Returns written paths.
    """
    import os

    from PIL import Image

    from ..io.exports import write_match_visualization

    os.makedirs(render_dir, exist_ok=True)
    feats = features or {i: database.features(i)
                         for i in range(database.n_images)}
    keys = sorted(matches.keys())
    sel = (np.linspace(0, len(keys) - 1,
                       min(len(keys), max_pairs)).astype(int)
           if keys else np.zeros(0, int))
    written = []
    for s in np.unique(sel):
        i, j = keys[s]
        m = matches[(i, j)]
        with Image.open(database.image_paths[i]) as a:
            img_i = np.asarray(a.convert("L"), np.float32) / 255.0
        with Image.open(database.image_paths[j]) as b:
            img_j = np.asarray(b.convert("L"), np.float32) / 255.0
        p = os.path.join(render_dir, f"match_{i:04d}_{j:04d}.png")
        write_match_visualization(p, img_i, img_j, feats[i].xy,
                                  feats[j].xy, m.kp_i, m.kp_j,
                                  max_lines=max_lines)
        written.append(p)
    return written


def build_match_graph(database, config, verbose: bool = False, mesh=None,
                      priori_utm=None, debug_render_dir=None):
    """End-to-end graph build (ref Graph::BuildGraph, graph.cc:52-70).

    Chooses the candidate strategy from config.graph.matching_type, runs
    batched fine matching, returns {(i, j): PairMatches}.  When more than
    one device is visible, pair batches shard over a `data` mesh axis
    (the reference's OpenMP axis, SURVEY §2.11).

    priori_utm: optional (n, 2) easting/northing for 'priori' candidate
    selection when positions come from a pose-prior file rather than image
    EXIF (the reference accepts both, initial_matching_graph.cc:83-162).

    debug_render_dir: when set, per-pair match visualizations are written
    there (render_pair_matches).
    """
    import jax
    import jax.numpy as jnp
    from ..ops import kmeans as km
    from ..utils import utm as utm_util

    opts = config.graph
    n = database.n_images
    if opts.matching_type == "all" or n <= 12:
        pairs = candidates_all(n)
    elif opts.matching_type == "priori":
        if priori_utm is not None:
            coords = np.asarray(priori_utm, np.float64)
        else:
            coords = []
            for i in range(n):
                lat, lon, alt = database.gps(i)
                e, no, _ = utm_util.ll_to_utm(lat, lon)
                coords.append([e, no])
            coords = np.array(coords)
        pairs = candidates_gps(coords, opts.knn)
    else:
        voc, counts = database.build_words(verbose=verbose)
        if counts is not None:
            sim = np.asarray(km.similarity_matrix(
                jnp.asarray(counts), stop_word_frac=opts.stop_word_frac))
            inter = np.asarray(
                km.word_intersection_counts(jnp.asarray(counts)))
        else:
            # large image sets: streamed word-block accumulation, no
            # (n_images, n_words) matrix (ref inverted file,
            # similarity_graph.cc:47-117)
            sim, inter = km.similarity_chunked(
                database.word_lists(), int(voc.n_words),
                stop_word_frac=opts.stop_word_frac)
        pairs = candidates_bow(sim, opts.min_candidates, opts.max_candidates)
        if opts.word_seed_min_matches > 0:
            # word-intersection pre-seeding: drop candidate pairs that
            # cannot yield >= word_seed_min_matches word-co-occurrence seeds
            # before paying for fine matching (ref
            # initial_matching_graph.cc:210-289)
            n0 = len(pairs)
            pairs = [(i, j) for (i, j) in pairs
                     if inter[i, j] >= opts.word_seed_min_matches]
            if verbose and len(pairs) < n0:
                print(f"word-seed gate: {n0} -> {len(pairs)} pairs")
    if verbose:
        print(f"match graph: {len(pairs)} candidate pairs for {n} images")
    if mesh is None and jax.device_count() > 1:
        from jax.sharding import Mesh
        mesh = Mesh(np.array(jax.devices()), ("data",))
    builder = MatchGraphBuilder(opts, out_fold=database.out, mesh=mesh)
    feats = {i: database.features(i) for i in range(n)}
    out = builder.build(feats, pairs, verbose=verbose)
    if debug_render_dir is not None:
        render_pair_matches(database, out, debug_render_dir, features=feats)
    return out
