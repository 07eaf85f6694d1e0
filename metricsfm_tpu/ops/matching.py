"""Brute-force descriptor matching on the tensor cores.

Replaces the reference's KD-tree / GPU matchers
(SfM/src/feature/feature_matching.{h,cpp} FLANN paths,
 feature_matching_cuda_sift.cpp brute-force,
 graph/fine_matching_graph.cc:71-147 ratio tests + F-verify).

Brute force suits a matrix unit (SURVEY.md §7): descriptor distances are
one big matmul (|a|^2 + |b|^2 - 2 a.b), 2-NN is a running top-2 reduction
over column blocks, and the dual ratio tests (0.6 "good" / 0.85 "all") are
elementwise masks.  Matches cudaSift matcher semantics with exact (not
approximate) nearest neighbours.

Descriptors are L2-normalized SIFT vectors; matmuls run in bfloat16 (the
similarity ranking tolerates bf16; distances used in ratio tests are
recomputed from the bf16 similarities, matching the tolerance of the
reference's float pipeline).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("chunk", "use_bf16"))
def knn2(desc1, desc2, mask2=None, chunk: int = 2048, use_bf16: bool = True):
    """Exact 2-nearest-neighbour search desc1 -> desc2.

    Args:
      desc1: (N1, D) query descriptors (L2-normalized rows).
      desc2: (N2, D) database descriptors.
      mask2: (N2,) validity of database rows (padded slots excluded).
      chunk: column-block size for the scan (bounds memory at N1*chunk).
      use_bf16: run the similarity matmul in bfloat16.

    Returns:
      (d1_sq, d2_sq, idx1): best/second-best squared L2 distances (N1,),
      and the index of the best neighbour (N1,) int32.  For unit-norm
      descriptors d^2 = 2 - 2 s, computed from the similarity s.
    """
    N2 = desc2.shape[0]
    n_chunks = -(-N2 // chunk)
    pad = n_chunks * chunk - N2
    d2p = jnp.pad(desc2, ((0, pad), (0, 0)))
    m2 = jnp.ones((N2,), bool) if mask2 is None else mask2.astype(bool)
    m2p = jnp.pad(m2, (0, pad))
    d2b = d2p.reshape(n_chunks, chunk, -1)
    m2b = m2p.reshape(n_chunks, chunk)

    if use_bf16:
        q = desc1.astype(jnp.bfloat16)
        d2b = d2b.astype(jnp.bfloat16)
    else:
        q = desc1

    neg_inf = jnp.float32(-jnp.inf)

    def body(carry, blk):
        best, second, best_idx = carry
        d_blk, m_blk, off = blk
        # DEFAULT precision: bf16 operands on the tensor cores (the package
        # sets jax_default_matmul_precision="highest" for geometry/BA —
        # the wrong trade for descriptor similarity ranking)
        sim = jnp.dot(q, d_blk.T, preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.DEFAULT)
        sim = jnp.where(m_blk[None, :], sim, neg_inf)
        blk_best = jnp.max(sim, axis=1)
        blk_arg = jnp.argmax(sim, axis=1).astype(jnp.int32)
        cols = jnp.arange(sim.shape[1])
        sim2 = jnp.where(cols[None, :] == blk_arg[:, None], neg_inf, sim)
        blk_second = jnp.max(sim2, axis=1)
        # merge running top-2 with block top-2
        new_best_idx = jnp.where(blk_best > best, off + blk_arg, best_idx)
        stacked = jnp.stack([best, second, blk_best, blk_second], axis=0)
        srt = jnp.sort(stacked, axis=0)
        return (srt[-1], srt[-2], new_best_idx), None

    # derive carry init from desc1 so it inherits device-varying type under
    # shard_map (a literal init would be replicated and fail the scan check)
    row0 = jnp.zeros_like(desc1[:, 0], dtype=jnp.float32)
    init = (row0 - jnp.inf, row0 - jnp.inf,
            jnp.zeros_like(desc1[:, 0], dtype=jnp.int32))
    offs = jnp.arange(n_chunks, dtype=jnp.int32) * chunk
    (best, second, best_idx), _ = jax.lax.scan(body, init, (d2b, m2b, offs))
    d1_sq = jnp.maximum(2.0 - 2.0 * best, 0.0)
    d2_sq = jnp.maximum(2.0 - 2.0 * second, 0.0)
    return d1_sq, d2_sq, best_idx


def nearest2(desc1, desc2, mask2=None, chunk: int = 2048):
    """knn2 as the pipeline runs it: the fused Pallas/Triton kernel
    (pallas/match_kernel.py) when the process's default backend is a GPU,
    the XLA scan `knn2` elsewhere.  Dispatch follows jax.default_backend()
    — the process default, not input placement."""
    if jax.default_backend() == "gpu":
        from .pallas.match_kernel import knn2_triton
        return knn2_triton(desc1, desc2, mask2)
    return knn2(desc1, desc2, mask2, chunk=chunk)


@partial(jax.jit, static_argnames=("chunk",))
def match_pair(desc1, desc2, mask1=None, mask2=None,
               ratio_good: float = 0.6, ratio_all: float = 0.85,
               chunk: int = 2048):
    """Match one image pair with the reference's dual ratio tests.

    Reference fine_matching_graph.cc:42-43,116-133: a strict ratio (<0.6)
    selects the "good" subset used to estimate F, a loose ratio (<0.85)
    keeps candidate matches; both returned as masks over desc1 rows.

    The 2-NN runs through `nearest2`.

    Returns dict:
      idx2 (N1,): best-neighbour index into desc2,
      good (N1,), all (N1,): ratio-test masks (L2 ratio on distances),
      dist_sq (N1,): best squared distance.
    """
    d1_sq, d2_sq, idx2 = nearest2(desc1, desc2, mask2, chunk=chunk)
    m1 = jnp.ones(desc1.shape[:1], bool) if mask1 is None else mask1.astype(bool)
    # L2 ratio: d1/d2 < r  <=>  d1^2 < r^2 d2^2
    safe2 = jnp.maximum(d2_sq, 1e-12)
    good = (d1_sq < ratio_good ** 2 * safe2) & m1
    allm = (d1_sq < ratio_all ** 2 * safe2) & m1
    return {"idx2": idx2, "good": good, "all": allm, "dist_sq": d1_sq}


def mutual_filter(idx12, idx21, mask=None):
    """Cross-check: keep i where idx21[idx12[i]] == i."""
    back = idx21[idx12]
    ok = back == jnp.arange(idx12.shape[0])
    if mask is not None:
        ok = ok & mask
    return ok


@partial(jax.jit, static_argnames=("chunk",))
def match_pairs_batch(desc1, desc2, mask1, mask2,
                      ratio_good: float = 0.6, ratio_all: float = 0.85,
                      chunk: int = 2048):
    """vmap of match_pair over a leading pair axis: desc* (B, N, D)."""
    fn = lambda a, b, m1, m2: match_pair(a, b, m1, m2, ratio_good, ratio_all,
                                         chunk=chunk)
    return jax.vmap(fn)(desc1, desc2, mask1, mask2)
