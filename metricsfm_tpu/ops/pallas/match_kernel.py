"""Fused exact 2-NN descriptor matching for NVIDIA GPUs (Pallas, Triton route).

The hot op of the matching layer (SURVEY.md §3.1 HOT LOOP #2): for every
query descriptor find its best and second-best database neighbour.  The
XLA form (ops/matching.knn2) writes each (N1, chunk) f32 similarity tile to
device memory and reads it back for max / argmax / second max; at
8,192 x 8,192 that is ~0.8 GB of traffic per pair against a 17 GFLOP
product.  This kernel keeps the running top-2 in registers instead:

* grid over (pair, query block of `_BQ` rows); pairs come from vmap, whose
  batching rule prepends the grid axis;
* inside a program, a loop over `_BK`-column database blocks: one bf16
  `pl.dot` with f32 accumulation, the validity mask and the block top-2 in
  the epilogue, merged into the running (best, second, index) vectors;
* the similarity tile never leaves the SM.

Values are exact f32 similarities and indices exact int32; ties resolve to
the lowest database index, as jnp.argmax does in the XLA form.
Matches cudaSift brute-force matcher semantics
(feature_matching_cuda_sift.cpp:21-120) with exact nearest neighbours.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BQ = 64          # query rows per program
_BK = 128         # database columns per loop step
_NUM_WARPS = 4
_NUM_STAGES = 3   # software-pipelining depth of the database-block loop


def _kernel(q_ref, db_ref, m_ref, d1_ref, d2_ref, idx_ref, *, n_blocks):
    q = q_ref[...]                                        # (BQ, D) bf16
    neg_inf = jnp.float32(-jnp.inf)
    cols = jnp.arange(_BK, dtype=jnp.int32)

    def body(j, carry):
        best, second, best_idx = carry
        start = j * _BK
        db = db_ref[pl.ds(start, _BK), :]                 # (BK, D) bf16
        valid = m_ref[pl.ds(start, _BK)]                  # (BK,) int32
        sim = pl.dot(q, db, trans_b=True,
                     precision=jax.lax.Precision.DEFAULT)  # (BQ, BK) f32
        sim = jnp.where(valid[None, :] > 0, sim, neg_inf)
        blk_best = jnp.max(sim, axis=1)
        # lowest column holding the block maximum (jnp.argmax's tie rule)
        blk_arg = jnp.min(jnp.where(sim == blk_best[:, None], cols[None, :],
                                    _BK), axis=1)
        blk_second = jnp.max(jnp.where(cols[None, :] == blk_arg[:, None],
                                       neg_inf, sim), axis=1)
        # strict '>' keeps the earlier block's index on ties
        new_idx = jnp.where(blk_best > best, start + blk_arg, best_idx)
        new_second = jnp.maximum(jnp.minimum(best, blk_best),
                                 jnp.maximum(second, blk_second))
        return jnp.maximum(best, blk_best), new_second, new_idx

    bq = q.shape[0]
    init = (jnp.full((bq,), neg_inf, jnp.float32),
            jnp.full((bq,), neg_inf, jnp.float32),
            jnp.zeros((bq,), jnp.int32))
    best, second, best_idx = jax.lax.fori_loop(0, n_blocks, body, init)
    d1_ref[...] = jnp.maximum(2.0 - 2.0 * best, 0.0)
    d2_ref[...] = jnp.maximum(2.0 - 2.0 * second, 0.0)
    idx_ref[...] = best_idx


def knn2_triton(desc1, desc2, mask2=None, interpret: bool = False):
    """Exact 2-NN desc1 -> desc2 through the fused kernel.

    Same contract as ops.matching.knn2 (bf16 similarities, f32 results):
    returns (d1_sq, d2_sq, idx) for unit-norm rows, d^2 = 2 - 2 s.  Rows
    are padded to the block sizes and the descriptor width to a power of
    two (zero columns change no dot product), so every shape is accepted.
    Batch by vmapping.  `interpret=True` runs the kernel body on the CPU
    (tests); otherwise it compiles only for a GPU.
    """
    N1, D = desc1.shape
    N2 = desc2.shape[0]
    Dp = max(16, pl.next_power_of_2(D))
    pad1 = (-N1) % _BQ
    pad2 = (-N2) % _BK
    q = jnp.pad(desc1, ((0, pad1), (0, Dp - D))).astype(jnp.bfloat16)
    db = jnp.pad(desc2, ((0, pad2), (0, Dp - D))).astype(jnp.bfloat16)
    m = (jnp.ones((N2,), jnp.int32) if mask2 is None
         else mask2.astype(jnp.int32))
    m = jnp.pad(m, (0, pad2))
    n1p, n2p = N1 + pad1, N2 + pad2

    # under shard_map the outputs vary over the same mesh axes as the inputs
    vma = jax.typeof(q).vma | jax.typeof(db).vma | jax.typeof(m).vma
    row = lambda dt: jax.ShapeDtypeStruct((n1p,), dt, vma=vma)
    d1_sq, d2_sq, idx = pl.pallas_call(
        functools.partial(_kernel, n_blocks=n2p // _BK),
        grid=(n1p // _BQ,),
        in_specs=[
            pl.BlockSpec((_BQ, Dp), lambda i: (i, 0)),
            pl.BlockSpec((n2p, Dp), lambda i: (0, 0)),
            pl.BlockSpec((n2p,), lambda i: (0,)),
        ],
        out_specs=[pl.BlockSpec((_BQ,), lambda i: (i,))] * 3,
        out_shape=[row(jnp.float32), row(jnp.float32), row(jnp.int32)],
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=_NUM_STAGES),
        backend="triton",
        interpret=interpret,
        name="knn2_top2",
    )(q, db, m)
    return d1_sq[:N1], d2_sq[:N1], idx[:N1]
