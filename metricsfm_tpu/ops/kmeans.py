"""K-means vocabulary, BoW transform, inverted-file similarity.

Replacement for the fbow vocabulary stack
(thirdparty/fbow: hierarchical k-means k=10 L=6, SURVEY.md §2.3;
 src/graph/similarity_graph.cc — inverted-file co-occurrence with stop
 words, and pairwise BoW distance).

Design: a (shallow) hierarchical k-means tree trained with batched Lloyd
iterations — every assignment is one matmul (-2 a.b distance trick).
The BoW "vector" is the word-count histogram; image-pair similarity is one
big counts @ counts.T matmul with idf weighting and stop-word zeroing —
the inverted-file semantics as dense linear algebra.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


class Vocabulary(NamedTuple):
    """Two-level k-means tree: coarse (B1, D) + fine (B1, B2, D) centroids.

    n_words = B1 * B2.  Replaces fbow's k=10/L=6 deep tree with a shallow
    matmul-friendly one (two matmuls per assignment, same BoW semantics).
    """
    coarse: jnp.ndarray
    fine: jnp.ndarray

    @property
    def n_words(self):
        return self.coarse.shape[0] * self.fine.shape[1]


def _assign(desc, centroids):
    """Nearest-centroid index per row; one matmul."""
    sim = jnp.dot(desc, centroids.T, preferred_element_type=jnp.float32)
    c2 = jnp.sum(centroids * centroids, axis=-1)
    d = c2[None, :] - 2.0 * sim
    return jnp.argmin(d, axis=-1).astype(jnp.int32)


def _kmeanspp_init(desc, key, k: int, m):
    """k-means++ seeding: each next center sampled with probability
    proportional to squared distance from the chosen set.  Avoids the
    Lloyd's local optima a uniform-row init falls into (two seeds in one
    cluster leave another cluster uncovered)."""
    N = desc.shape[0]
    key, k0 = jax.random.split(key)
    first = jax.random.choice(k0, N, p=m / jnp.sum(m))
    cent = jnp.zeros((k,) + desc.shape[1:], desc.dtype).at[0].set(desc[first])
    d2 = jnp.sum((desc - desc[first]) ** 2, axis=-1)

    def body(i, carry):
        cent, d2, key = carry
        key, sub = jax.random.split(key)
        p = d2 * m
        p = p / jnp.maximum(jnp.sum(p), 1e-12)
        idx = jax.random.choice(sub, N, p=p)
        c = desc[idx]
        cent = cent.at[i].set(c)
        d2 = jnp.minimum(d2, jnp.sum((desc - c) ** 2, axis=-1))
        return cent, d2, key

    cent, _, _ = jax.lax.fori_loop(1, k, body, (cent, d2, key))
    return cent


@partial(jax.jit, static_argnames=("k", "iters"))
def kmeans(desc, key, k: int, iters: int = 20, mask=None):
    """Lloyd's k-means on (N, D) rows with k-means++ init; returns (k, D)
    centroids.

    Empty clusters re-seed from data rows (matching fbow's behavior of
    keeping k fixed).
    """
    N = desc.shape[0]
    m = jnp.ones((N,), desc.dtype) if mask is None else mask.astype(desc.dtype)
    cent = _kmeanspp_init(desc, key, k, m)

    def body(i, cent):
        a = _assign(desc, cent)
        one_hot_sum = jax.ops.segment_sum(desc * m[:, None], a, k)
        counts = jax.ops.segment_sum(m, a, k)
        new = one_hot_sum / jnp.maximum(counts[:, None], 1e-6)
        # re-seed empties deterministically from data rows
        reseed = desc[(jnp.arange(k) * 7919) % N]
        return jnp.where(counts[:, None] > 0.5, new, reseed)

    return jax.lax.fori_loop(0, iters, body, cent)


def train_vocabulary(desc, key, branch1: int = 64, branch2: int = 64,
                     iters: int = 15, mask=None) -> Vocabulary:
    """Train the two-level tree (host loop over coarse cells, device kernels).

    Mirrors Database::BuildVocabularyTree (database.cc:655-677): trained on
    a sample of descriptors from <=num_image_voc images.
    """
    k1, k2 = jax.random.split(key)
    coarse = kmeans(desc, k1, branch1, iters, mask)
    a = np.asarray(_assign(desc, coarse))
    m = np.ones(desc.shape[0], bool) if mask is None else np.asarray(mask, bool)
    D = desc.shape[1]
    fine = np.zeros((branch1, branch2, D), np.float32)
    desc_np = np.asarray(desc)
    keys = jax.random.split(k2, branch1)
    for c in range(branch1):
        rows = np.where((a == c) & m)[0]
        if len(rows) < branch2:
            # degenerate cell: tile the cell's rows (or the coarse centroid)
            if len(rows) == 0:
                fine[c] = np.asarray(coarse[c])[None, :].repeat(branch2, 0)
                continue
            reps = desc_np[rows]
            fine[c] = reps[np.arange(branch2) % len(rows)]
            continue
        sub = jnp.asarray(desc_np[rows])
        fine[c] = np.asarray(kmeans(sub, keys[c], branch2, iters))
    return Vocabulary(coarse=jnp.asarray(coarse), fine=jnp.asarray(fine))


@jax.jit
def transform(voc: Vocabulary, desc, mask=None):
    """Per-descriptor word ids + word-count histogram (the fBow vector).

    Mirrors Vocabulary::transform (fbow.h:87) + GenerateWordsForImage
    (database.cc:853-867).
    Returns (word_ids (N,), counts (n_words,)).
    """
    c_idx = _assign(desc, voc.coarse)                       # (N,)
    fine_c = voc.fine[c_idx]                                # (N, B2, D)
    sim = jnp.einsum("nd,nkd->nk", desc, fine_c)
    c2 = jnp.sum(fine_c * fine_c, axis=-1)
    f_idx = jnp.argmin(c2 - 2.0 * sim, axis=-1).astype(jnp.int32)
    words = c_idx * voc.fine.shape[1] + f_idx
    n_words = voc.coarse.shape[0] * voc.fine.shape[1]
    w = jnp.ones_like(words, jnp.float32) if mask is None else mask.astype(jnp.float32)
    counts = jax.ops.segment_sum(w, words, n_words)
    words = jnp.where(w > 0, words, -1)
    return words, counts


@partial(jax.jit, static_argnames=("stop_word_frac",))
def similarity_matrix(counts, stop_word_frac: float = 0.01):
    """Pairwise image similarity from BoW count rows (n_imgs, n_words).

    Inverted-file semantics as dense algebra (similarity_graph.cc:47-117):
    a word whose inverted-file list is longer than stop_word_frac * n_words
    images is dropped as a stop word (the reference's th_bin_size =
    num_words_/100, GenerateInvertedFile condition 2 — note the threshold
    is derived from the VOCABULARY size, not the image count); surviving
    rows are idf-weighted and L2-normalized; similarity is the cosine
    matrix (one matmul).  Diagonal zeroed.
    """
    n = counts.shape[0]
    n_words = counts.shape[1]
    present = (counts > 0).astype(jnp.float32)
    doc_freq = jnp.sum(present, axis=0)
    keep = doc_freq <= jnp.maximum(stop_word_frac * n_words, 1.0)
    idf = jnp.log(jnp.maximum(n / jnp.maximum(doc_freq, 1.0), 1.0))
    w = counts * idf[None, :] * keep[None, :].astype(jnp.float32)
    w = w / jnp.maximum(jnp.linalg.norm(w, axis=1, keepdims=True), 1e-12)
    sim = jnp.dot(w, w.T, preferred_element_type=jnp.float32)
    return sim * (1.0 - jnp.eye(n))


@jax.jit
def word_intersection_counts(counts):
    """Number of common distinct words per image pair, one matmul.

    The cheap pre-seeding gate of the reference's initial matching graph
    (initial_matching_graph.cc:210-289: candidate pairs whose word-id
    intersection yields fewer than ~30 seed matches are dropped before any
    fine matching).  SIFT BoW histograms are near-binary at usable vocab
    sizes, so presence-intersection (an (n_imgs, n_words) boolean matmul)
    is the dense equivalent of the reference's sorted-list walk.
    """
    present = (counts > 0).astype(jnp.float32)
    return jnp.dot(present, present.T, preferred_element_type=jnp.float32)


@partial(jax.jit, static_argnames=())
def _accum_block(S, I, Wblk, Pblk):
    S = S + jnp.dot(Wblk, Wblk.T, preferred_element_type=jnp.float32)
    I = I + jnp.dot(Pblk, Pblk.T, preferred_element_type=jnp.float32)
    return S, I


def similarity_chunked(word_lists, n_words: int,
                       stop_word_frac: float = 0.01, block: int = 8192):
    """similarity_matrix + word_intersection_counts from per-image word-id
    lists, streamed over word BLOCKS — never materializes the
    (n_images, n_words) counts matrix (1.3 GB+ at 5k images x 65k words;
    ref similarity_graph.cc:47-117 streams an
    inverted file for the same reason).

    Args:
      word_lists: sequence of int arrays of per-keypoint word ids (-1 =
        masked, duplicates = multi-hit words), one per image.
      n_words: vocabulary size.
    Returns (sim (n, n) np.float32 cosine with zero diagonal,
             inter (n, n) np.float32 distinct-word intersection counts).
    Peak memory: O(n^2 + n * block) — the n x n outputs are DENSE by
    design; the stop-line is ~16k images (2 GB for the two matrices).
    Covered BASELINE scale is config 5 (5k images, ~200 MB); beyond the
    stop-line the outputs must become top-k lists (candidates_bow already
    consumes only a top-k row slice).
    """
    n = len(word_lists)
    sorted_w = [np.sort(np.asarray(w)[np.asarray(w) >= 0])
                for w in word_lists]
    # pass 1: document frequency -> stop words + idf
    doc_freq = np.zeros(n_words, np.float32)
    for w in sorted_w:
        doc_freq[np.unique(w)] += 1.0
    keep = doc_freq <= max(stop_word_frac * n_words, 1.0)
    idf = np.log(np.maximum(n / np.maximum(doc_freq, 1.0), 1.0)) \
        * keep.astype(np.float32)
    # pass 2: accumulate S_raw = sum_blk W W^T and presence intersections
    S = jnp.zeros((n, n), jnp.float32)
    I = jnp.zeros((n, n), jnp.float32)
    for w0 in range(0, n_words, block):
        blk = min(block, n_words - w0)
        Wblk = np.zeros((n, blk), np.float32)
        for i, w in enumerate(sorted_w):
            lo, hi = np.searchsorted(w, [w0, w0 + blk])
            if hi > lo:
                Wblk[i] = np.bincount(w[lo:hi] - w0, minlength=blk)
        Pblk = (Wblk > 0).astype(np.float32)
        Wblk *= idf[w0:w0 + blk][None, :]
        S, I = _accum_block(S, I, jnp.asarray(Wblk), jnp.asarray(Pblk))
    S = np.asarray(S)
    I = np.asarray(I)
    norms = np.sqrt(np.maximum(np.diagonal(S), 1e-12))
    S = S / norms[:, None] / norms[None, :]
    np.fill_diagonal(S, 0.0)
    return S.astype(np.float32), I


def top_candidates(sim, n_candidates: int):
    """Per-image top-k similar images (ref initial_matching_graph.cc:168-169:
    min(max(200, n/10), 500) candidates per image)."""
    vals, idx = jax.lax.top_k(sim, n_candidates)
    return vals, idx
