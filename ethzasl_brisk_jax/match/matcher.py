"""Hamming brute-force matching, dense.

Reference: ``BruteForceMatcher`` (``brisk/src/brute-force-matcher.cc``) with
the SSSE3 popcount-of-XOR distance (``hamming-inl.h:85-134``) — knnMatch
extracts k minima per query row, radiusMatch returns all within a radius.

The distance matrix is a matrix product: unpack each 384-bit descriptor to
a ±1 vector; then ``hamming(q, t) = (bits - q . t) / 2`` — a single bf16
matmul with f32 accumulation, exact because all values are small integers.
A popcount(XOR) path is kept for verification and for memory-bound regimes.

knn/radius become top-k / threshold masks over the dense distance matrix.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def unpack_bits_pm1(desc: jnp.ndarray, n_bits: int) -> jnp.ndarray:
    """(N, W) uint32 -> (N, n_bits) bf16 in {+1, -1} (bit LSB-first)."""
    w = desc.shape[-1]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits = bits.reshape(*desc.shape[:-1], w * 32)[..., :n_bits]
    return (bits.astype(jnp.bfloat16) * 2 - 1)


def hamming_distance_matrix(
    query: jnp.ndarray, train: jnp.ndarray, n_bits: int = 384
) -> jnp.ndarray:
    """(Q, W) x (T, W) uint32 -> (Q, T) int32 Hamming distances, one matmul.

    distance = (n_bits - <q_pm1, t_pm1>) / 2, exact in bf16->f32 matmuls
    since all magnitudes <= n_bits < 2^24.
    """
    q = unpack_bits_pm1(query, n_bits)
    t = unpack_bits_pm1(train, n_bits)
    dot = jax.lax.dot_general(
        q,
        t,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    return ((n_bits - dot) * 0.5).astype(jnp.int32)


def hamming_distance_matrix_popcnt(
    query: jnp.ndarray, train: jnp.ndarray
) -> jnp.ndarray:
    """XOR + popcount distance matrix (reference semantics, VPU path)."""
    x = query[:, None, :] ^ train[None, :, :]
    return jnp.sum(
        jax.lax.population_count(x).astype(jnp.int32), axis=-1
    )


@partial(jax.jit, static_argnames=("k", "n_bits"))
def knn_match(
    query: jnp.ndarray,
    train: jnp.ndarray,
    query_valid: jnp.ndarray,
    train_valid: jnp.ndarray,
    k: int = 2,
    n_bits: int = 384,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """k-nearest matches per query (commonKnnMatchImpl semantics).

    Returns (indices (Q, k) int32, distances (Q, k) int32); masked-out
    entries get distance INT32_MAX-class sentinel (n_bits + 1).
    """
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(train_valid[None, :], d, sentinel)
    neg_d, idx = jax.lax.top_k(-d, k)
    dist = -neg_d
    dist = jnp.where(query_valid[:, None], dist, sentinel)
    return idx, dist


@partial(jax.jit, static_argnames=("n_bits",))
def radius_match_best(
    query: jnp.ndarray,
    train: jnp.ndarray,
    query_valid: jnp.ndarray,
    train_valid: jnp.ndarray,
    radius: int,
    n_bits: int = 384,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Best match per query if strictly below radius (test-match.cc:75-89).

    Returns (best_idx (Q,), best_dist (Q,), matched (Q,) bool).
    """
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(train_valid[None, :], d, sentinel)
    best_idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    best_dist = jnp.min(d, axis=1)
    matched = (best_dist < radius) & query_valid
    return best_idx, best_dist, matched


@partial(jax.jit, static_argnames=("n_bits",))
def match_with_ratio_and_crosscheck(
    query: jnp.ndarray,
    train: jnp.ndarray,
    query_valid: jnp.ndarray,
    train_valid: jnp.ndarray,
    max_distance: int,
    ratio_num: int = 8,
    ratio_den: int = 10,
    n_bits: int = 384,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Lowe-style ratio test + mutual cross-check (for the VO front-end).

    Integer ratio test: d1 * ratio_den <= d2 * ratio_num. Returns
    (best_idx (Q,), matched (Q,) bool).
    """
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(train_valid[None, :], d, sentinel)
    d = jnp.where(query_valid[:, None], d, sentinel)

    neg2, idx2 = jax.lax.top_k(-d, 2)
    d1, d2 = -neg2[:, 0], -neg2[:, 1]
    best = idx2[:, 0]

    reverse_best = jnp.argmin(d, axis=0)  # best query per train
    mutual = jnp.take(reverse_best, best) == jnp.arange(d.shape[0])

    matched = (
        query_valid
        & (d1 <= max_distance)
        & (d1 * ratio_den <= d2 * ratio_num)
        & mutual
    )
    return best.astype(jnp.int32), matched


@partial(jax.jit, static_argnames=("k", "n_bits"))
def knn_match_masked(
    query: jnp.ndarray,
    train: jnp.ndarray,
    query_valid: jnp.ndarray,
    train_valid: jnp.ndarray,
    mask: jnp.ndarray,      # (Q, T) bool — allowed pairs (cv mask semantics)
    k: int = 2,
    n_bits: int = 384,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """knnMatch with a pair mask (commonKnnMatchImpl mask support,
    brute-force-matcher.cc:101-137)."""
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(mask & train_valid[None, :], d, sentinel)
    neg_d, idx = jax.lax.top_k(-d, k)
    dist = jnp.where(query_valid[:, None], -neg_d, sentinel)
    return idx, dist


@partial(jax.jit, static_argnames=("max_matches", "n_bits"))
def radius_match_all(
    query: jnp.ndarray,
    train: jnp.ndarray,
    query_valid: jnp.ndarray,
    train_valid: jnp.ndarray,
    radius: int,
    max_matches: int = 64,
    n_bits: int = 384,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """ALL matches with distance < radius per query, distance-sorted — the
    reference's radiusMatch (commonRadiusMatchImpl,
    brute-force-matcher.cc:164-214), with a static per-query capacity.

    Returns (indices (Q, max_matches) i32, distances (Q, max_matches) i32,
    counts (Q,) i32); empty slots carry distance n_bits+1.

    ``counts`` is the TRUE number of in-radius matches per query (counted
    over the whole train set, not the returned slots) — the reference
    returns every match, so a caller seeing ``counts[q] > max_matches``
    knows the static capacity truncated that row and can re-run with a
    larger ``max_matches``.
    """
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(train_valid[None, :], d, sentinel)
    d = jnp.where(d < radius, d, sentinel)
    d = jnp.where(query_valid[:, None], d, sentinel)
    counts = jnp.sum(d < sentinel, axis=1).astype(jnp.int32)
    neg_d, idx = jax.lax.top_k(-d, max_matches)
    dist = -neg_d
    return idx.astype(jnp.int32), dist, counts


class DescriptorCollection:
    """Train-image collection (cv::DescriptorMatcher::add semantics).

    The reference's ``commonKnnMatchImpl`` iterates a VECTOR of train
    descriptor matrices with per-image masks and emits ``DMatch.imgIdx``
    (brute-force-matcher.cc:95-161). Here the collection becomes ONE
    concatenated train matrix plus two index tables, so every query still
    hits a single distance matmul; global argmin order (image-major,
    then row) matches the reference's scan order because lax.top_k breaks
    ties toward the lowest concatenated index.
    """

    def __init__(self, trains=(), valids=None):
        self._trains: list = []
        self._valids: list = []
        for i, t in enumerate(trains):
            self.add(t, None if valids is None else valids[i])

    def add(self, train: jnp.ndarray, valid: jnp.ndarray | None = None):
        """Append one train image's (T_i, W) descriptors (+ valid mask)."""
        self._trains.append(jnp.asarray(train))
        self._valids.append(
            jnp.ones(train.shape[0], bool) if valid is None
            else jnp.asarray(valid)
        )

    def clear(self):
        self._trains.clear()
        self._valids.clear()

    def __len__(self) -> int:
        return len(self._trains)

    @property
    def n_images(self) -> int:
        return len(self._trains)

    @property
    def sizes(self) -> list:
        return [int(t.shape[0]) for t in self._trains]

    def stacked(self):
        """(train (T, W), valid (T,), img_idx (T,) i32, local_idx (T,) i32)."""
        import numpy as np

        train = jnp.concatenate(self._trains, axis=0)
        valid = jnp.concatenate(self._valids, axis=0)
        sizes = self.sizes
        img_idx = jnp.asarray(
            np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
        )
        local_idx = jnp.asarray(
            np.concatenate([np.arange(s, dtype=np.int32) for s in sizes])
        )
        return train, valid, img_idx, local_idx

    def concat_masks(self, masks) -> jnp.ndarray:
        """Per-image (Q, T_i) masks -> one (Q, T) concatenated mask."""
        return jnp.concatenate([jnp.asarray(m) for m in masks], axis=1)


@partial(jax.jit, static_argnames=("k", "n_bits"))
def _knn_collection_jit(
    query, train, query_valid, train_valid, img_idx, local_idx, mask,
    k, n_bits,
):
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(train_valid[None, :], d, sentinel)
    if mask is not None:
        d = jnp.where(mask, d, sentinel)
    neg_d, gidx = jax.lax.top_k(-d, k)
    dist = jnp.where(query_valid[:, None], -neg_d, sentinel)
    found = dist < sentinel
    out_img = jnp.where(found, img_idx[gidx], -1).astype(jnp.int32)
    out_train = jnp.where(found, local_idx[gidx], -1).astype(jnp.int32)
    return out_img, out_train, dist


def knn_match_collection(
    query: jnp.ndarray,
    collection: DescriptorCollection,
    query_valid: jnp.ndarray | None = None,
    masks=None,
    k: int = 2,
    n_bits: int = 384,
):
    """knnMatch against a train collection (commonKnnMatchImpl,
    brute-force-matcher.cc:95-161).

    ``masks``: optional per-image list of (Q, T_i) bool arrays (cv mask
    semantics — True allows the pair). Returns (img_idx (Q, k) i32,
    train_idx (Q, k) i32, dist (Q, k) i32); unfilled slots carry
    img_idx/train_idx -1 and distance n_bits+1.
    """
    train, train_valid, img_idx, local_idx = collection.stacked()
    if query_valid is None:
        query_valid = jnp.ones(query.shape[0], bool)
    mask = None if masks is None else collection.concat_masks(masks)
    return _knn_collection_jit(
        query, train, query_valid, train_valid, img_idx, local_idx, mask,
        k, n_bits,
    )


@partial(jax.jit, static_argnames=("max_matches", "n_bits"))
def _radius_collection_jit(
    query, train, query_valid, train_valid, img_idx, local_idx, mask,
    radius, max_matches, n_bits,
):
    sentinel = n_bits + 1
    d = hamming_distance_matrix(query, train, n_bits)
    d = jnp.where(train_valid[None, :], d, sentinel)
    if mask is not None:
        d = jnp.where(mask, d, sentinel)
    d = jnp.where(d < radius, d, sentinel)
    d = jnp.where(query_valid[:, None], d, sentinel)
    counts = jnp.sum(d < sentinel, axis=1).astype(jnp.int32)
    neg_d, gidx = jax.lax.top_k(-d, max_matches)
    dist = -neg_d
    found = dist < sentinel
    out_img = jnp.where(found, img_idx[gidx], -1).astype(jnp.int32)
    out_train = jnp.where(found, local_idx[gidx], -1).astype(jnp.int32)
    return out_img, out_train, dist, counts


def radius_match_collection(
    query: jnp.ndarray,
    collection: DescriptorCollection,
    radius: int,
    query_valid: jnp.ndarray | None = None,
    masks=None,
    max_matches: int = 64,
    n_bits: int = 384,
):
    """radiusMatch against a train collection (commonRadiusMatchImpl,
    brute-force-matcher.cc:164-214) with imgIdx outputs and TRUE counts
    (counts[q] > max_matches signals capacity truncation)."""
    train, train_valid, img_idx, local_idx = collection.stacked()
    if query_valid is None:
        query_valid = jnp.ones(query.shape[0], bool)
    mask = None if masks is None else collection.concat_masks(masks)
    return _radius_collection_jit(
        query, train, query_valid, train_valid, img_idx, local_idx, mask,
        radius, max_matches, n_bits,
    )
