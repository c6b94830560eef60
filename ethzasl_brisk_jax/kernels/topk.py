"""Exact top-k of a large int32 map without a full-size sort.

``lax.top_k`` over the flattened H*W score map sorts all ~307k elements
to extract k=8k. This module computes the IDENTICAL result (values descending, ties by
ascending flat index — lax.top_k's documented tie order) with:

1. an on-device 31-step bisection for the k-th value threshold t
   (each step is one bandwidth-trivial reduction over the 1.2 MB map);
2. selection of `x > t` plus the first (k - count_gt) elements == t in
   index order (prefix-count over the equality mask);
3. compaction by inverting the selection prefix-sum with a vectorized
   binary search (`searchsorted`) — no scatter, no nonzero (which
   lowers to a full sort);
4. a final k-element stable sort for the descending-value tie order
   (37x smaller than the full-map sort).

Reference hot path being replaced: the descending candidate sort of
`PointWithScore` (brisk/include/brisk/internal/score-calculator.h:66-85
inverted operator<; scale-space-layer-inl.h:372-392).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

INT32_MIN = jnp.iinfo(jnp.int32).min


def topk_int32(x: jnp.ndarray, k: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Bit-equal drop-in for ``jax.lax.top_k`` on a 1-D int32 array.

    Returns (values, indices), values descending, ties by ascending
    index. Requires k <= x.size.
    """
    n = x.size
    if k >= n:
        return jax.lax.top_k(x, k)

    # --- 1. k-th largest value by bisection: find the largest t with
    # count(x > t) < k; then the k-th value is t (standard invariant:
    # count(x > kth) < k and count(x >= kth) >= k).
    def body(_, state):
        lo, hi = state  # invariant: the k-th value lies in [lo, hi]
        # Overflow-safe floor midpoint (hi - lo can exceed int32).
        mid = (lo >> 1) + (hi >> 1) + (lo & hi & 1)
        c = jnp.sum(x > mid)
        return jnp.where(c >= k, mid + 1, lo), jnp.where(c >= k, hi, mid)

    lo0 = jnp.int32(INT32_MIN)
    hi0 = jnp.int32(jnp.iinfo(jnp.int32).max)
    # 32 iterations cover the full int32 range (interval halves from
    # 2^32; loop preserves lo <= hi with count(x > hi) < k).
    lo, hi = jax.lax.fori_loop(0, 32, body, (lo0, hi0))
    t = hi  # k-th largest value

    # --- 2. Selection mask with exact tie handling.
    gt = x > t
    eq = x == t
    n_gt = jnp.sum(gt)
    r = k - n_gt  # how many == t survive (first r in index order)
    eq_rank = jnp.cumsum(eq.astype(jnp.int32))  # 1-based among eq
    sel = gt | (eq & (eq_rank <= r))

    # --- 3. Compaction: j-th selected index = searchsorted(csum, j+1).
    csum = jnp.cumsum(sel.astype(jnp.int32))
    idx = jnp.searchsorted(
        csum, jnp.arange(1, k + 1, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    vals = jnp.take(x, idx)

    # --- 4. Order: descending value, ascending index on ties. The
    # compacted list is index-ascending, so a stable sort on the
    # order-reversing key ~v (= -v-1, no INT32_MIN overflow) reproduces
    # lax.top_k's tie order exactly.
    order = jnp.argsort(~vals, stable=True)
    return jnp.take(vals, order), jnp.take(idx, order)


def topk_from_mask(
    x: jnp.ndarray, mask: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Top-k of ``where(mask, x, INT32_MIN)`` without any full-size sort.

    Bit-equal to ``jax.lax.top_k(where(mask, x, INT32_MIN), k)``
    (values descending, ties by ascending flat index — including the
    sentinel padding rows, which top_k fills with the lowest-index
    unmasked positions) WHENEVER ``count(mask) <= k`` and every masked
    value is > INT32_MIN (so masked elements are distinguishable from
    the sentinel; the detection masks guarantee this — they imply
    ``score >= absolute_threshold``). On overflow
    (more masked elements than k — a capacity misconfiguration; the
    per-layer candidate caps are sized to cover every 2D maximum) it
    degrades to the first k masked elements in flat-index order instead
    of the k best by score; callers that must stay exact under overflow
    use ``topk_impl="sort"``.

    Unlike the bisection select (:func:`topk_int32`) there is NO
    sequential loop — one cumsum + two vectorized binary searches + one
    k-element lexsort — so it vmaps over frames without convoying and
    is not launch-latency-bound like the 31-step bisection.
    """
    n = x.size
    if k >= n:
        return jax.lax.top_k(jnp.where(mask, x, INT32_MIN), k)

    xi = jnp.where(mask, x, INT32_MIN)
    # Positions of masked elements in index order: j-th one is the first
    # i with cumsum(mask)[i] == j+1 (vectorized binary search on the
    # monotone prefix count — no nonzero(), which lowers to a full sort).
    csum = jnp.cumsum(mask.astype(jnp.int32))
    count = csum[n - 1]
    j = jnp.arange(1, k + 1, dtype=jnp.int32)
    idx_m = jnp.searchsorted(csum, j, side="left").astype(jnp.int32)
    # Padding positions: first (k - count) UNmasked indices, found the
    # same way on the complement count (i+1) - csum[i].
    csum_not = jnp.arange(1, n + 1, dtype=jnp.int32) - csum
    idx_p = jnp.searchsorted(
        csum_not, j, side="left"
    ).astype(jnp.int32)
    take_m = j <= count
    idx = jnp.where(take_m, jnp.minimum(idx_m, n - 1),
                    jnp.take(idx_p, (j - 1) - count, mode="clip"))
    vals = jnp.take(xi, idx)

    # Final order: descending value, ascending index on ties — across
    # the masked AND padding parts jointly (a masked element can
    # legitimately hold INT32_MIN), exactly lax.top_k's order.
    order = jnp.lexsort((idx, ~vals))
    return jnp.take(vals, order), jnp.take(idx, order)


def topk_block(
    x: jnp.ndarray, k: int, block: int = 2048, r: int = 256
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Two-stage exact top-k of a 1-D int32 array via block reduction.

    Stage 1 takes the top-``r`` of each flat ``block``-element chunk
    (one batched small sort); stage 2 runs ``lax.top_k`` over the
    ``nb*r`` survivors (~block/r times smaller than the full map).
    Replaces the full-map descending candidate sort of the reference
    (brisk/include/brisk/internal/score-calculator.h:66-85;
    scale-space-layer-inl.h:372-392) at a fraction of the sort cost.

    Tie order is IDENTICAL to ``lax.top_k`` (values descending, ties by
    ascending flat index) for every element above the sentinel: kept
    elements are enumerated in (block, rank) order, which restricted to
    any tied-value group is ascending-flat-index order.

    Exactness is data-dependent (a block with more than ``r`` entries
    at or above the global k-th value would have dropped candidates);
    the returned ``exact`` scalar certifies the call:

        exact = ~any(block_valid_count > r  AND  block_rth >= kth)

    When ``exact`` is False the result may differ from ``lax.top_k``
    for SENTINEL-tied tail entries or k-th-value ties only if a block
    overflowed into the relevant range — callers choosing this backend
    must size ``r`` with headroom over the per-block maxima of their
    data and may assert the flag in exactness gates.

    Only entries with value > INT32_MIN participate in the guarantee:
    the index order of the sentinel (invalid) tail differs from
    ``lax.top_k``'s, which downstream ignores (valid=False).
    """
    n = x.size
    nb = (n + block - 1) // block
    r = min(r, block)
    # Small maps (or k beyond the survivor count): no reduction is
    # possible — plain top_k, trivially exact.
    if k >= n or n <= block or nb * r <= k:
        v, i = jax.lax.top_k(x, k)
        return v, i, jnp.bool_(True)
    if nb * block != n:
        x = jnp.pad(x, (0, nb * block - n), constant_values=INT32_MIN)
    xb = x.reshape(nb, block)
    v1, i1 = jax.lax.top_k(xb, r)              # (nb, r)
    flat_idx = i1 + (jnp.arange(nb, dtype=i1.dtype) * block)[:, None]
    v2, i2 = jax.lax.top_k(v1.reshape(-1), k)
    idx = jnp.take(flat_idx.reshape(-1), i2)
    kth = v2[k - 1]
    counts = jnp.sum(xb > INT32_MIN, axis=1)
    exact = ~jnp.any((counts > r) & (v1[:, r - 1] >= kth))
    return v2, idx, exact
