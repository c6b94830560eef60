"""Greedy keypoint uniformity enforcement and bucketing.

Reference: ``EnforceKeyPointUniformity``
(``brisk/include/brisk/internal/uniformity-enforcement-inl.h:44-194``):
score-sorted greedy pass over candidates, painting a saturating-add
occupancy grid with a 31x31 radial LUT and rejecting candidates whose cell
exceeds ``sqrt(sqrt(score/maxScore))*255``; and ``KeyPointBucketing``
(``key-point-bucketing-inl.h:45-112``): per-grid-cell caps.

Dense design (exact): the greedy pass is sequential, but each
candidate only ever READS the occupancy value at its own cell, and the
uint8 saturating adds commute into ``min(255, sum of paints)`` (paints are
non-negative, so per-step clipping equals clipping the raw running sum).
That turns the reference's grid-walk into a *blocked interaction* scheme:

* process candidates in blocks of B (score order preserved);
* cross-block influence: NO occupancy grid at all — scattering 31x31
  paint patches per block serializes on colliding scatter rows. Instead a
  compact list of accepted candidates is maintained (capacity = the
  acceptance cap + one block of slack) and each block's pre-block
  occupancy reading is a fused (W, B) pairwise reduction against that
  list, windowed by the LIVE accepted count (windows of W; typically
  1-3 per block) — compute scales with actual accepts, and the paint
  values come from the same gathered LUT;
* the block loop stops once the cap is reached: capped greedy is a
  prefix of uncapped greedy (below), so later blocks cannot contribute;
* within-block influence is a (B, B) pairwise paint matrix gathered from
  the same 31x31 LUT (entry [j, i] = paint of accepted candidate j at
  candidate i's cell);
* the within-block sequential recurrence is solved by an exact
  interval-bound fixpoint instead of B sequential steps: a candidate's
  occupancy reading lies between "accepted predecessors only" (lower)
  and "accepted + still-undecided predecessors" (upper) — paints are
  non-negative, so the reading is monotone in the accept set. Each round
  resolves every candidate whose two bounds agree on the outcome; the
  earliest undecided candidate always resolves (its predecessors are all
  decided), so rounds ~= conflict-chain depth (a handful) rather than B.
  Each round is two (B,)x(B,B) integer contractions — VPU-trivial;
* the acceptance cap leaves the loop entirely: capped greedy equals the
  first-cap prefix (in candidate order) of the UNCAPPED accept list,
  because greedy decisions depend only on previously ACCEPTED candidates
  and the cap only cuts the tail — applied as a cumsum post-pass;
* blocks whose candidates are all invalid are skipped entirely
  (``while_loop``; candidates arrive sorted valid-first from top-k).

Bit-exact vs the sequential reference semantics: same paint values (the
LUT table itself is gathered, not recomputed), same read/clip points, same
acceptance condition and cap counting, same order
(enforce_uniformity_sequential below is the oracle; tests compare).
"""
from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


def radial_lut() -> np.ndarray:
    """The 31x31 radial falloff LUT (scale-space-layer-inl.h:89-97)."""
    xs = np.arange(31, dtype=np.float64)
    d2 = (15.0 - xs[None, :]) ** 2 + (15.0 - xs[:, None]) ** 2
    return np.maximum(1.0 - d2 / 225.0, 0.0).astype(np.float32)


@partial(
    jax.jit,
    static_argnames=("rows", "cols", "radius", "max_num_kpt", "block"),
)
def enforce_uniformity(
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    scores: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    rows: int,
    cols: int,
    radius: float,
    max_num_kpt: int,
    block: int = 256,
) -> jnp.ndarray:
    """Greedy uniformity mask over score-descending candidates.

    Args:
      xs, ys: (K,) int32 candidate coords (score-sorted, descending).
      scores: (K,) candidate scores (any numeric dtype).
      valid: (K,) bool.
      rows, cols: layer image size.
      radius: uniformity radius (> 0).
      max_num_kpt: acceptance cap.
      block: candidates per interaction block (power of two).

    Returns:
      (K,) bool acceptance mask (in the same candidate order).
    """
    k = xs.shape[0]
    scaling = np.float32(15.0 / radius)

    scores_f = scores.astype(jnp.float32)
    max_score = scores_f[0]  # candidates arrive sorted descending

    # nsc1 = sqrt(sqrt(score/max))*255 (uniformity-enforcement-inl.h:77).
    # Invalid candidates never paint or accept; zero their (possibly NaN
    # from INT32_MIN scores) nsc1 so masked arithmetic stays finite.
    nsc1 = jnp.sqrt(jnp.sqrt(scores_f / max_score)) * 255.0
    nsc1 = jnp.where(valid, nsc1, 0.0)
    cx = (xs.astype(jnp.float32) * scaling + 16.0).astype(jnp.int32)
    cy = (ys.astype(jnp.float32) * scaling + 16.0).astype(jnp.int32)

    b = min(block, k)
    n_blocks = -(-k // b)
    kp = n_blocks * b
    pad = kp - k

    def padded(a, fill):
        return jnp.pad(a, (0, pad), constant_values=fill).reshape(
            n_blocks, b
        )

    cx_b = padded(cx, 16)
    cy_b = padded(cy, 16)
    nsc1_b = padded(nsc1, 0.0)
    valid_b = padded(valid, False)
    block_live = jnp.any(valid_b, axis=1)  # skip all-invalid blocks

    # Compact accepted list: paints of empty slots are exactly zero
    # (nsc=0 -> ceil(lut*0) = 0), so windows never need count masking.
    cap_eff = min(max_num_kpt, kp)
    win = 256
    a_pad = -(-(cap_eff + b) // win) * win  # cap + terminal-block slack

    def pair_paint(px, py, pn, qx, qy):
        """Paint of candidates (px, py, pn) at cells (qx, qy): (P, Q) i32.

        Gather-free closed form: max(0, (225 - d2)/225) in f32 is
        BIT-IDENTICAL to the f64-built radial LUT for every integer d2
        (one correctly-rounded division vs f64-then-cast — verified
        exhaustively), and it extends the 31x31 patch with exact zeros
        (any |dy| or |dx| > 15 implies d2 >= 256 > 225), so no inside
        mask is needed. Replaces a (P*Q)-element table gather."""
        dy = (qy[None, :] - py[:, None]).astype(jnp.float32)
        dx = (qx[None, :] - px[:, None]).astype(jnp.float32)
        d2 = dy * dy + dx * dx
        lutv = jnp.maximum((np.float32(225.0) - d2) / np.float32(225.0),
                           np.float32(0.0))
        return jnp.ceil(lutv * (0.99 * pn[:, None])).astype(jnp.int32)

    def run_block(bi, st):
        acc_x, acc_y, acc_n, count = st
        bcx, bcy = cx_b[bi], cy_b[bi]
        bnsc, bval = nsc1_b[bi], valid_b[bi]

        # Pre-block occupancy reading at each candidate's cell: fused
        # pairwise reduction against the accepted list, windowed by the
        # live count (all list entries precede this block in order).
        n_win = (count + (win - 1)) // win

        def wcond(wst):
            return wst[0] < n_win

        def wstep(wst):
            wi, s = wst
            ax = jax.lax.dynamic_slice(acc_x, (wi * win,), (win,))
            ay = jax.lax.dynamic_slice(acc_y, (wi * win,), (win,))
            an = jax.lax.dynamic_slice(acc_n, (wi * win,), (win,))
            s = s + jnp.sum(
                pair_paint(ax, ay, an, bcx, bcy), axis=0,
                dtype=jnp.int32,  # x64 mode promotes int32 sums
            )
            return wi + 1, s

        _, base = jax.lax.while_loop(
            wcond, wstep, (jnp.int32(0), jnp.zeros((b,), jnp.int32))
        )

        # Within-block pairwise paint, zero when j >= i (only EARLIER
        # candidates' paints are read by the greedy pass).
        tri = jnp.arange(b)[:, None] < jnp.arange(b)[None, :]  # j < i
        m = jnp.where(tri, pair_paint(bcx, bcy, bnsc, bcx, bcy), 0)

        # Interval-bound fixpoint (module docstring): resolve candidates
        # whose lower/upper occupancy bounds agree on the outcome.
        def fix_cond(fst):
            acc, und = fst
            return jnp.any(und)

        def fix_step(fst):
            acc, und = fst
            s_lo = acc.astype(jnp.int32) @ m            # accepted only
            s_hi = (acc | und).astype(jnp.int32) @ m    # + undecided
            lo = jnp.minimum(base + s_lo, 255).astype(jnp.float32)
            hi = jnp.minimum(base + s_hi, 255).astype(jnp.float32)
            acc_new = und & ~(bnsc < hi)   # passes even the upper bound
            rej_new = und & (bnsc < lo)    # fails even the lower bound
            return acc | acc_new, und & ~(acc_new | rej_new)

        acc0 = jnp.zeros((b,), bool)
        accept_blk, _ = jax.lax.while_loop(
            fix_cond, fix_step, (acc0, bval)
        )

        # Append accepted candidates to the list (tiny 1-D scatter;
        # overflow beyond capacity only possible in the terminal block,
        # after which the loop stops — dropped entries are irrelevant).
        pos = count + jnp.cumsum(
            accept_blk.astype(jnp.int32), dtype=jnp.int32
        ) - 1
        tgt = jnp.where(accept_blk, pos, a_pad).astype(jnp.int32)
        acc_x = acc_x.at[tgt].set(bcx, mode="drop")
        acc_y = acc_y.at[tgt].set(bcy, mode="drop")
        acc_n = acc_n.at[tgt].set(bnsc, mode="drop")
        count = count + jnp.sum(
            accept_blk.astype(jnp.int32), dtype=jnp.int32
        )
        return (acc_x, acc_y, acc_n, count), accept_blk

    def cond(state):
        bi, lst, accept = state
        # Stop at the cap: capped greedy is a prefix of uncapped greedy,
        # so once `cap_eff` candidates are accepted no later block can
        # change the (capped) output.
        return (
            (bi < n_blocks)
            & block_live[jnp.minimum(bi, n_blocks - 1)]
            & (lst[3] < cap_eff)
        )

    def step(state):
        bi, lst, accept = state
        lst, accept_blk = run_block(bi, lst)
        accept = jax.lax.dynamic_update_slice(accept, accept_blk, (bi * b,))
        return bi + 1, lst, accept

    lst0 = (
        jnp.full((a_pad,), 16, jnp.int32),
        jnp.full((a_pad,), 16, jnp.int32),
        jnp.zeros((a_pad,), jnp.float32),
        jnp.int32(0),
    )
    accept0 = jnp.zeros((kp,), bool)
    _, _, accept = jax.lax.while_loop(
        cond, step, (jnp.int32(0), lst0, accept0)
    )
    accept = accept[:k]
    # Acceptance cap: capped greedy == first-cap prefix of the uncapped
    # accept list (greedy reads only ACCEPTED predecessors; the cap only
    # truncates the tail).
    return accept & (
        jnp.cumsum(accept.astype(jnp.int32), dtype=jnp.int32)
        <= max_num_kpt
    )


@partial(
    jax.jit, static_argnames=("rows", "cols", "radius", "max_num_kpt")
)
def enforce_uniformity_sequential(
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    scores: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    rows: int,
    cols: int,
    radius: float,
    max_num_kpt: int,
) -> jnp.ndarray:
    """Direct per-candidate transcription of the reference's greedy loop
    (uint8 occupancy grid, one 31x31 patch update per accepted candidate).

    Kept as the semantics oracle for `enforce_uniformity` (the blocked
    production path); much slower.
    """
    k = xs.shape[0]
    scaling = np.float32(15.0 / radius)
    occ_rows = rows * int(math.ceil(scaling)) + 32
    occ_cols = cols * int(math.ceil(scaling)) + 32
    lut = jnp.asarray(radial_lut())

    scores_f = scores.astype(jnp.float32)
    max_score = scores_f[0]
    nsc1 = jnp.sqrt(jnp.sqrt(scores_f / max_score)) * 255.0
    cx = (xs.astype(jnp.float32) * scaling + 16.0).astype(jnp.int32)
    cy = (ys.astype(jnp.float32) * scaling + 16.0).astype(jnp.int32)

    def body(i, state):
        occupancy, accept, n_acc = state
        s0 = occupancy[cy[i], cx[i]].astype(jnp.float32)
        ok = valid[i] & (n_acc < max_num_kpt) & ~(nsc1[i] < s0)

        patch = jax.lax.dynamic_slice(
            occupancy, (cy[i] - 15, cx[i] - 15), (31, 31)
        )
        paint = jnp.ceil(lut * (0.99 * nsc1[i])).astype(jnp.int32)
        new_patch = jnp.minimum(patch.astype(jnp.int32) + paint, 255).astype(
            jnp.uint8
        )
        occupancy = jax.lax.cond(
            ok,
            lambda o: jax.lax.dynamic_update_slice(
                o, new_patch, (cy[i] - 15, cx[i] - 15)
            ),
            lambda o: o,
            occupancy,
        )
        accept = accept.at[i].set(ok)
        return occupancy, accept, n_acc + ok.astype(jnp.int32)

    occupancy0 = jnp.zeros((occ_rows, occ_cols), jnp.uint8)
    accept0 = jnp.zeros((k,), bool)
    _, accept, _ = jax.lax.fori_loop(
        0, k, body, (occupancy0, accept0, jnp.int32(0))
    )
    return accept


def bucket_keypoints(
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    valid: jnp.ndarray,
    *,
    rows: int,
    cols: int,
    max_num_kpt: int,
    num_buckets_u: int,
    num_buckets_v: int,
) -> jnp.ndarray:
    """KeyPointBucketing mask (key-point-bucketing-inl.h:45-112).

    Candidates must be score-sorted descending. Single-bucket mode keeps the
    top max_num_kpt; otherwise each UxV cell keeps its first
    ceil(max/(U*V)) arrivals.
    """
    k = xs.shape[0]
    order_rank = jnp.cumsum(valid.astype(jnp.int32)) - 1  # rank among valid
    if num_buckets_u == 1 or num_buckets_v == 1:
        return valid & (order_rank < max_num_kpt)

    # Reference: cap = max/(U*V) (floor); step = 1 + (dim-1)/buckets
    # (key-point-bucketing.h:64-66).
    per_bucket = max_num_kpt // (num_buckets_u * num_buckets_v)
    step_u = 1 + (cols - 1) // num_buckets_u
    step_v = 1 + (rows - 1) // num_buckets_v
    bu = xs // step_u
    bv = ys // step_v
    bucket_id = bu * num_buckets_v + bv

    # Rank within bucket among valid candidates (score order preserved).
    one_hot = (
        bucket_id[:, None]
        == jnp.arange(num_buckets_u * num_buckets_v)[None, :]
    ) & valid[:, None]
    rank_in_bucket = jnp.cumsum(one_hot.astype(jnp.int32), axis=0) - 1
    my_rank = jnp.take_along_axis(
        rank_in_bucket, bucket_id[:, None], axis=1
    )[:, 0]
    return valid & (my_rank < per_bucket)
