"""Exact sequential emulation of the reference's lazy score cache.

The reference's AST detection (brisk-scale-space.cc:92-287) is order-
dependent in exactly ONE place: the IsMax2D tie path (:482-530) reads the
``scores_`` matrix RAW, and its content depends on which earlier
GetAgastScore calls wrote which pixels (brisk-layer.cc:118-132).

Key structure (derived in round 2, validated against the C++):

* All GetAgastScore(x, y, 1) reads return the dense threshold-1 cache
  value regardless of history (stored <= 2 is recomputed; stored > 2 IS
  that value) — so every probe/refinement VALUE is order-independent and
  stays vectorized.
* Neighbor compares in IsMax2D (threshold = center) are also history-
  independent: an activated pixel returns t* instead of 0 only when
  t* < center, and both compare as "not greater" / "not equal".
* Only the raw tie reads see history. The cache state at pixel q is:
    - corner: the GetAgastPoints seed (max(t*, thrmap), > 2 for any sane
      config, never overwritten);
    - t* > 2: t* once ANY earlier toucher wrote with threshold <= t*
      (neighbor query with center <= t*, or any threshold-1 patch write),
      else 0;
    - 1 <= t* <= 2: the LAST writer decides (threshold-1 write -> t*,
      neighbor query with center > t* -> 0);
    - t* == 0 or out of [3, n-4): 0.
* Write events, in program order per layer:
    1. corner seeds (GetAgastPoints);
    2. prefill: the previous layer's accepted candidates' GetScoreMaxAbove
       probes (:757-867) — threshold-1 writes over an early-exit-exact
       scan prefix, plus the 3x3 around the scan max when completed;
    3. per candidate (row-major detect order):
       a. the 8 IsMax2D neighbor queries UP TO the first failing compare
          (early return skips the rest — affects the write set);
       b. if IsMax2D passes and the (order-independent) 3D gates pass,
          the same-layer 3x3 threshold-1 patch (:600-610 / :232-240).

This module computes exact per-layer IsMax2D masks with a bounded
``lax.fori_loop`` over candidates carrying the dense cache (3a/3b), and
exact above-scan touch stamps for the prefill (2) — everything else
reuses the vectorized machinery in ast_scale_space.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.detect.ast_layer import AstLayerMaps

f32 = jnp.float32

_NEIGH8 = (
    (-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, 1), (1, -1), (-1, -1),
)
_TIE_ORDER = (
    (-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1),
)


def _trunc_i32(x):
    return jnp.trunc(x).astype(jnp.int32)


def above_scan_stamps(
    neighbor: AstLayerMaps,
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    thr: jnp.ndarray,
    mode: str,  # above_octave | above_intra
    drop: int | None = None,
):
    """Exact GetScoreMaxAbove touch stamps (brisk-scale-space.cc:757-867).

    Returns (anchor_x, anchor_y, stamp (K, 3, 3) bool): the set of
    neighbor-layer pixels written (threshold-1) by the scan, honoring the
    early drop-threshold exit (a probe runs iff no earlier checked probe
    exceeded; its own taps land regardless of its own outcome), the
    missing check on the bottom row, and the final 3x3 around the
    first-strict-maximum when the scan completes.
    """
    from ethzasl_brisk_jax.detect.ast_scale_space import (
        K_DROP_THRESHOLD,
        _bilinear_score,
        _cache_score,
    )

    if drop is None:
        drop = K_DROP_THRESHOLD
    threshold = (thr + drop).astype(f32)
    xsf = xs.astype(f32)
    ysf = ys.astype(f32)
    # Literal types mirror the reference: octave `/ 6.0` is a DOUBLE
    # division (:777), intra `/ 8.0f` is float (:783).
    if mode == "above_octave":
        from ethzasl_brisk_jax.detect.ast_scale_space import _dbl_div

        x_1 = _dbl_div((4 * xs - 3).astype(f32), 6.0)
        x1 = _dbl_div((4 * xs + 1).astype(f32), 6.0)
        y_1 = _dbl_div((4 * ys - 3).astype(f32), 6.0)
        y1 = _dbl_div((4 * ys + 1).astype(f32), 6.0)
    elif mode == "above_intra":
        x_1 = (f32(6.0) * xsf - 4) / f32(8.0)
        x1 = (f32(6.0) * xsf + 2) / f32(8.0)
        y_1 = (f32(6.0) * ysf - 4) / f32(8.0)
        y1 = (f32(6.0) * ysf + 2) / f32(8.0)
    else:
        raise ValueError(mode)

    ax = _trunc_i32(x_1)          # anchor = floor (coords positive)
    ay = _trunc_i32(y_1)
    ix_first = _trunc_i32(x_1 + 1)
    ix_last = _trunc_i32(x1)
    iy_first = _trunc_i32(y_1 + 1)
    iy_last = _trunc_i32(y1)

    k = xs.shape[0]
    # 5x5 stamp anchored at (ax-1, ay-1): the scan itself touches
    # [ax, ax+2] x [ay, ay+2], but the final 3x3 around the scan maximum
    # extends ONE cell beyond on every side (e.g. a bottom-float-row
    # maximum at my = trunc(y1) = ay writes row ay-1 — observed in the
    # compiled reference: GSMA L0 (479,340) storing layer-1 (319,225)).
    grid = jnp.zeros((k, 5, 5), bool)
    rr = jnp.arange(5)[None, :, None]
    cc = jnp.arange(5)[None, None, :]

    def mark(g, X, Y, active, bilinear):
        """Mark the taps of one probe: (X, Y) plus the 2x2 block for
        bilinear probes (the float overload always reads all 4)."""
        rx = (X - ax + 1)[:, None, None]
        ry = (Y - ay + 1)[:, None, None]
        act = active[:, None, None]
        m = act & (rr == ry) & (cc == rx)
        if bilinear:
            m |= act & (rr == ry) & (cc == rx + 1)
            m |= act & (rr == ry + 1) & (cc == rx)
            m |= act & (rr == ry + 1) & (cc == rx + 1)
        return g | m

    cols = [("f", x_1), ("i", ix_first), ("f", x1)]
    rows = [("f", y_1, True), ("i", iy_first, True), ("f", y1, False)]
    col_exists = [None, ix_first <= ix_last, None]
    row_exists = [None, iy_first <= iy_last, None]

    exceeded = jnp.zeros((k,), bool)
    first = True
    mx = ix_first
    my = iy_first
    best = None

    for (rkind, rval, rcheck), rex in zip(rows, row_exists):
        for ci, ((ckind, cval), cex) in enumerate(zip(cols, col_exists)):
            exists = jnp.ones((k,), bool)
            if cex is not None:
                exists &= cex
            if rex is not None:
                exists &= rex
            runs = exists & ~exceeded
            if ckind == "i" and rkind == "i":
                v = _cache_score(neighbor, cval, rval).astype(f32)
                grid = mark(grid, cval, rval, runs, bilinear=False)
                X, Y = cval, rval
            else:
                xf = cval.astype(f32) if ckind == "i" else cval
                yf = rval.astype(f32) if rkind == "i" else rval
                v = _bilinear_score(neighbor, xf, yf)
                X = _trunc_i32(xf)
                Y = _trunc_i32(yf)
                grid = mark(grid, X, Y, runs, bilinear=True)
            px = cval if ckind == "i" else (
                ix_first if ci == 0 else _trunc_i32(cval)
            )
            py = rval if rkind == "i" else (
                iy_first if rkind == "f" and rval is y_1 else _trunc_i32(rval)
            )
            if first:
                best = v
                first = False
                if rcheck:
                    exceeded |= v > threshold
                continue
            if rcheck:
                exceeded |= runs & (v > threshold)
            upd = runs & (v > best)
            best = jnp.where(upd, v, best)
            mx = jnp.where(upd, px, mx)
            my = jnp.where(upd, py, my)

    # Final 3x3 around the maximum — only when the scan completed.
    done = ~exceeded
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            grid = mark(grid, mx + dx, my + dy, done, bilinear=False)
    return ax, ay, grid


def scatter_stamps(layer: AstLayerMaps, ax, ay, stamp, active):
    """OR the (K, 5, 5) stamps of active candidates into a dense map,
    restricted to the writable region [3, n-4) (GetAgastScore guard)."""
    h, w = layer.img.shape
    out = jnp.zeros((h, w), bool)
    for r in range(5):
        for c in range(5):
            qx = ax + c - 1
            qy = ay + r - 1
            ok = (
                active
                & stamp[:, r, c]
                & (qx >= 3) & (qy >= 3) & (qx < w - 3) & (qy < h - 3)
            )
            out = out.at[jnp.clip(qy, 0, h - 1), jnp.clip(qx, 0, w - 1)].max(
                ok
            )
    return out


def exact_is2d_layer(
    layer: AstLayerMaps,
    xs: jnp.ndarray,        # (K,) candidate coords, row-major order
    ys: jnp.ndarray,
    valid: jnp.ndarray,     # (K,) bool
    patch_gate: jnp.ndarray,  # (K,) bool: 3D gates for the same-layer 3x3
    prefill: jnp.ndarray,   # (H, W) bool threshold-1 prefill from below
    float_patch: bool = False,
) -> jnp.ndarray:
    """Sequential-exact IsMax2D over one layer's candidates.

    Carries the dense stored-score map through a fori_loop, reproducing:
    corner seeds, prefill, per-candidate neighbor-query writes up to the
    first failing compare, raw tie reads, and accepted candidates'
    same-layer 3x3 threshold-1 writes (gated on the 3D checks).

    ``float_patch``: the LAST-layer / single-layer branches pass FLOAT
    keypoint coords to GetAgastScore (brisk-scale-space.cc:186-194,
    :227, :233-241), resolving to the bilinear overload whose integer-
    coordinate reads still touch the 2x2 block (x..x+1, y..y+1) through
    GetAgastScore(int, 1) (brisk-layer.cc:157-160).  Net per-candidate
    footprint: the GetScoreMaxBelow threshold argument seeds the own
    2x2 after IsMax2D passes (regardless of the 3D gate), and the 3x3
    patch gather seeds the 4x4 block (x-1..x+2, y-1..y+2) when the
    gate passes.  Observed in the compiled reference: (106,49)=43 on
    img1 layer 5 seeded by (104,49)'s patch read at float (105.0,
    48.0), flipping (105,49)'s tie-break sum from 482 to 587.
    """
    h, w = layer.img.shape
    k = xs.shape[0]
    t_nc = jnp.maximum(layer.t_star, 0)  # threshold-1 write value

    # Initial stored map: corners seeded, prefilled pixels at t*.
    stored0 = jnp.where(
        layer.corner,
        layer.cache,
        jnp.where(prefill, t_nc, 0),
    ).astype(jnp.int32)

    # ---- Order-independent precomputation (vectorized). ----
    # A neighbor query GetAgastScore(q, center) returns
    #   stored(q) if stored(q) > 2 else (t*(q) if t*(q) >= center else 0).
    # Both branches compare identically against center (a pre-touched
    # non-corner's stored t* is < center exactly when fresh would be 0),
    # and tie flags (center == s) are also history-independent
    # (t* == center ties in either branch). Only the tie path's
    # *smoothedcenter sum* needs the live values (computed in-loop).
    center = layer.cache[ys, xs]  # corner seeds (= raw read at candidate)
    s_vals = []
    q_ok = []
    wvals = []
    for dx, dy in _NEIGH8:
        qx = xs + dx
        qy = ys + dy
        inb = (qx >= 3) & (qy >= 3) & (qx < w - 3) & (qy < h - 3)
        is_c = layer.corner[qy, qx]
        cache_q = layer.cache[qy, qx]
        t_q = layer.t_star[qy, qx]
        fresh = jnp.where(t_q >= center, t_q, 0)
        s = jnp.where(inb, jnp.where(is_c, cache_q, fresh), 0)
        s_vals.append(s)
        q_ok.append(inb)
        wvals.append(jnp.where(t_q >= center, jnp.maximum(t_q, 0), 0))
    s_arr = jnp.stack(s_vals, 1)      # (K, 8)
    inb_arr = jnp.stack(q_ok, 1)
    wval_arr = jnp.stack(wvals, 1)    # value a neighbor query would store
    fresh_arr = s_arr                 # query value when stored <= 2

    reject_at = center[:, None] < s_arr          # (K, 8)
    any_rej = jnp.any(reject_at, axis=1)
    first_rej = jnp.argmax(reject_at, axis=1)    # valid when any_rej
    fail_j = jnp.where(any_rej, first_rej, 8)
    passed_compares = ~any_rej
    # Neighbor j is queried (and written) iff j <= fail_j.
    queried = jnp.arange(8)[None, :] <= fail_j[:, None]  # (K, 8)

    # Tie flags in the reference's delta order.
    neigh_index = {d: j for j, d in enumerate(_NEIGH8)}
    tie_flags = jnp.stack(
        [center == s_arr[:, neigh_index[d]] for d in _TIE_ORDER], 1
    )  # (K, 8)

    nb_dx = jnp.asarray([d[0] for d in _NEIGH8])
    nb_dy = jnp.asarray([d[1] for d in _NEIGH8])
    tie_dx = jnp.asarray([d[0] for d in _TIE_ORDER])
    tie_dy = jnp.asarray([d[1] for d in _TIE_ORDER])

    # Raw tie-read offsets: 3x3 around each tied neighbor, weights
    # [[1,2,1],[2,4,2],[1,2,1]] (brisk-scale-space.cc:505-529).
    wgt = jnp.asarray([[1, 2, 1], [2, 4, 2], [1, 2, 1]], jnp.int32)

    def body(c, carry):
        stored, acc = carry
        x = xs[c]
        y = ys[c]
        ok_c = valid[c]

        # --- 3a: neighbor-query writes (prefix up to first fail).
        qx = x + nb_dx
        qy = y + nb_dy
        do_w = ok_c & queried[c] & inb_arr[c]
        old = stored[qy, qx]
        new = jnp.where(do_w & (old <= 2), wval_arr[c], old)
        stored = stored.at[qy, qx].set(new)

        # Live query values: stored>2 returns the stored history value
        # (brisk-layer.cc:124-125), else the fresh recompute.
        s_live = jnp.where(
            inb_arr[c] & (old > 2), old, fresh_arr[c]
        )  # (8,) in _NEIGH8 order
        smoothed_center = (
            4 * center[c]
            + 2 * (s_live[0] + s_live[1] + s_live[2] + s_live[3])
            + s_live[4] + s_live[5] + s_live[6] + s_live[7]
        )

        # --- Tie path: raw reads from the live stored map.
        is2d_c = ok_c & passed_compares[c]
        othercenters = []
        for j in range(8):
            ox = x + tie_dx[j]
            oy = y + tie_dy[j]
            s = jnp.int32(0)
            for r in range(3):
                for cc_ in range(3):
                    s = s + wgt[r, cc_] * stored[oy + r - 1, ox + cc_ - 1]
            othercenters.append(s)
        oc = jnp.stack(othercenters)
        tie_rej = jnp.any(
            tie_flags[c] & (oc > smoothed_center)
        )
        is2d_c &= ~tie_rej

        # --- 3b: same-layer threshold-1 writes (gated).
        do_patch = is2d_c & patch_gate[c]
        if float_patch:
            # Bilinear float-coord calls: own 2x2 on is2d alone (the
            # GetScoreMaxBelow threshold argument), 4x4 with the gate
            # (each of the 9 float patch reads touches a 2x2).
            writes = [
                ((0, 0), False), ((1, 0), False),
                ((0, 1), False), ((1, 1), False),
            ] + [
                ((dx_, dy_), True)
                for dy_ in (-1, 0, 1, 2)
                for dx_ in (-1, 0, 1, 2)
            ]
        else:
            writes = [
                ((dx_, dy_), True)
                for dy_ in (-1, 0, 1)
                for dx_ in (-1, 0, 1)
            ]
        for (dx_, dy_), gated in writes:
            px = x + dx_
            py = y + dy_
            pin = (
                (do_patch if gated else is2d_c)
                & (px >= 3) & (py >= 3) & (px < w - 3) & (py < h - 3)
            )
            oldp = stored[py, px]
            stored = stored.at[py, px].set(
                jnp.where(pin & (oldp <= 2), t_nc[py, px], oldp)
            )

        return stored, acc.at[c].set(is2d_c)

    _, is2d = jax.lax.fori_loop(
        0, k, body, (stored0, jnp.zeros((k,), bool))
    )
    return is2d
