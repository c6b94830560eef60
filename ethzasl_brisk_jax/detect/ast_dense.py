"""Dense (whole-map) BRISK-AST detection — the per-candidate decisions
of ``ast_scale_space.py`` computed over full layer maps.

The candidate path evaluates IsMax2D / Refine3D / GetScoreMaxAbove/Below
(brisk-scale-space.cc:430-1099) per candidate through random-access
gathers. This module computes the SAME decisions densely:

* every probe of the cross-layer scans samples the neighbour layer at
  coordinates that are affine per axis, so a probe over all pixels is an
  AXIS-SEPARABLE resample (two 1-D takes) — the same trick as the
  Harris path's ``warp_scores_split``;
* the IsMax2D neighbour/tie-path reads become shifted-map arithmetic;
* the data-dependent sub-pixel patch around the scan argmax is a small
  one-hot select over a static grid of pre-resampled maps (the argmax
  position offset ranges over {-1, 0, 1} per axis);
* the aux cache-emulation maps (earliest-toucher, patch stamps, above-
  scan prefill) were already dense; the candidate scatters they were
  built from become direct mask arithmetic plus an axis-separable
  interval stamp (cumsum + searchsorted) for the prefill windows.

Per-candidate work then shrinks to ONE final gather of the decision /
field maps at the corner pixels. Output is bitwise-identical to
``detect_ast_keypoints(raw_cache_model="emulated")`` whenever the
per-layer candidate capacities do not truncate (tests/test_ast_dense.py
pins this on the reference images).

Reference anchors: brisk/src/brisk-scale-space.cc:92-287 (GetKeypoints),
:430-531 (IsMax2D), :534-754 (Refine3D), :757-1099 (GetScoreMaxAbove/
Below), :1101-1364 (Refine1D*/Subpixel2D).
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.detect.ast_layer import AstLayerMaps
from ethzasl_brisk_jax.detect.ast_scale_space import (
    _NEIGH8,
    _TIE_ORDER,
    K_BASIC_SIZE,
    K_DROP_THRESHOLD,
    K_MAX_THRESHOLD,
    K_MIN_DROP,
    AstDiagnostics,
    _bilinear_from,
    _dbl,
    _dbl_div,
    _fmul,
    _nf,
    _shift_bool,
    _shift_i32,
    _trunc_i32,
    ast_subpixel2d,
    build_ast_pyramid,
    earliest_toucher_map,
    f32,
    refine1d,
    refine1d_1,
    refine1d_2,
)
from ethzasl_brisk_jax.kernels.agast import agast5_8_score_map

_INF = jnp.int32(2**31 - 1)


def _sep_pick(cache: jnp.ndarray, xv: jnp.ndarray, yv: jnp.ndarray):
    """Dense ``_cache_score`` at per-axis positions.

    out[y, x] = cache[yv[y], xv[x]] where (xv[x], yv[y]) lies in the
    [3, n-4] interior, else 0 — exactly the border semantics of
    ``_cache_score`` (GetAgastScore(x, y, 1), brisk-layer.cc:118-132).
    Axis-separable: two 1-D takes, no 2-D gather.
    """
    h_n, w_n = cache.shape
    xv = xv.reshape(-1)
    yv = yv.reshape(-1)
    okx = (xv >= 3) & (xv < w_n - 3)
    oky = (yv >= 3) & (yv < h_n - 3)
    rows = jnp.take(cache, jnp.clip(yv, 0, h_n - 1), axis=0)
    vals = jnp.take(rows, jnp.clip(xv, 0, w_n - 1), axis=1)
    return jnp.where(oky[:, None] & okx[None, :], vals, 0)


_GRID_OFFS = (-2, -1, 0, 1, 2, 3)
# Per-2048-block top-r budget for the corner-extraction block top-k
# (max per-block corner count is certified by ast_capacity_diagnostics).
_EXTRACT_BLOCK_R = 256


def _stairs_np(n: int, mode: str):
    """Static numpy twin of the scan's per-axis index staircases
    (ix_first, ix_last): replicates the traced f32/f64 literal-type
    chains op for op. The truncations are backend-robust: every
    division either has an odd numerator over 6 (true value >= 1/6 from
    any integer, vastly beyond any <=2-ulp division error) or is exact
    (power-of-two denominators / integer-valued results), so numpy,
    and every XLA backend agree on every trunc. Pinned against the traced
    chain by tests/test_ast_dense.py::test_stairs_twin."""
    import jax as _jax
    import numpy as _np

    use64 = _jax.config.jax_enable_x64
    x = _np.arange(n, dtype=_np.int64)
    f32n = _np.float32

    def dbl_div(num_i, denom):
        num = num_i.astype(_np.float32)
        if use64:
            return (num.astype(_np.float64) / denom).astype(_np.float32)
        return num / f32n(denom)

    def fmul(a, b):
        if use64:
            return (
                _np.asarray(a, _np.float64) * _np.asarray(b, _np.float64)
            ).astype(_np.float32)
        return (_np.asarray(a, _np.float32)
                * _np.asarray(b, _np.float32)).astype(_np.float32)

    if mode == "above_octave":
        x_1 = dbl_div(4 * x - 3, 6.0)
        x1 = dbl_div(4 * x + 1, 6.0)
    elif mode == "above_intra":
        xsf = x.astype(_np.float32)
        x_1 = (fmul(f32n(6.0), xsf) - 4) / f32n(8.0)
        x1 = (fmul(f32n(6.0), xsf) + 2) / f32n(8.0)
    elif mode == "below_octave":
        x_1 = dbl_div(8 * x - 3, 6.0)
        x1 = dbl_div(8 * x + 5, 6.0)
    else:
        x_1 = dbl_div(6 * x - 2, 4.0)
        x1 = dbl_div(6 * x + 4, 4.0)
    first = _np.trunc(
        (x_1 + _np.float32(1.0)).astype(_np.float32)
    ).astype(_np.int64)
    last = _np.trunc(x1).astype(_np.int64)
    return first, last


def dense_score_patch_max(
    neighbor: AstLayerMaps,
    dst_shape: tuple[int, int],
    thr: jnp.ndarray,        # (h, w) center-score map of the dst layer
    mode: str,               # above_octave|above_intra|below_octave|below_intra
    drop: int = K_DROP_THRESHOLD,
    _probes_only: bool = False,   # profiling: stop after the scan loop
):
    """Dense GetScoreMaxAbove/Below (brisk-scale-space.cc:757-1099).

    Returns (ismax, score, dx, dy) full maps over the destination layer
    — the candidate path's ``_score_patch_max`` evaluated at every
    pixel. Probe math, scan order, first-strict-maximum rule, the
    below-scan smoothing tie-break, the missing threshold check on the
    bottom row and the final Subpixel2D + back-conversion literal types
    all mirror the candidate code line for line; x-quantities live as
    (1, w) arrays and y-quantities as (h, 1) so every elementwise chain
    broadcasts to (h, w) with identical op order.

    Every read this scan makes — int probes, bilinear taps, the
    tie-break smoothing sums, the data-dependent sub-pixel patch — lies
    at a per-axis offset in a 4-wide window of (ix_first, iy_first), so
    the whole scan's memory traffic is a 4x4 uint8 offset grid built
    from STATIC periodic strided slices (no gather at all — the index
    staircases are exact numpy twins, _stairs_np); everything
    downstream is elementwise selects over grid slices.
    """
    h, w = dst_shape
    threshold = (thr + drop).astype(f32)
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]    # (1, w)
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]    # (h, 1)
    xsf = xs.astype(f32)
    ysf = ys.astype(f32)

    # Scan-window coords; literal types per reference site (see the
    # candidate path for the site list).
    if mode == "above_octave":
        x_1 = _dbl_div((4 * xs - 3).astype(f32), 6.0)
        x1 = _dbl_div((4 * xs + 1).astype(f32), 6.0)
        y_1 = _dbl_div((4 * ys - 3).astype(f32), 6.0)
        y1 = _dbl_div((4 * ys + 1).astype(f32), 6.0)
        n_int = 1
        tie_break = False
    elif mode == "above_intra":
        x_1 = (_fmul(f32(6.0), xsf) - 4) / f32(8.0)
        x1 = (_fmul(f32(6.0), xsf) + 2) / f32(8.0)
        y_1 = (_fmul(f32(6.0), ysf) - 4) / f32(8.0)
        y1 = (_fmul(f32(6.0), ysf) + 2) / f32(8.0)
        n_int = 1
        tie_break = False
    elif mode == "below_octave":
        x_1 = _dbl_div((8 * xs - 3).astype(f32), 6.0)
        x1 = _dbl_div((8 * xs + 5).astype(f32), 6.0)
        y_1 = _dbl_div((8 * ys - 3).astype(f32), 6.0)
        y1 = _dbl_div((8 * ys + 5).astype(f32), 6.0)
        n_int = 2
        tie_break = True
    elif mode == "below_intra":
        x_1 = _dbl_div((6 * xs - 2).astype(f32), 4.0)
        x1 = _dbl_div((6 * xs + 4).astype(f32), 4.0)
        y_1 = _dbl_div((6 * ys - 2).astype(f32), 4.0)
        y1 = _dbl_div((6 * ys + 4).astype(f32), 4.0)
        n_int = 2
        tie_break = True
    else:
        raise ValueError(mode)

    ix_first = _trunc_i32(x_1 + 1)    # (1, w)
    ix_last = _trunc_i32(x1)
    iy_first = _trunc_i32(y_1 + 1)    # (h, 1)
    iy_last = _trunc_i32(y1)
    t_xl = ix_last - ix_first         # last-col position offset, {-1..1}
    t_yl = iy_last - iy_first

    cache = neighbor.cache
    h_n, w_n = cache.shape
    ixf = ix_first.reshape(-1)
    iyf = iy_first.reshape(-1)

    # Batched 4x4 offset grid: ONE row-take + ONE col-take cover every
    # read of the scan. grid[j, :, k, :] = cache[iy_first + j,
    # ix_first + k] with the [3, n-4] _cache_score border zeroed.
    # Offset range per mode: scan positions sit at {-1, 0} (above; the
    # last float col can land one left of ix_first) or {0, 1} (below;
    # a second int col), and probes/patch/tie taps reach +-1 of those
    # plus the bilinear's +1 — a 4-offset window per axis. The take
    # runs on a uint8 view (cache = max(t*, thrmap) <= 255): gathers
    # here are bandwidth-bound and the grid is the scan's largest
    # buffer (4x smaller in u8; consumers upcast fused).
    offs = (-2, -1, 0, 1) if n_int == 1 else (-1, 0, 1, 2)
    pos_offs = (-1, 0) if n_int == 1 else (0, 1)
    cache_u8 = cache.astype(jnp.uint8)
    # STATIC index staircases (numpy twin of the traced chain — exact,
    # see _stairs_np) turn every grid take into zero-padded strided
    # slices + interleaves (scale_space._periodic_take): no gather at
    # all in the grid build.
    import numpy as _np

    from ethzasl_brisk_jax.detect.scale_space import _periodic_take

    ixf_np, _ = _stairs_np(w, mode)
    iyf_np, _ = _stairs_np(h, mode)
    rows_j = {
        j: _periodic_take(cache_u8, iyf_np + j, 0) for j in offs
    }
    oky = {
        j: jnp.asarray(((iyf_np + j) >= 3) & ((iyf_np + j) < h_n - 3))
        for j in offs
    }
    okx = {
        k: jnp.asarray(((ixf_np + k) >= 3) & ((ixf_np + k) < w_n - 3))
        for k in offs
    }
    D = {
        (j, k): jnp.where(
            oky[j][:, None] & okx[k][None, :],
            _periodic_take(rows_j[j], ixf_np + k, 1).astype(jnp.int32),
            0,
        )
        for j in offs
        for k in offs
    }

    def pick_sel(cx_off, cx_vals, cy_off, cy_vals):
        """_cache_score at grid offsets: one-hot select over the small
        per-axis offset value sets (elementwise, fuses; no gather)."""
        if len(cx_vals) == 1 and len(cy_vals) == 1:
            return D[(cy_vals[0], cx_vals[0])]
        out = jnp.zeros((h, w), jnp.int32)
        for kv in cx_vals:
            mx = True if len(cx_vals) == 1 else (cx_off == kv)
            for jv in cy_vals:
                m = mx if len(cy_vals) == 1 else (
                    (cy_off == jv) & mx if mx is not True
                    else (cy_off == jv)
                )
                d = D[(jv, kv)]
                out = d if m is True else out + jnp.where(m, d, 0)
        return out

    def sm_static(j, k):
        """Smoothed 3x3 sum at static scan offset (col k, row j)
        (GetScoreMaxBelow tie-break, :1004-1028)."""
        return (
            2 * (D[(j, k - 1)] + D[(j, k + 1)] + D[(j + 1, k)]
                 + D[(j - 1, k)])
            + D[(j + 1, k + 1)] + D[(j + 1, k - 1)]
            + D[(j - 1, k + 1)] + D[(j - 1, k - 1)]
        )

    # Column/row probe specs: (kind, coord, exists, pos_off, off_vals).
    # pos_off = the position offset (vs ix_first) this probe would
    # assign: the first float col anchors at ix_first (offset 0), int
    # col k at offset k, the last float col at trunc(x1) (offset t_xl).
    # tap_off/tap_vals describe the bilinear v00 tap for float coords:
    # trunc(x_1) sits at offset {-1, 0} (trunc(x_1 + 1) vs trunc(x_1)
    # differ by 1 except for x_1 in (-1, 0]), trunc(x1) at t_xl.
    tx_1 = _trunc_i32(x_1) - ix_first   # (1, w), in {-1, 0}
    ty_1 = _trunc_i32(y_1) - iy_first
    cols = [
        ("f", x_1, None, jnp.zeros_like(ix_first), tx_1, (-1, 0))
    ]
    for k in range(n_int):
        xi = ix_first + k
        cols.append(
            ("i", xi, xi <= ix_last, jnp.full_like(ix_first, k),
             None, (k,))
        )
    cols.append(("f", x1, None, t_xl, t_xl, pos_offs))

    rows = [
        ("f", y_1, None, True, jnp.zeros_like(iy_first), ty_1, (-1, 0))
    ]
    for k in range(n_int):
        yi = iy_first + k
        rows.append(
            ("i", yi, yi <= iy_last, True, jnp.full_like(iy_first, k),
             None, (k,))
        )
    rows.append(("f", y1, None, False, t_yl, t_yl, pos_offs))

    def probe(ckind, cval, rkind, rval, cx_off, cx_vals, cy_off,
              cy_vals):
        if ckind == "i" and rkind == "i":
            return pick_sel(None, cx_vals, None, cy_vals).astype(f32)
        # _bilinear_from with the 4 taps routed through the grid: the
        # float chain (rx/ry weights, _fmul products, final truncation)
        # is op-for-op the candidate path's.
        xf = cval.astype(f32) if ckind == "i" else cval
        yf = rval.astype(f32) if rkind == "i" else rval
        x = _trunc_i32(xf)
        y = _trunc_i32(yf)
        rx1 = xf - x.astype(f32)
        rx = f32(1.0) - rx1
        ry1 = yf - y.astype(f32)
        ry = f32(1.0) - ry1
        cx1 = tuple(v + 1 for v in cx_vals)
        cy1 = tuple(v + 1 for v in cy_vals)
        cx_off1 = None if cx_off is None else cx_off + 1
        cy_off1 = None if cy_off is None else cy_off + 1
        v00 = pick_sel(cx_off, cx_vals, cy_off, cy_vals).astype(f32)
        v10 = pick_sel(cx_off1, cx1, cy_off, cy_vals).astype(f32)
        v01 = pick_sel(cx_off, cx_vals, cy_off1, cy1).astype(f32)
        v11 = pick_sel(cx_off1, cx1, cy_off1, cy1).astype(f32)
        out = (
            _fmul(_fmul(rx, ry), v00) + _fmul(_fmul(rx1, ry), v10)
            + _fmul(_fmul(rx, ry1), v01) + _fmul(_fmul(rx1, ry1), v11)
        )
        return _trunc_i32(out).astype(f32)

    exceeded = jnp.zeros((h, w), bool)
    first = True
    mx_off = jnp.zeros((h, w), jnp.int32)
    my_off = jnp.zeros((h, w), jnp.int32)
    best: Optional[jnp.ndarray] = None

    for ri, (rkind, rval, rexists, rcheck, py_off, cy_off,
             cy_vals) in enumerate(rows):
        for ci, (ckind, cval, cexists, px_off, cx_off,
                 cx_vals) in enumerate(cols):
            exists = jnp.ones((h, w), bool)
            if cexists is not None:
                exists &= cexists
            if rexists is not None:
                exists &= rexists
            v = probe(ckind, cval, rkind, rval, cx_off, cx_vals,
                      cy_off, cy_vals)
            if first:
                best = v
                first = False
                if rcheck:
                    exceeded |= v > threshold
                continue
            if rcheck:
                exceeded |= exists & (v > threshold)
            if tie_break and ckind == "i" and rkind == "i":
                # On equality, compare smoothed 3x3 sums: the probe's
                # (static offsets) vs the current argmax's (one-hot
                # select over the small position-offset range).
                k_off = ci - 1  # int col index == its offset
                j_off = ri - 1
                t1 = sm_static(j_off, k_off)
                t2 = jnp.zeros((h, w), jnp.int32)
                for ko in pos_offs:
                    for jo in pos_offs:
                        t2 = t2 + jnp.where(
                            (mx_off == ko) & (my_off == jo),
                            sm_static(jo, ko),
                            0,
                        )
                tie = exists & (v == best)
                move = tie & (t1 > t2)
                mx_off = jnp.where(move, jnp.broadcast_to(
                    jnp.full_like(ix_first, k_off), (h, w)), mx_off)
                my_off = jnp.where(move, jnp.broadcast_to(
                    jnp.full_like(iy_first, j_off), (h, w)), my_off)
            upd = exists & (v > best)
            best = jnp.where(upd, v, best)
            mx_off = jnp.where(
                upd, jnp.broadcast_to(px_off, (h, w)), mx_off
            )
            my_off = jnp.where(
                upd, jnp.broadcast_to(py_off, (h, w)), my_off
            )

    if _probes_only == "dict":
        return dict(
            shape=(h, w), mode=mode, exceeded=exceeded, best=best,
            mx_off=mx_off, my_off=my_off, ixf=ixf, iyf=iyf,
        )
    if _probes_only:
        return exceeded, best, mx_off, my_off

    # Sub-pixel on the 3x3 around the argmax position: one-hot select
    # over the static offset grid (argmax offsets range over {-1, 0, 1}
    # per axis across all modes).
    def patch_entry(a, b):
        e = jnp.zeros((h, w), jnp.int32)
        for ko in pos_offs:
            for jo in pos_offs:
                e = e + jnp.where(
                    (mx_off == ko) & (my_off == jo),
                    D[(jo + b - 1, ko + a - 1)],
                    0,
                )
        return e

    patch = jnp.stack(
        [
            jnp.stack([patch_entry(a, b) for b in range(3)], axis=-1)
            for a in range(3)
        ],
        axis=-2,
    )  # (h, w, 3a, 3b): patch[..., a, b] = score(mx + a - 1, my + b - 1)
    dx1, dy1, refined = ast_subpixel2d(patch)
    real_x = (ix_first + mx_off).astype(f32)
    real_y = (iy_first + my_off).astype(f32)
    real_x = real_x + dx1
    real_y = real_y + dy1

    # Back-conversion literal types per reference site (see candidate
    # path for the site list).
    if mode == "above_octave":
        dx = (_fmul(real_x, f32(6.0)) + f32(1.0)) / f32(4.0) - xsf
        dy = (_fmul(real_y, f32(6.0)) + f32(1.0)) / f32(4.0) - ysf
    elif mode == "above_intra":
        dx = ((_nf(_dbl(real_x) * 8.0) + 1.0) / 6.0 - _dbl(xsf)).astype(f32)
        dy = ((_nf(_dbl(real_y) * 8.0) + 1.0) / 6.0 - _dbl(ysf)).astype(f32)
    elif mode == "below_octave":
        dx = ((_nf(_dbl(real_x) * 6.0) + 1.0) / 8.0 - _dbl(xsf)).astype(f32)
        dy = ((_nf(_dbl(real_y) * 6.0) + 1.0) / 8.0 - _dbl(ysf)).astype(f32)
    else:
        dx = ((_nf(_dbl(real_x) * 4.0) - 1.0) / 6.0 - _dbl(xsf)).astype(f32)
        dy = ((_nf(_dbl(real_y) * 4.0) - 1.0) / 6.0 - _dbl(ysf)).astype(f32)

    unrefined = (dx > 1.0) | (dx < -1.0) | (dy > 1.0) | (dy < -1.0)
    dx = jnp.clip(dx, -1.0, 1.0)
    dy = jnp.clip(dy, -1.0, 1.0)
    score = jnp.where(unrefined, best, jnp.maximum(refined, best))
    ismax = ~exceeded
    score = jnp.where(ismax, score, 0.0)
    return ismax, score, dx, dy


def dense_scan_probes(neighbor, dst_shape, thr, mode,
                      drop=K_DROP_THRESHOLD):
    """Dense probe scan WITHOUT the refinement tail: returns a dict of
    per-pixel scan results (exceeded/best/argmax offsets + the index
    staircases) for :func:`sparse_scan_tail`. The probes and the
    first-max/tie logic are elementwise-cheap; the Subpixel2D +
    back-conversion tail is compute-heavy on full maps and only matters
    at corner pixels, so it runs per candidate instead."""
    return dense_score_patch_max(
        neighbor, dst_shape, thr, mode, drop=drop, _probes_only="dict"
    )


def _packed_patch33(map2d: jnp.ndarray, xs, ys):
    """(K, 3, 3) patch with patch[k, a, b] = map2d[y + b - 1, x + a - 1]
    via ONE packed (9K,) take (gathers cost a flat per-call time on this
    backend). Clipped indices land in the map's zeroed border, matching
    the candidate path's clip-gather + interior test."""
    h_n, w_n = map2d.shape
    idx = []
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            yy = jnp.clip(ys + b, 0, h_n - 1)
            xx = jnp.clip(xs + a, 0, w_n - 1)
            idx.append(yy * w_n + xx)
    taps = jnp.take(map2d.reshape(-1), jnp.concatenate(idx))
    return taps.reshape(3, 3, -1).transpose(2, 0, 1)


def sparse_scan_tail(scan: dict, masked_src: jnp.ndarray, xs, ys):
    """Per-candidate Subpixel2D + back-conversion of a dense probe scan
    — the exact tail of ``_score_patch_max`` (brisk-scale-space.cc
    :830-886 / :1030-1070) on (K,) vectors. Returns (ismax, score, dx,
    dy) for candidates at (xs, ys) of the destination layer."""
    h, w = scan["shape"]
    mode = scan["mode"]
    flat = ys * w + xs
    # ONE packed take of the per-pixel scan results: best is an
    # integer-valued f32 (truncated bilinears of <= 255 int scores;
    # border extrapolation gives weights in (-1, 2), so values lie well
    # inside (-4096, 4096) — offset-packed in 14 bits), argmax offsets
    # lie in {-1..1}, exceeded is one bit.
    packed = (
        (scan["best"].astype(jnp.int32) + 4096)
        + ((scan["mx_off"] + 1) << 14)
        + ((scan["my_off"] + 1) << 16)
        + (scan["exceeded"].astype(jnp.int32) << 18)
    )
    pc = jnp.take(packed.reshape(-1), flat)
    best = ((pc & 0x3FFF) - 4096).astype(f32)
    mx_off = ((pc >> 14) & 3) - 1
    my_off = ((pc >> 16) & 3) - 1
    exceeded = ((pc >> 18) & 1).astype(bool)
    mx = jnp.take(scan["ixf"], xs) + mx_off
    my = jnp.take(scan["iyf"], ys) + my_off

    patch = _packed_patch33(masked_src, mx, my)
    dx1, dy1, refined = ast_subpixel2d(patch)
    real_x = mx.astype(f32) + dx1
    real_y = my.astype(f32) + dy1
    xsf = xs.astype(f32)
    ysf = ys.astype(f32)

    if mode == "above_octave":
        dx = (_fmul(real_x, f32(6.0)) + f32(1.0)) / f32(4.0) - xsf
        dy = (_fmul(real_y, f32(6.0)) + f32(1.0)) / f32(4.0) - ysf
    elif mode == "above_intra":
        dx = ((_nf(_dbl(real_x) * 8.0) + 1.0) / 6.0 - _dbl(xsf)).astype(f32)
        dy = ((_nf(_dbl(real_y) * 8.0) + 1.0) / 6.0 - _dbl(ysf)).astype(f32)
    elif mode == "below_octave":
        dx = ((_nf(_dbl(real_x) * 6.0) + 1.0) / 8.0 - _dbl(xsf)).astype(f32)
        dy = ((_nf(_dbl(real_y) * 6.0) + 1.0) / 8.0 - _dbl(ysf)).astype(f32)
    else:
        dx = ((_nf(_dbl(real_x) * 4.0) - 1.0) / 6.0 - _dbl(xsf)).astype(f32)
        dy = ((_nf(_dbl(real_y) * 4.0) - 1.0) / 6.0 - _dbl(ysf)).astype(f32)

    unrefined = (dx > 1.0) | (dx < -1.0) | (dy > 1.0) | (dy < -1.0)
    dx = jnp.clip(dx, -1.0, 1.0)
    dy = jnp.clip(dy, -1.0, 1.0)
    score = jnp.where(unrefined, best, jnp.maximum(refined, best))
    ismax = ~exceeded
    score = jnp.where(ismax, score, 0.0)
    return ismax, score, dx, dy


def sparse_refine3d(
    layers, i, xs, ys, above_scan, below_scan, masked, masked58,
    v1=False,
):
    """Per-candidate Refine3D (mirrors ast_scale_space.refine3d body)
    from dense probe scans + packed patch takes. Returns (ismax, mx,
    x, y, scale_total) as (K,) vectors."""
    this = layers[i]
    h, w = this.img.shape
    center = jnp.take(masked[i].reshape(-1), ys * w + xs)

    is_octave = i % 2 == 0
    ismax_a, max_above, dxa, dya = sparse_scan_tail(
        above_scan, masked[i + 1], xs, ys
    )

    patch = _packed_patch33(masked[i], xs, ys)
    dxl, dyl, max_layer = ast_subpixel2d(patch)
    s_1_1 = center

    centerf = center.astype(f32)
    max_layer_or_center = jnp.maximum(centerf, max_layer)

    if is_octave:
        if i == 0:
            p58 = _packed_patch33(masked58, xs, ys)
            max_below = jnp.max(p58.reshape(p58.shape[0], -1), axis=1)
            dxb, dyb, _ = ast_subpixel2d(p58)
            max_below_f = max_below.astype(f32)
            ismax_b = jnp.ones_like(ismax_a)
        else:
            ismax_b, max_below_f, dxb, dyb = sparse_scan_tail(
                below_scan, masked[i - 1], xs, ys
            )
        if v1:
            no_refine = jnp.zeros_like(ismax_a)
            discard = jnp.zeros_like(ismax_a)
        elif i == 0:
            no_refine = (s_1_1 - K_MAX_THRESHOLD) <= _trunc_i32(max_above)
            discard = jnp.zeros_like(no_refine)
        else:
            weak = ((s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_above) | (
                (s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_below_f
            )
            edge = ((s_1_1 - K_MIN_DROP).astype(f32) > max_above) | (
                (s_1_1 - K_MIN_DROP).astype(f32) > max_below_f
            )
            no_refine = weak & edge
            discard = weak & ~edge

        if i == 0:
            r_scale, r_max = refine1d_2(
                max_below_f, max_layer_or_center, max_above
            )
        else:
            r_scale, r_max = refine1d(
                max_below_f, max_layer_or_center, max_above
            )
        scale = jnp.where(no_refine, f32(1.0), r_scale)
        mxv = jnp.where(no_refine, max_layer, r_max)

        r0_up = (f32(1.5) - scale) / f32(0.5)
        r1_up = f32(1.0) - r0_up
        x_up = _fmul(r0_up, dxl) + _fmul(r1_up, dxa) + xs.astype(f32)
        y_up = _fmul(r0_up, dyl) + _fmul(r1_up, dya) + ys.astype(f32)

        r0_dn = (scale - f32(0.5 if i == 0 else 0.75)) / f32(
            0.5 if i == 0 else 0.25
        )
        r1_dn = f32(1.0) - r0_dn
        x_dn = _fmul(r0_dn, dxl) + _fmul(r1_dn, dxb) + xs.astype(f32)
        y_dn = _fmul(r0_dn, dyl) + _fmul(r1_dn, dyb) + ys.astype(f32)

        up = scale > 1.0
        if i == 0:
            x_out = jnp.where(up, x_up, x_dn)
            y_out = jnp.where(up, y_up, y_dn)
        else:
            ls = f32(this.scale)
            lo = f32(this.offset)
            x_out = jnp.where(
                up, _fmul(x_up, ls) + lo, _fmul(x_dn, ls) + lo
            )
            y_out = jnp.where(
                up, _fmul(y_up, ls) + lo, _fmul(y_dn, ls) + lo
            )
    else:
        ismax_b, max_below_f, dxb, dyb = sparse_scan_tail(
            below_scan, masked[i - 1], xs, ys
        )
        if v1:
            no_refine = jnp.zeros_like(ismax_a)
            discard = jnp.zeros_like(ismax_a)
        else:
            weak = ((s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_above) | (
                (s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_below_f
            )
            edge = ((s_1_1 - K_MIN_DROP).astype(f32) > max_above) | (
                (s_1_1 - K_MIN_DROP).astype(f32) > max_below_f
            )
            no_refine = weak & edge
            discard = weak & ~edge

        r_scale, r_max = refine1d_1(
            max_below_f, max_layer_or_center, max_above
        )
        scale = jnp.where(no_refine, f32(1.0), r_scale)
        mxv = jnp.where(no_refine, max_layer, r_max)

        r0_up = (4.0 - _nf(_dbl(scale) * 3.0)).astype(f32)
        r1_up = f32(1.0) - r0_up
        r0_dn = (_nf(_dbl(scale) * 3.0) - 2.0).astype(f32)
        r1_dn = f32(1.0) - r0_dn
        ls = f32(this.scale)
        lo = f32(this.offset)
        x_up = _fmul(
            _fmul(r0_up, dxl) + _fmul(r1_up, dxa) + xs.astype(f32), ls
        ) + lo
        y_up = _fmul(
            _fmul(r0_up, dyl) + _fmul(r1_up, dya) + ys.astype(f32), ls
        ) + lo
        x_dn = _fmul(
            _fmul(r0_dn, dxl) + _fmul(r1_dn, dxb) + xs.astype(f32), ls
        ) + lo
        y_dn = _fmul(
            _fmul(r0_dn, dyl) + _fmul(r1_dn, dyb) + ys.astype(f32), ls
        ) + lo
        up = scale > 1.0
        x_out = jnp.where(up, x_up, x_dn)
        y_out = jnp.where(up, y_up, y_dn)

    ismax = ismax_a & ismax_b & ~discard
    scale_total = scale * f32(this.scale)
    return ismax, mxv, x_out, y_out, scale_total


# ---------------------------------------------------------------------------
# Dense IsMax2D (brisk-scale-space.cc:430-531).
# ---------------------------------------------------------------------------
def dense_is_max_2d(
    layer: AstLayerMaps,
    e_query: Optional[jnp.ndarray] = None,
    e_patch: Optional[jnp.ndarray] = None,
    prefill: Optional[jnp.ndarray] = None,
    _shared: Optional[dict] = None,
    _return_shared: bool = False,
):
    """Dense emulated-cache IsMax2D: a bool map (meaningful at corner
    pixels; corners sit >= 3 from every border so all +-2 shifted reads
    stay inside the array, matching the candidate path's clip-gathers).

    The two emulation passes differ ONLY through the thr1 term
    (e_patch/prefill seeds) inside the raw reads; everything else —
    the neighbour scores, the smoothed center, the earliest-toucher
    'touched' masks and the no-seed raw base values — is pass-invariant.
    Pass 1 returns it via ``_return_shared``; pass 2 reuses it through
    ``_shared`` (identical values by construction — the shared pieces
    are the same traced subexpressions, not re-derived).
    """
    h, w = layer.img.shape
    if _shared is None:
        rm = (
            jnp.arange(h, dtype=jnp.int32)[:, None] * w
            + jnp.arange(w, dtype=jnp.int32)[None, :]
        )
        inb = jnp.zeros((h, w), bool).at[3: h - 3, 3: w - 3].set(True)
        # int16 value arithmetic throughout: scores are <= 255 (cache =
        # max(t*, thrmap), both u8-ranged; t* border is -1), the
        # largest sum is the 14-weight tie smoothing <= 14*255 = 3570
        # << 32767 — every comparison is exact in i16 at half the memory
        # traffic. Index comparisons (e_query/e_patch vs rm) stay i32.
        i16 = jnp.int16
        center = layer.cache.astype(i16)
        t16 = layer.t_star.astype(i16)
        if e_query is None:
            e_query = earliest_toucher_map(layer)

        def int_score(ox, oy):
            """Dense _int_score at offset (ox, oy): the IsMax2D
            neighbour query GetAgastScore(x+ox, y+oy, center)."""
            cnr = _shift_bool(layer.corner, oy, ox)
            cch = _shift_i32(center, oy, ox)
            ts = _shift_i32(t16, oy, ox)
            inb_s = _shift_bool(inb, oy, ox)
            fresh = jnp.where(ts >= center, ts, i16(0))
            return jnp.where(inb_s, jnp.where(cnr, cch, fresh), i16(0))

        neigh = {(dx, dy): int_score(dx, dy) for dx, dy in _NEIGH8}
        reject0 = jnp.zeros((h, w), bool)
        for v in neigh.values():
            reject0 |= v > center

        s_10, s10 = neigh[(-1, 0)], neigh[(1, 0)]
        s0_1, s01 = neigh[(0, -1)], neigh[(0, 1)]
        s_1_1, s1_1 = neigh[(-1, -1)], neigh[(1, -1)]
        s_11, s11 = neigh[(-1, 1)], neigh[(1, 1)]
        smoothed_center = (
            i16(4) * center + i16(2) * (s_10 + s10 + s0_1 + s01)
            + s_1_1 + s1_1 + s_11 + s11
        )

        off = {}
        for ox in range(-2, 3):
            for oy in range(-2, 3):
                q_corner = _shift_bool(layer.corner, oy, ox)
                q_cache = _shift_i32(center, oy, ox)
                q_t = _shift_i32(t16, oy, ox)
                q_early = _shift_i32(e_query, oy, ox, fill=_INF)
                own = (abs(ox) <= 1) and (abs(oy) <= 1)  # static
                touched_q = q_early < rm
                if own:
                    touched_q |= center <= q_t
                # Raw read with NO seeds (pass 1); pass 2 layers its
                # thr1 term on top of this exact expression.
                val_base = jnp.where(
                    touched_q & (q_t > 2), q_t, i16(0)
                )
                off[(ox, oy)] = dict(
                    q_corner=q_corner, q_cache=q_cache, q_t=q_t,
                    val_base=val_base,
                )
        _shared = dict(
            rm=rm, center=center, neigh=neigh, reject0=reject0,
            smoothed=smoothed_center, off=off,
        )

    rm = _shared["rm"]
    center = _shared["center"]
    neigh = _shared["neigh"]
    smoothed_center = _shared["smoothed"]
    off = _shared["off"]
    reject = _shared["reject0"]

    def raw(ox, oy):
        """Dense raw scores_ read at offset (ox, oy), |ox|,|oy| <= 2."""
        o = off[(ox, oy)]
        if e_patch is None and prefill is None:
            return jnp.where(o["q_corner"], o["q_cache"], o["val_base"])
        thr1 = jnp.zeros((h, w), bool)
        if e_patch is not None:
            thr1 |= _shift_i32(e_patch, oy, ox, fill=_INF) < rm
        if prefill is not None:
            thr1 |= _shift_bool(prefill, oy, ox)
        val = jnp.where(
            thr1 & (o["q_t"] >= 1), o["q_t"], o["val_base"]
        )
        return jnp.where(o["q_corner"], o["q_cache"], val)

    raws = {
        (ox, oy): raw(ox, oy)
        for ox in range(-2, 3)
        for oy in range(-2, 3)
    }
    for dx, dy in _TIE_ORDER:
        tied = neigh[(dx, dy)] == center
        other = (
            raws[(dx - 1, dy - 1)]
            + 2 * raws[(dx, dy - 1)]
            + raws[(dx + 1, dy - 1)]
            + 2 * raws[(dx + 1, dy)]
            + 4 * raws[(dx, dy)]
            + 2 * raws[(dx - 1, dy)]
            + raws[(dx - 1, dy + 1)]
            + 2 * raws[(dx, dy + 1)]
            + raws[(dx + 1, dy + 1)]
        )
        reject |= tied & (other > smoothed_center)

    is2d = ~reject
    return (is2d, _shared) if _return_shared else is2d


# ---------------------------------------------------------------------------
# Dense Refine3D (brisk-scale-space.cc:534-754).
# ---------------------------------------------------------------------------
def _masked_cache(layer: AstLayerMaps) -> jnp.ndarray:
    """Dense _cache_score(layer, x, y): cache with the [3, n-4] border
    zeroed (all per-pixel reads then become plain shifts)."""
    h, w = layer.img.shape
    inb = jnp.zeros((h, w), bool).at[3: h - 3, 3: w - 3].set(True)
    return jnp.where(inb, layer.cache, 0)


def _shift_patch33(masked: jnp.ndarray) -> jnp.ndarray:
    """(h, w, 3, 3) with patch[..., a, b] = masked(x + a - 1, y + b - 1)
    (the dense _patch33: shifts replace clip-gathers — identical at
    corner pixels, which sit >= 3 from every border)."""
    return jnp.stack(
        [
            jnp.stack(
                [_shift_i32(masked, b - 1, a - 1) for b in range(3)],
                axis=-1,
            )
            for a in range(3)
        ],
        axis=-2,
    )


def dense_refine3d(
    layers: list[AstLayerMaps],
    i: int,
    t58_layer0: Optional[jnp.ndarray],
    v1: bool = False,
):
    """Dense Refine3D over layer i's full map. Returns the candidate
    path's tuple (ismax, score, x, y, scale_total, ismax_a, ismax_b) as
    (h, w) maps in original-image coordinates."""
    this = layers[i]
    h, w = this.img.shape
    center = _masked_cache(this)
    drop = 0 if v1 else K_DROP_THRESHOLD
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]
    xsf32 = jnp.broadcast_to(xs.astype(f32), (h, w))
    ysf32 = jnp.broadcast_to(ys.astype(f32), (h, w))

    is_octave = i % 2 == 0
    above_mode = "above_octave" if is_octave else "above_intra"
    ismax_a, max_above, dxa, dya = dense_score_patch_max(
        layers[i + 1], (h, w), center, above_mode, drop=drop
    )

    patch = _shift_patch33(center)
    dxl, dyl, max_layer = ast_subpixel2d(patch)
    s_1_1 = center

    centerf = center.astype(f32)
    max_layer_or_center = jnp.maximum(centerf, max_layer)

    if is_octave:
        if i == 0:
            h0, w0 = layers[0].img.shape
            inb2 = jnp.zeros((h0, w0), bool).at[
                2: h0 - 2, 2: w0 - 2
            ].set(True)
            masked58 = jnp.where(
                inb2 & (t58_layer0 >= 1), t58_layer0, 0
            )
            p58 = _shift_patch33(masked58)
            max_below = jnp.max(
                p58.reshape(p58.shape[:2] + (-1,)), axis=-1
            )
            dxb, dyb, _ = ast_subpixel2d(p58)
            max_below_f = max_below.astype(f32)
            ismax_b = jnp.ones_like(ismax_a)
        else:
            ismax_b, max_below_f, dxb, dyb = dense_score_patch_max(
                layers[i - 1], (h, w), center, "below_octave", drop=drop
            )
        if v1:
            no_refine = jnp.zeros_like(ismax_a)
            discard = jnp.zeros_like(ismax_a)
        elif i == 0:
            no_refine = (s_1_1 - K_MAX_THRESHOLD) <= _trunc_i32(max_above)
            discard = jnp.zeros_like(no_refine)
        else:
            weak = ((s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_above) | (
                (s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_below_f
            )
            edge = ((s_1_1 - K_MIN_DROP).astype(f32) > max_above) | (
                (s_1_1 - K_MIN_DROP).astype(f32) > max_below_f
            )
            no_refine = weak & edge
            discard = weak & ~edge

        if i == 0:
            r_scale, r_max = refine1d_2(
                max_below_f, max_layer_or_center, max_above
            )
        else:
            r_scale, r_max = refine1d(
                max_below_f, max_layer_or_center, max_above
            )
        scale = jnp.where(no_refine, f32(1.0), r_scale)
        mx = jnp.where(no_refine, max_layer, r_max)

        r0_up = (f32(1.5) - scale) / f32(0.5)
        r1_up = f32(1.0) - r0_up
        x_up = _fmul(r0_up, dxl) + _fmul(r1_up, dxa) + xsf32
        y_up = _fmul(r0_up, dyl) + _fmul(r1_up, dya) + ysf32

        r0_dn = (scale - f32(0.5 if i == 0 else 0.75)) / f32(
            0.5 if i == 0 else 0.25
        )
        r1_dn = f32(1.0) - r0_dn
        x_dn = _fmul(r0_dn, dxl) + _fmul(r1_dn, dxb) + xsf32
        y_dn = _fmul(r0_dn, dyl) + _fmul(r1_dn, dyb) + ysf32

        up = scale > 1.0
        if i == 0:
            x_out = jnp.where(up, x_up, x_dn)
            y_out = jnp.where(up, y_up, y_dn)
        else:
            ls = f32(this.scale)
            lo = f32(this.offset)
            x_out = jnp.where(
                up, _fmul(x_up, ls) + lo, _fmul(x_dn, ls) + lo
            )
            y_out = jnp.where(
                up, _fmul(y_up, ls) + lo, _fmul(y_dn, ls) + lo
            )
    else:
        ismax_b, max_below_f, dxb, dyb = dense_score_patch_max(
            layers[i - 1], (h, w), center, "below_intra", drop=drop
        )
        if v1:
            no_refine = jnp.zeros_like(ismax_a)
            discard = jnp.zeros_like(ismax_a)
        else:
            weak = ((s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_above) | (
                (s_1_1 - K_MAX_THRESHOLD).astype(f32) < max_below_f
            )
            edge = ((s_1_1 - K_MIN_DROP).astype(f32) > max_above) | (
                (s_1_1 - K_MIN_DROP).astype(f32) > max_below_f
            )
            no_refine = weak & edge
            discard = weak & ~edge

        r_scale, r_max = refine1d_1(
            max_below_f, max_layer_or_center, max_above
        )
        scale = jnp.where(no_refine, f32(1.0), r_scale)
        mx = jnp.where(no_refine, max_layer, r_max)

        r0_up = (4.0 - _nf(_dbl(scale) * 3.0)).astype(f32)
        r1_up = f32(1.0) - r0_up
        r0_dn = (_nf(_dbl(scale) * 3.0) - 2.0).astype(f32)
        r1_dn = f32(1.0) - r0_dn
        ls = f32(this.scale)
        lo = f32(this.offset)
        x_up = _fmul(
            _fmul(r0_up, dxl) + _fmul(r1_up, dxa) + xsf32, ls
        ) + lo
        y_up = _fmul(
            _fmul(r0_up, dyl) + _fmul(r1_up, dya) + ysf32, ls
        ) + lo
        x_dn = _fmul(
            _fmul(r0_dn, dxl) + _fmul(r1_dn, dxb) + xsf32, ls
        ) + lo
        y_dn = _fmul(
            _fmul(r0_dn, dyl) + _fmul(r1_dn, dyb) + ysf32, ls
        ) + lo
        up = scale > 1.0
        x_out = jnp.where(up, x_up, x_dn)
        y_out = jnp.where(up, y_up, y_dn)

    ismax = ismax_a & ismax_b & ~discard
    scale_total = scale * f32(this.scale)
    return ismax, mx, x_out, y_out, scale_total, ismax_a, ismax_b


# ---------------------------------------------------------------------------
# Dense per-layer pipeline + aux maps + driver.
# ---------------------------------------------------------------------------
def dense_layer_scans(layers, i, t58, v1=False):
    """The aux-INDEPENDENT part of _process_layer (everything except
    IsMax2D): the cross-layer gate, keypoint field maps, and the
    ismax_a/ismax_b flags. Computed ONCE per layer — both emulation
    passes reuse it (the candidate path recomputes these per pass and
    relies on XLA CSE; here the reuse is structural).

    Returns (gate, fields, ismax_a, ismax_b) with
    ``accepted = is2d & gate``.
    """
    layer = layers[i]
    h, w = layer.img.shape
    n_layers = len(layers)
    ls = f32(layer.scale)
    lo = f32(layer.offset)
    ones = jnp.ones((h, w), bool)
    xsf = jnp.broadcast_to(
        jnp.arange(w, dtype=jnp.int32)[None, :].astype(f32), (h, w)
    )
    ysf = jnp.broadcast_to(
        jnp.arange(h, dtype=jnp.int32)[:, None].astype(f32), (h, w)
    )
    center = _masked_cache(layer)
    if n_layers == 1:
        patch = _shift_patch33(center)
        dxl, dyl, mxv = ast_subpixel2d(patch)
        x_out = xsf + dxl
        y_out = ysf + dyl
        score = mxv
        size = jnp.full((h, w), K_BASIC_SIZE, f32)
        gate = ones
        ismax_a = ismax_b = ones
        octave_idx = 0
    elif i == n_layers - 1:
        below_mode = "below_octave" if i % 2 == 0 else "below_intra"
        ismax_b, _, _, _ = dense_score_patch_max(
            layers[i - 1], (h, w), center, below_mode,
            drop=0 if v1 else K_DROP_THRESHOLD,
        )
        patch = _shift_patch33(center)
        dxl, dyl, mxv = ast_subpixel2d(patch)
        x_out = _fmul(xsf + dxl, ls) + lo
        y_out = _fmul(ysf + dyl, ls) + lo
        score = mxv
        size = jnp.full((h, w), f32(K_BASIC_SIZE) * ls, f32)
        gate = ismax_b
        ismax_a = ones
        octave_idx = i
    else:
        ismax, score, x_out, y_out, scale_total, ismax_a, ismax_b = (
            dense_refine3d(layers, i, t58, v1=v1)
        )
        size = f32(K_BASIC_SIZE) * scale_total
        gate = ismax
        octave_idx = i
    return (
        gate,
        (x_out, y_out, size, score, octave_idx),
        ismax_a,
        ismax_b,
    )


def _interval_stamp(m, lo_x, hi_x, lo_y, hi_y, dst_shape):
    """Dense OR-stamp: out[qy, qx] = any source pixel p with m[p] and
    lo_x[px] <= qx <= hi_x[px], lo_y[py] <= qy <= hi_y[py].

    The per-axis window bounds are monotone nondecreasing coordinate
    functions (the above-scan probe windows), so each target column's
    source set is an interval — computable with a cumulative sum and
    two searchsorted boundary vectors per axis (no scatter).
    """
    hd, wd = dst_shape
    cx = jnp.cumsum(m.astype(jnp.int32), axis=1)
    q = jnp.arange(wd, dtype=lo_x.dtype)
    b = jnp.searchsorted(lo_x, q, side="right") - 1  # last x: lo_x <= q
    a = jnp.searchsorted(hi_x, q, side="left")       # first x: hi_x >= q
    cb = jnp.where(
        b[None, :] >= 0,
        jnp.take(cx, jnp.clip(b, 0, None), axis=1),
        0,
    )
    ca = jnp.where(
        a[None, :] > 0,
        jnp.take(cx, jnp.clip(a - 1, 0, None), axis=1),
        0,
    )
    t1 = (cb - ca) > 0                               # (h_src, wd)

    cy = jnp.cumsum(t1.astype(jnp.int32), axis=0)
    qy = jnp.arange(hd, dtype=lo_y.dtype)
    by = jnp.searchsorted(lo_y, qy, side="right") - 1
    ay = jnp.searchsorted(hi_y, qy, side="left")
    cby = jnp.where(
        by[:, None] >= 0,
        jnp.take(cy, jnp.clip(by, 0, None), axis=0),
        0,
    )
    cay = jnp.where(
        ay[:, None] > 0,
        jnp.take(cy, jnp.clip(ay - 1, 0, None), axis=0),
        0,
    )
    return (cby - cay) > 0


def dense_aux_maps(layers, pass1, etm=None):
    """Dense _aux_maps: (e_query, e_patch, prefill) per layer from the
    pass-1 dense masks (the candidate path's scatters become direct
    mask arithmetic; the probe-window prefill becomes an axis-separable
    interval stamp). ``etm`` = precomputed earliest-toucher maps."""
    n_layers = len(layers)
    aux = []
    for i, layer in enumerate(layers):
        h, w = layer.img.shape
        acc = layer.corner & pass1[i]["patch_touched"]
        rm = (
            jnp.arange(h, dtype=jnp.int32)[:, None] * w
            + jnp.arange(w, dtype=jnp.int32)[None, :]
        )
        e_patch = jnp.full((h, w), _INF)
        if i == n_layers - 1:
            offs = [
                (dx, dy) for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)
            ]
            for dx, dy in offs:
                a = _shift_bool(acc, -dy, -dx)
                r = _shift_i32(rm, -dy, -dx, fill=_INF)
                e_patch = jnp.minimum(e_patch, jnp.where(a, r, _INF))
            acc2 = layer.corner & pass1[i]["is2d"]
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                a = _shift_bool(acc2, -dy, -dx)
                r = _shift_i32(rm, -dy, -dx, fill=_INF)
                e_patch = jnp.minimum(e_patch, jnp.where(a, r, _INF))
        else:
            for dx, dy in _NEIGH8:
                a = _shift_bool(acc, dy, dx)
                r = _shift_i32(rm, dy, dx, fill=_INF)
                e_patch = jnp.minimum(e_patch, jnp.where(a, r, _INF))

        prefill = jnp.zeros((h, w), bool)
        if i >= 1:
            prev = layers[i - 1]
            hp, wp = prev.img.shape
            is2d_prev = prev.corner & pass1[i - 1]["is2d"]
            above_ok = pass1[i - 1]["above_ok"]
            xf = jnp.arange(wp, dtype=jnp.int32).astype(f32)
            yf = jnp.arange(hp, dtype=jnp.int32).astype(f32)
            if (i - 1) % 2 == 0:
                lo_x = _trunc_i32((f32(4.0) * xf - 3) / f32(6.0))
                hi_x = _trunc_i32((f32(4.0) * xf + 1) / f32(6.0)) + 1
                lo_y = _trunc_i32((f32(4.0) * yf - 3) / f32(6.0))
                hi_y = _trunc_i32((f32(4.0) * yf + 1) / f32(6.0)) + 1
            else:
                lo_x = _trunc_i32((f32(6.0) * xf - 4) / f32(8.0))
                hi_x = _trunc_i32((f32(6.0) * xf + 2) / f32(8.0)) + 1
                lo_y = _trunc_i32((f32(6.0) * yf - 4) / f32(8.0))
                hi_y = _trunc_i32((f32(6.0) * yf + 2) / f32(8.0)) + 1
            # Full window [lo, hi] when the above scan completed; the
            # first probe's 2x2 taps [lo, lo+1] when it early-exited.
            # (For the reachable source domain — corners >= 3 from the
            # border — the candidate path's clip(lo+k, 0, n-1) never
            # clips: hi_x at the largest corner x lands exactly on the
            # destination's last column.)
            m_full = is2d_prev & above_ok
            m_first = is2d_prev & ~above_ok
            prefill = _interval_stamp(
                m_full, lo_x, hi_x, lo_y, hi_y, (h, w)
            ) | _interval_stamp(
                m_first, lo_x, lo_x + 1, lo_y, lo_y + 1, (h, w)
            )
        aux.append((
            earliest_toucher_map(layer) if etm is None else etm[i],
            e_patch,
            prefill,
        ))
    return aux


def detect_ast_keypoints_dense(
    img: jnp.ndarray,
    threshold: int = 70,
    octaves: int = 3,
    max_candidates_per_layer: "int | tuple" = 2048,
    lower_threshold: int = 10,
    v1: bool = False,
    with_diagnostics: bool = False,
) -> KeyPoints:
    """Dense BRISK-AST detection (emulated cache model, scale-nonmaxima
    suppressed). Bitwise-identical output (incl. slot packing) to
    ``detect_ast_keypoints(raw_cache_model="emulated")`` whenever the
    per-layer candidate caps don't truncate — but the decisions here
    never depend on the caps at all (the candidate path's truncation
    also silently skews pass-1 aux maps on overflow; here caps only
    bound the final output extraction).
    """
    layers = build_ast_pyramid(
        img, octaves, threshold, lower=lower_threshold, v1=v1
    )
    n_layers = len(layers)
    t58 = agast5_8_score_map(layers[0].img) if n_layers > 1 else None
    caps = (
        max_candidates_per_layer
        if isinstance(max_candidates_per_layer, tuple)
        else (max_candidates_per_layer,) * n_layers
    )
    assert len(caps) >= n_layers, (caps, n_layers)

    drop = 0 if v1 else K_DROP_THRESHOLD
    masked = [_masked_cache(la) for la in layers]
    masked58 = None
    if n_layers > 1:
        h0, w0 = layers[0].img.shape
        inb2 = jnp.zeros((h0, w0), bool).at[
            2: h0 - 2, 2: w0 - 2
        ].set(True)
        masked58 = jnp.where(inb2 & (t58 >= 1), t58, 0)

    # Dense probe scans (elementwise-cheap); the VPU-heavy refinement
    # tails run per candidate below.
    above_pr: list = [None] * n_layers
    below_pr: list = [None] * n_layers
    for i in range(n_layers):
        hw = layers[i].img.shape
        if n_layers > 1 and i < n_layers - 1:
            mode_a = "above_octave" if i % 2 == 0 else "above_intra"
            above_pr[i] = dense_scan_probes(
                layers[i + 1], hw, masked[i], mode_a, drop=drop
            )
        if n_layers > 1 and i >= 1:
            mode_b = "below_octave" if i % 2 == 0 else "below_intra"
            below_pr[i] = dense_scan_probes(
                layers[i - 1], hw, masked[i], mode_b, drop=drop
            )

    etm = [earliest_toucher_map(la) for la in layers]
    pass1 = []
    shared = [None] * n_layers
    for i in range(n_layers):
        hw = layers[i].img.shape
        ones = jnp.ones(hw, bool)
        is2d, shared[i] = dense_is_max_2d(
            layers[i], etm[i], None, None, _return_shared=True
        )
        ia = ~above_pr[i]["exceeded"] if above_pr[i] is not None else ones
        ib = ~below_pr[i]["exceeded"] if below_pr[i] is not None else ones
        pass1.append(
            dict(
                is2d=is2d,
                patch_touched=is2d & ia & ib,
                above_ok=ia,
            )
        )
    aux = dense_aux_maps(layers, pass1, etm=etm)

    per_layer = []
    corner_counts = []
    extract_exact = []
    for i in range(n_layers):
        e_q, e_p, pre = aux[i]
        is2d2 = dense_is_max_2d(
            layers[i], e_q, e_p, pre, _shared=shared[i]
        )

        layer = layers[i]
        cap = caps[i]
        h, w = layer.img.shape
        ls = f32(layer.scale)
        lo = f32(layer.offset)
        # Candidate extraction == jnp.nonzero(corner, size=cap,
        # fill_value=0), but via the exact two-stage block top-k over
        # NEGATED flat indices: nonzero lowers to a full-size sort,
        # while the block
        # top-k sorts only 2048-element blocks. Keys are distinct, so
        # descending -idx == ascending row-major flat index — the
        # nonzero order exactly; fill slots are forced to 0 like
        # nonzero's fill_value. Exact whenever no 2048-block holds
        # more than r corners at/above the cap-th key (sharp flag,
        # folded into the diagnostics; certified by
        # ast_capacity_diagnostics on the bench frames).
        from ethzasl_brisk_jax.kernels.topk import (
            INT32_MIN as _IMIN,
            topk_block,
        )

        rm_flat = jnp.arange(h * w, dtype=jnp.int32)
        key = jnp.where(layer.corner.reshape(-1), -rm_flat, _IMIN)
        kcap = min(cap, h * w)
        kv, kidx, k_exact = topk_block(
            key, kcap, block=2048, r=_EXTRACT_BLOCK_R
        )
        n_corners = jnp.sum(layer.corner.astype(jnp.int32))
        corner_counts.append(n_corners)
        extract_exact.append(k_exact)
        valid = jnp.arange(cap) < n_corners
        slot_ok = (kv > _IMIN) & valid[:kcap]
        idx = jnp.where(slot_ok, kidx, 0)
        if kcap < cap:
            idx = jnp.pad(idx, (0, cap - kcap))
        ys = idx // w
        xs = idx % w

        # Per-candidate refinement tail (mirrors _process_layer).
        if n_layers == 1:
            patch = _packed_patch33(masked[i], xs, ys)
            dxl, dyl, mxv = ast_subpixel2d(patch)
            x_out = xs.astype(f32) + dxl
            y_out = ys.astype(f32) + dyl
            score = mxv
            size = jnp.full((cap,), K_BASIC_SIZE, f32)
            gate = jnp.ones((cap,), bool)
            octave_idx = 0
        elif i == n_layers - 1:
            gate, _, _, _ = sparse_scan_tail(
                below_pr[i], masked[i - 1], xs, ys
            )  # ismax_b
            patch = _packed_patch33(masked[i], xs, ys)
            dxl, dyl, mxv = ast_subpixel2d(patch)
            x_out = _fmul(xs.astype(f32) + dxl, ls) + lo
            y_out = _fmul(ys.astype(f32) + dyl, ls) + lo
            score = mxv
            size = jnp.full((cap,), f32(K_BASIC_SIZE) * ls, f32)
            octave_idx = i
        else:
            ismax, mxv, x_out, y_out, st = sparse_refine3d(
                layers, i, xs, ys, above_pr[i], below_pr[i],
                masked, masked58, v1=v1,
            )
            size = f32(K_BASIC_SIZE) * st
            gate = ismax
            score = mxv
            octave_idx = i

        is2d_c = jnp.take(is2d2.reshape(-1), ys * w + xs)
        per_layer.append(
            KeyPoints(
                x=x_out,
                y=y_out,
                size=size,
                angle=jnp.full((cap,), -1.0, f32),
                response=score.astype(f32),
                octave=jnp.full((cap,), octave_idx, jnp.int32),
                valid=valid & is2d_c & gate,
            )
        )

    kps = KeyPoints.concatenate(per_layer)
    if with_diagnostics:
        counts = jnp.stack(corner_counts)
        caps_arr = jnp.asarray(caps[:n_layers], jnp.int32)
        diag = AstDiagnostics(
            ok=(
                jnp.all(counts <= caps_arr)
                & jnp.all(jnp.stack(extract_exact))
            ),
            corner_counts=counts,
            cand_caps=caps_arr,
        )
        return kps, diag
    return kps
