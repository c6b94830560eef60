"""Spatial (image-tile) sharding of scale-space detection, with halo
exchange — detect on ONE large frame across the whole mesh.

SURVEY.md section 5 names this as the accelerator analog of long-context /
spatial sharding: shard image row-tiles over a mesh axis, exchange halo
rows for the stencil stages, and merge candidates with collectives. The
reference (single-threaded C++, brisk/src/harris-scores.cc +
scale-space-layer-inl.h) has no counterpart; semantics here are defined
by bitwise equality with ``detect_keypoints`` on one device.

Design (one ``shard_map`` over the whole detect):

* the input image is row-sharded: each device holds (H/n, W);
* every pyramid layer is built tile-locally — the 2x2 half-sample and
  3x3->2x2 two-thirds-sample kernels are block-aligned, so tiles whose
  row counts divide the sampling groups need no halo for downsampling
  (requires ``h_layer % n == 0`` for every layer, asserted);
* per layer, IMG_HALO rows are exchanged via ``lax.ppermute`` and the
  Harris kernel runs on the extended tile: its 5-row stencil leaves
  SCORE_HALO = IMG_HALO - 2 exact halo score rows, with the global
  border rows re-zeroed exactly like the dense kernel;
* 2-D maxima and the exact integer warped-score comparisons against the
  neighbour layers run tile-locally on the extended maps (the warp's
  row window is computed in GLOBAL coordinates, so bilinear taps and
  bounds match the dense path bit-for-bit);
* per-tile top-k candidates (with 3x3 sub-pixel patches pre-gathered
  from the extended score map) are ``all_gather``-ed and merged with a
  single STABLE sort by descending score: gather order is tile order =
  ascending global flat index, so ties resolve exactly like the dense
  ``lax.top_k``;
* uniformity enforcement and sub-pixel refinement run OUTSIDE the
  ``shard_map`` on the merged (replicated) candidate list: XLA's
  manual-sharding region compiles the float refine chain with different
  FMA contraction than a plain jit (1-ULP x/y skew measured on 4/2048
  candidates even with an ``optimization_barrier`` fence), while a
  plain-jit refine is bitwise-equal to the dense pipeline's.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.detect.scale_space import (
    INT32_MIN,
    DetectorConfig,
    _shift2d,
    _layer_accept,
    _trunc_div,
    build_pyramid,
    center_ge_warped,
    layer_geometry,
    refine_from_patches,
)
from ethzasl_brisk_jax.kernels.nms import _neighbor_max

IMG_HALO = 6     # image rows exchanged per side
SCORE_HALO = 4   # exact score rows beyond the tile (= IMG_HALO - 2)


def _exchange_row_halo(x: jnp.ndarray, halo: int, axis: str):
    """Extend a row-tiled array with `halo` rows from each neighbour.

    Missing neighbours (global top/bottom) contribute zeros — callers
    mask those rows by global index anyway.
    """
    n = jax.lax.axis_size(axis)
    if n == 1:
        z = jnp.zeros((halo,) + x.shape[1:], x.dtype)
        return jnp.concatenate([z, x, z], axis=0)
    down = [(i, i + 1) for i in range(n - 1)]   # send to next (my top rows
    up = [(i + 1, i) for i in range(n - 1)]     # come from prev's bottom)
    top_halo = jax.lax.ppermute(x[-halo:], axis, down)
    bot_halo = jax.lax.ppermute(x[:halo], axis, up)
    return jnp.concatenate([top_halo, x, bot_halo], axis=0)


def _harris_ext(img_tile, tile_row0, h_global, axis, score_fn):
    """Extended (tile + 2*SCORE_HALO rows) exact Harris scores.

    Row j of the result is global row ``tile_row0 - SCORE_HALO + j``;
    rows outside [2, h_global-2) are 0 (the dense kernel's border).
    """
    ext_img = _exchange_row_halo(img_tile, IMG_HALO, axis)
    sc = score_fn(ext_img)
    # Crop IMG_HALO -> SCORE_HALO (outermost 2 rows are stencil-invalid).
    crop = IMG_HALO - SCORE_HALO
    sc = sc[crop:-crop]
    ext_rows = sc.shape[0]
    grow = (
        jnp.arange(ext_rows, dtype=jnp.int32) + tile_row0 - SCORE_HALO
    )
    ok = (grow >= 2) & (grow < h_global - 2)
    zero = jnp.zeros((), sc.dtype)
    return jnp.where(ok[:, None], sc, zero)


def _warp_rows_split(src_ext, src_row0, src_h_global, affine,
                     dst_rows_global, dst_w):
    """Tile-windowed variant of scale_space.warp_scores_split.

    ``src_ext`` covers global rows [src_row0, src_row0 + ext_rows);
    ``dst_rows_global`` (D,) are the global dst row indices to produce.
    Columns span the full DST width (identical to the dense path).
    Returns (w_hi, w_lo) of shape (D, dst_w).
    """
    a, b, d = affine
    ext_rows, cols = src_ext.shape

    # --- columns: exactly the dense axis_terms over the dst width.
    valc = a * jnp.arange(dst_w, dtype=jnp.int32) + b
    u0 = _trunc_div(valc, d)
    fu = valc - u0 * d
    oku = (u0 + 1 < cols) & (u0 >= 0)
    u0c = jnp.clip(u0, 0, cols - 2)

    # --- rows: global coordinates, indexed into the extended tile.
    valr = a * dst_rows_global + b
    v0 = _trunc_div(valr, d)
    fv = valr - v0 * d
    okv = (v0 + 1 < src_h_global) & (v0 >= 0)
    v0l = jnp.clip(v0 - src_row0, 0, ext_rows - 2)

    s = src_ext.astype(jnp.int32)
    s_hi = s >> 15
    s_lo = s & 0x7FFF

    def bilerp(part):
        rows0 = jnp.take(part, v0l, axis=0)
        rows1 = jnp.take(part, v0l + 1, axis=0)
        p00 = jnp.take(rows0, u0c, axis=1)
        p01 = jnp.take(rows0, u0c + 1, axis=1)
        p10 = jnp.take(rows1, u0c, axis=1)
        p11 = jnp.take(rows1, u0c + 1, axis=1)
        fu_ = fu[None, :]
        fv_ = fv[:, None]
        return (d - fv_) * ((d - fu_) * p00 + fu_ * p01) + fv_ * (
            (d - fu_) * p10 + fu_ * p11
        )

    w_hi = bilerp(s_hi)
    w_lo = bilerp(s_lo)
    valid = okv[:, None] & oku[None, :]
    return jnp.where(valid, w_hi, 0), jnp.where(valid, w_lo, 0)


def _shift_cols(x, dx, fill):
    """Column shift only (rows come pre-extended): out[:, j] = x[:, j+dx].
    Delegates to the dense path's _shift2d so edge/fill semantics can
    never diverge between the two implementations."""
    return _shift2d(x, 0, dx, fill)


def _warp_rows_f32(src_ext, src_row0, src_h_global, affine,
                   dst_rows_global, dst_w):
    """Tile-windowed variant of scale_space.warp_scores_f32 (the float
    score path used by the uint16 pipeline): same exact-rational
    coordinates, fractions evaluated in float32."""
    a, b, d = affine
    ext_rows, cols = src_ext.shape

    valc = a * jnp.arange(dst_w, dtype=jnp.int32) + b
    u0 = _trunc_div(valc, d)
    fu = (valc - u0 * d).astype(jnp.float32) / float(d)
    oku = (u0 + 1 < cols) & (u0 >= 0)
    u0c = jnp.clip(u0, 0, cols - 2)

    valr = a * dst_rows_global + b
    v0 = _trunc_div(valr, d)
    fv = (valr - v0 * d).astype(jnp.float32) / float(d)
    okv = (v0 + 1 < src_h_global) & (v0 >= 0)
    v0l = jnp.clip(v0 - src_row0, 0, ext_rows - 2)

    rows0 = jnp.take(src_ext, v0l, axis=0)
    rows1 = jnp.take(src_ext, v0l + 1, axis=0)
    p00 = jnp.take(rows0, u0c, axis=1)
    p01 = jnp.take(rows0, u0c + 1, axis=1)
    p10 = jnp.take(rows1, u0c, axis=1)
    p11 = jnp.take(rows1, u0c + 1, axis=1)
    fu_ = fu[None, :]
    fv_ = fv[:, None]
    out = (1.0 - fv_) * ((1.0 - fu_) * p00 + fu_ * p01) + fv_ * (
        (1.0 - fu_) * p10 + fu_ * p11
    )
    valid = okv[:, None] & oku[None, :]
    return jnp.where(valid, out, 0.0)


def detect_keypoints_tiled(
    img: jnp.ndarray,
    config: DetectorConfig,
    mesh: Mesh,
    axis: str = "data",
) -> KeyPoints:
    """Bitwise-equal ``detect_keypoints`` on one row-sharded frame.

    uint8 (integer-Harris) and uint16 (float-Harris, the reference's
    16-bit sampler pipeline — image-down-sampling.cc:56,394) paths.
    Requires every pyramid layer height to be divisible by the mesh
    axis size.
    """
    if img.dtype not in (jnp.uint8, jnp.uint16):
        raise NotImplementedError("tiled detect: uint8/uint16 only")
    is_float = img.dtype == jnp.uint16
    n = mesh.shape[axis]
    h, w = img.shape
    n_layers = config.n_layers
    geoms = [layer_geometry(i) for i in range(n_layers)]

    # Static layer heights (mirror the actual downsampler shapes:
    # two-thirds = (h//3)*2, half = h//2 — kernels/downsample.py).
    heights = [h]
    if n_layers > 1:
        heights.append(h // 3 * 2)
    for i in range(2, n_layers):
        heights.append(heights[i - 2] // 2)
    for i, hl in enumerate(heights):
        if hl % n != 0:
            raise ValueError(
                f"layer {i} height {hl} not divisible by {n} tiles"
            )
        tl = hl // n
        if tl < IMG_HALO:
            # The single-hop ppermute exchange clamps x[-halo:] when the
            # tile has fewer than IMG_HALO rows, silently shifting every
            # global-row label — refuse instead of corrupting.
            raise ValueError(
                f"layer {i} tile height {tl} < IMG_HALO {IMG_HALO} "
                "(use fewer tiles or fewer octaves)"
            )
        # Tile rows must stay group-aligned for the LOCAL downsamplers
        # feeding deeper layers: 2/3-sample consumes 3-row groups,
        # half-sample consumes 2-row groups.
        if i == 0 and n_layers > 1 and tl % 3 != 0:
            raise ValueError(
                f"layer 0 tile rows {tl} not divisible by 3 "
                "(two-thirds sampling)"
            )
        if i + 2 < n_layers and tl % 2 != 0:
            raise ValueError(
                f"layer {i} tile rows {tl} not even (half sampling)"
            )

    if is_float:
        from ethzasl_brisk_jax.kernels.harris import harris_score_f32

        score_fn = harris_score_f32
        abs_thr = float(config.absolute_threshold)
        sentinel = -jnp.inf
        neigh_fill = -jnp.inf
    else:
        from ethzasl_brisk_jax.kernels.harris import harris_score_i32

        score_fn = harris_score_i32
        abs_thr = int(config.absolute_threshold)
        sentinel = INT32_MIN
        neigh_fill = None  # iinfo min of the score dtype, set below

    def tile_fn(img_tile):
        ti = jax.lax.axis_index(axis)
        pyr = build_pyramid(img_tile, n_layers)

        # Extended exact score maps per layer.
        exts = []
        row0s = []
        for i in range(n_layers):
            tl = heights[i] // n
            row0 = ti * tl
            exts.append(
                _harris_ext(pyr[i], row0, heights[i], axis, score_fn)
            )
            row0s.append(row0)

        per_layer = []
        for i in range(n_layers):
            sc_ext = exts[i]
            tl = heights[i] // n
            hl, wl = heights[i], sc_ext.shape[1]
            row0 = row0s[i]
            grow_ext = (
                jnp.arange(sc_ext.shape[0], dtype=jnp.int32)
                + row0 - SCORE_HALO
            )

            # --- 2-D maxima on the extended map (global border mask).
            neigh = _neighbor_max(
                sc_ext,
                neigh_fill if neigh_fill is not None
                else jnp.iinfo(sc_ext.dtype).min,
            )
            mask_ext = (sc_ext >= abs_thr) & (neigh <= sc_ext)
            inb_row = (grow_ext >= 2) & (grow_ext < hl - 2)
            inb_col = jnp.zeros((wl,), bool).at[2 : wl - 2].set(True)
            mask_ext &= inb_row[:, None] & inb_col[None, :]

            # --- warped-score suppression (global row coordinates).
            sl = slice(SCORE_HALO, SCORE_HALO + tl)
            mask = mask_ext[sl]
            sc_int = sc_ext[sl]
            if i + 1 < n_layers:
                a, b, d = geoms[i].above_map
                # dst rows interior +-1 for the 9-point shift probe.
                dst_rows = (
                    jnp.arange(tl + 2, dtype=jnp.int32) + row0 - 1
                )
                rok = (dst_rows >= 0) & (dst_rows < hl)
                if is_float:
                    wf = _warp_rows_f32(
                        exts[i + 1], row0s[i + 1] - SCORE_HALO,
                        heights[i + 1], (a, b, d), dst_rows, wl,
                    )
                    wf = jnp.where(rok[:, None], wf, 0.0)
                    # max of the 9 shifted maps == the dense separable
                    # _max3x3_f32 (same 0 fill; f32 max is exact).
                    m9 = None
                    for dy in (-1, 0, 1):
                        rs = slice(1 + dy, 1 + dy + tl)
                        for dx in (-1, 0, 1):
                            v = _shift_cols(wf[rs], dx, 0.0)
                            m9 = v if m9 is None else jnp.maximum(m9, v)
                    mask &= sc_int >= m9
                else:
                    w_hi, w_lo = _warp_rows_split(
                        exts[i + 1], row0s[i + 1] - SCORE_HALO,
                        heights[i + 1], (a, b, d), dst_rows, wl,
                    )
                    # Out-of-image dst rows contribute 0 (dense
                    # _shift2d fill).
                    w_hi = jnp.where(rok[:, None], w_hi, 0)
                    w_lo = jnp.where(rok[:, None], w_lo, 0)
                    for dy in (-1, 0, 1):
                        rs = slice(1 + dy, 1 + dy + tl)
                        for dx in (-1, 0, 1):
                            mask &= center_ge_warped(
                                sc_int,
                                _shift_cols(w_hi[rs], dx, 0),
                                _shift_cols(w_lo[rs], dx, 0),
                                d,
                            )
            if i > 0:
                a, b, d = geoms[i].below_map
                dst_rows = jnp.arange(tl, dtype=jnp.int32) + row0
                if is_float:
                    wf = _warp_rows_f32(
                        exts[i - 1], row0s[i - 1] - SCORE_HALO,
                        heights[i - 1], (a, b, d), dst_rows, wl,
                    )
                    mask &= sc_int >= wf
                else:
                    w_hi, w_lo = _warp_rows_split(
                        exts[i - 1], row0s[i - 1] - SCORE_HALO,
                        heights[i - 1], (a, b, d), dst_rows, wl,
                    )
                    mask &= center_ge_warped(sc_int, w_hi, w_lo, d)

            # --- per-tile candidates with GLOBAL flat indices.
            k = min(config.layer_cap(i), hl * wl)
            k_t = min(k, tl * wl)
            masked = jnp.where(mask, sc_int, sentinel)
            t_scores, t_idx = jax.lax.top_k(masked.reshape(-1), k_t)
            lys = t_idx // wl
            xs = t_idx % wl
            ys = lys + row0
            valid = jnp.take(mask.reshape(-1), t_idx)

            # 3x3 sub-pixel patches from the extended map, with the
            # dense path's global-border clip.
            doff = jnp.arange(-1, 2)
            xi = jnp.clip(xs[:, None] + doff[None, :], 0, wl - 1)
            gy = jnp.clip(ys[:, None] + doff[None, :], 0, hl - 1)
            yi = gy - (row0 - SCORE_HALO)
            patches = sc_ext[yi[:, :, None], xi[:, None, :]]

            # --- merge across tiles: stable sort == dense top_k ties.
            gs = jax.lax.all_gather(t_scores, axis, tiled=True)
            gx = jax.lax.all_gather(xs, axis, tiled=True)
            gy_ = jax.lax.all_gather(ys, axis, tiled=True)
            gv = jax.lax.all_gather(valid, axis, tiled=True)
            gp = jax.lax.all_gather(patches, axis, tiled=True)
            # ~s = -s-1 is strictly order-reversing WITHOUT the int32
            # overflow of -INT32_MIN (the masked sentinel); stable sort
            # in tile order reproduces dense top_k's flat-index ties.
            # Float scores (uint16 path) negate instead (-(-inf)=inf;
            # no NaNs; ties incl. +-0.0 stay in stable tile order).
            key = -gs if is_float else ~gs
            order = jnp.argsort(key, stable=True)[:k]
            per_layer.append(
                (gx[order], gy_[order], gs[order], gv[order], gp[order])
            )

        return per_layer

    # Jitted: run eagerly, the manual region dispatches (and on a GPU
    # compiles) every primitive on its own.
    fn = jax.jit(shard_map(
        tile_fn,
        mesh=mesh,
        in_specs=P(axis, None),
        out_specs=P(),
        check_vma=False,
    ))
    sharding = NamedSharding(mesh, P(axis, None))
    merged = fn(jax.device_put(img, sharding))

    # Accept + refine on the replicated merged candidates, in a plain jit
    # (see module docs: the shard_map manual region skews the float
    # refine by 1 ULP vs the dense pipeline; a plain jit is bit-equal).
    widths = [w]
    if n_layers > 1:
        widths.append(w // 3 * 2)
    for i in range(2, n_layers):
        widths.append(widths[i - 2] // 2)

    return _finish(
        merged, config, tuple(geoms), tuple(heights), tuple(widths)
    )


@partial(
    jax.jit, static_argnames=("config", "geoms", "heights", "widths")
)
def _finish(merged, config, geoms, heights, widths):
    """Replicated accept+refine (module-level jit: caches per config)."""
    out = []
    for i, (xs_m, ys_m, sc_m, v_m, p_m) in enumerate(merged):
        accept = _layer_accept(
            (xs_m, ys_m, sc_m, v_m), (heights[i], widths[i]), config
        )
        # Same accepted-prefix compaction as the dense path (bitwise-
        # equal output packing; scale_space.compact_accepted docs).
        from ethzasl_brisk_jax.detect.scale_space import compact_accepted

        xs_m, ys_m, sc_m, v_m, accept, p_m = compact_accepted(
            xs_m, ys_m, sc_m, v_m, accept, config, p_m,
            cap=config.refine_cap(i),
        )
        out.append(
            refine_from_patches(
                p_m, xs_m, ys_m, sc_m, accept, geoms[i], config
            )
        )
    return KeyPoints.concatenate(out)
