"""Classic BRISK (AST) scale-space detection, dense and batched.

Mirrors ``BriskScaleSpace`` + ``BriskFeatureDetector``
(``brisk/src/brisk-scale-space.cc``, ``brisk-feature-detector.cc``):

* pyramid of 2*octaves BriskLayers (octave/intra alternation) with dense
  OAST 9/16 corner+score maps and threshold maps (detect/ast_layer.py);
* IsMax2D with the smoothed tie-break (brisk-scale-space.cc:430-531);
* cross-layer 3-D refinement: GetScoreMaxAbove/Below patch scans with
  early drop-threshold rejection (:757-1099), 1-D scale parabolas
  Refine1D/_1/_2 (:1101-1228) and the int-coefficient Subpixel2D
  (:1230-1364);
* the layer-0 "virtual below" estimate from AGAST 5/8 (:556-593).

The reference's lazy per-corner scoring becomes dense score maps; its
sequential patch scans become fixed-size vectorized probe lists (the scan
order, first-maximum-wins rule and the GetScoreMaxBelow tie-break are all
reproduced). Per-candidate work is O(few dozen gathers), batched over a
static candidate capacity.

Float math follows the reference's C float semantics; scores are small
ints so all comparisons are exact except last-ulp division effects in the
subpixel/1-D fits.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.detect.ast_layer import AstLayerMaps, build_ast_layer
from ethzasl_brisk_jax.kernels.agast import agast5_8_score_map
from ethzasl_brisk_jax.kernels.downsample import halfsample8, twothirdsample8

f32 = jnp.float32

K_MAX_THRESHOLD = 1     # brisk-scale-space.cc:47
K_DROP_THRESHOLD = 5    # :48
K_MIN_DROP = 15         # :49
K_BASIC_SIZE = 12.0     # :45


def _trunc_i32(x):
    return jnp.trunc(x).astype(jnp.int32)


def _dbl(x):
    """Mirror a C++ *double* intermediate.

    The reference mixes double literals into float expressions in specific
    places (e.g. ``max /= 3072.0`` brisk-scale-space.cc:1140, the
    ``/ 6.0`` scan coords :777, ``/ 18.0`` in Subpixel2D :1253) — those
    sites compute in double and round to float once at the assignment.
    Under x64 (the CPU parity path) this reproduces that; with x64 off
    it degrades to f32, which only perturbs last-ulp refinement.
    """
    dt = jnp.float64 if jax.config.jax_enable_x64 else f32
    return jnp.asarray(x).astype(dt)


def _dbl_div(num_f32, denom):
    """float(x) / <double literal> — double division, float result."""
    return (_dbl(num_f32) / denom).astype(f32)


def _fmul(a, b):
    """f32 product immune to FMA contraction: multiply exactly in f64
    (24+24 < 53 mantissa bits) and round once to f32 — bit-identical to
    a plain f32 multiply, but LLVM cannot contract the f64 mul with a
    downstream f32 add into fma(a, b, c).

    Why needed: the reference's scalar C++ (g++ -O1 -mssse3, no FMA ISA)
    rounds every multiply separately; under jit, XLA:CPU fusions let
    LLVM contract `a*b + c`, skewing ~10% of refined responses by 1 ULP
    vs the compiled reference. HLO-level `optimization_barrier` does NOT
    survive to codegen on the CPU backend (verified in the optimized
    HLO), so the fence must be structural. Without x64 this degrades to
    a plain (contractible) f32 multiply — acceptable off the
    golden-parity CPU path."""
    dt = jnp.float64 if jax.config.jax_enable_x64 else f32
    return (jnp.asarray(a).astype(dt) * jnp.asarray(b).astype(dt)).astype(
        f32
    )


def _nf(x):
    """Legacy fence shim (see _fmul): kept for f64 chains where a
    structural fence is unavailable; best-effort only."""
    return jax.lax.optimization_barrier(x)


def build_ast_pyramid(
    img: jnp.ndarray,
    octaves: int,
    threshold: int,
    lower: int = 10,
    upper: int = 230,
    v1: bool = False,
) -> list[AstLayerMaps]:
    """ConstructPyramid (brisk-scale-space.cc:64-90; v1 identical
    geometry, brisk-v1.cc:577-593, but with v1's OWN resamplers — their
    avg_epu8 rounding differs from the v2 kernels on every derived
    layer, kernels/downsample.py twothirdsample8_v1/halfsample8_v1)."""
    if v1:
        from ethzasl_brisk_jax.kernels.downsample import (
            halfsample8_v1,
            twothirdsample8_v1,
        )

        half, twothirds = halfsample8_v1, twothirdsample8_v1
    else:
        half, twothirds = halfsample8, twothirdsample8
    n_layers = max(2 * octaves, 1)
    imgs = [img]
    if n_layers > 1:
        imgs.append(twothirds(img))
    for i in range(2, n_layers):
        imgs.append(half(imgs[i - 2]))

    layers = []
    scale = 1.0
    for i, im in enumerate(imgs):
        if i == 0:
            scale, offset = 1.0, 0.0
        else:
            scale = 2.0 ** (i // 2) * (1.0 if i % 2 == 0 else 1.5)
            offset = 0.5 * scale - 0.5
        layers.append(
            build_ast_layer(
                im, threshold, upper, lower, scale, offset, v1=v1
            )
        )
    return layers


# ---------------------------------------------------------------------------
# Subpixel2D — the int-coefficient AST variant (brisk-scale-space.cc:1230).
# Patch convention: s[..., a, b] = Score(x + a - 1, y + b - 1), i.e. the
# FIRST index moves x (the reference's call sites pass s_0_1 = (x-1, y)).
# Returns (delta_x, delta_y, refined_max).
# ---------------------------------------------------------------------------
def ast_subpixel2d(s: jnp.ndarray):
    s = s.astype(jnp.int32)
    s_0_0 = s[..., 0, 0]
    s_0_1 = s[..., 0, 1]
    s_0_2 = s[..., 0, 2]
    s_1_0 = s[..., 1, 0]
    s_1_1 = s[..., 1, 1]
    s_1_2 = s[..., 1, 2]
    s_2_0 = s[..., 2, 0]
    s_2_1 = s[..., 2, 1]
    s_2_2 = s[..., 2, 2]

    tmp1 = s_0_0 + s_0_2 - 2 * s_1_1 + s_2_0 + s_2_2
    coeff1 = 3 * (tmp1 + s_0_1 - ((s_1_0 + s_1_2) << 1) + s_2_1)
    coeff2 = 3 * (tmp1 - ((s_0_1 + s_2_1) << 1) + s_1_0 + s_1_2)
    tmp2 = s_0_2 - s_2_0
    tmp3 = s_0_0 + tmp2 - s_2_2
    tmp4 = tmp3 - 2 * tmp2
    coeff3 = -3 * (tmp3 + s_0_1 - s_2_1)
    coeff4 = -3 * (tmp4 + s_1_0 - s_1_2)
    coeff5 = (s_0_0 - s_0_2 - s_2_0 + s_2_2) << 2
    # C: -(X) << 1  ==  (-X) * 2.
    coeff6 = (
        -(
            s_0_0
            + s_0_2
            - ((s_1_0 + s_0_1 + s_1_2 + s_2_1) << 1)
            - 5 * s_1_1
            + s_2_0
            + s_2_2
        )
    ) << 1

    h_det = 4 * coeff1 * coeff2 - coeff5 * coeff5

    c1f = coeff1.astype(f32)
    c2f = coeff2.astype(f32)
    c3f = coeff3.astype(f32)
    c4f = coeff4.astype(f32)
    c5f = coeff5.astype(f32)
    c6f = coeff6.astype(f32)

    # Branch B: corner maximum (first corner wins ties).
    corner_vals = jnp.stack(
        [
            coeff3 + coeff4 + coeff5,
            -coeff3 + coeff4 - coeff5,
            coeff3 - coeff4 - coeff5,
            -coeff3 - coeff4 + coeff5,
        ],
        axis=-1,
    )
    corner_dx = jnp.asarray([1.0, -1.0, 1.0, -1.0], f32)
    corner_dy = jnp.asarray([1.0, 1.0, -1.0, -1.0], f32)
    # argmax keeps the FIRST maximum == reference's strict-'>' scan.
    ci = jnp.argmax(corner_vals, axis=-1)
    b_max_i = jnp.take_along_axis(corner_vals, ci[..., None], axis=-1)[..., 0]
    b_dx = corner_dx[ci]
    b_dy = corner_dy[ci]
    # C++: static_cast<float>(int sum) / 18.0 — double division (:1288).
    b_val = _dbl_div((b_max_i + coeff1 + coeff2 + coeff6).astype(f32), 18.0)

    # Branch C: interior.
    safe_det = jnp.where(h_det == 0, 1, h_det).astype(f32)
    dx0 = (2 * coeff2 * coeff3 - coeff4 * coeff5).astype(f32) / (-safe_det)
    dy0 = (2 * coeff1 * coeff4 - coeff3 * coeff5).astype(f32) / (-safe_det)

    tx = dx0 > 1.0
    tx_ = dx0 < -1.0
    ty = dy0 > 1.0
    ty_ = dy0 < -1.0
    oob = tx | tx_ | ty | ty_

    safe_c1 = jnp.where(coeff1 == 0, 1, 2 * coeff1).astype(f32)
    safe_c2 = jnp.where(coeff2 == 0, 1, 2 * coeff2).astype(f32)

    delta_x1 = jnp.where(tx, 1.0, jnp.where(tx_, -1.0, 0.0)).astype(f32)
    delta_y1 = jnp.where(
        tx,
        -(c4f + c5f) / safe_c2,
        jnp.where(tx_, -(c4f - c5f) / safe_c2, 0.0),
    ).astype(f32)
    delta_y1 = jnp.clip(delta_y1, -1.0, 1.0)

    delta_y2 = jnp.where(ty, 1.0, jnp.where(ty_, -1.0, 0.0)).astype(f32)
    delta_x2 = jnp.where(
        ty,
        -(c3f + c5f) / safe_c1,
        jnp.where(ty_, -(c3f - c5f) / safe_c1, 0.0),
    ).astype(f32)
    delta_x2 = jnp.clip(delta_x2, -1.0, 1.0)

    def quad(dx, dy):
        # Numerator in float (C++ int*float products), / 18.0 in double
        # (:1344-1348, :1360-1363).
        return _dbl_div(
            _fmul(_fmul(c1f, dx), dx) + _fmul(_fmul(c2f, dy), dy)
            + _fmul(c3f, dx) + _fmul(c4f, dy)
            + _fmul(_fmul(c5f, dx), dy) + c6f,
            18.0,
        )

    max1 = quad(delta_x1, delta_y1)
    max2 = quad(delta_x2, delta_y2)
    pick1 = max1 > max2
    # Reference quirk kept: delta_y gets delta_x{1,2} (:1352-1358).
    bnd_dx = jnp.where(pick1, delta_x1, delta_x2)
    bnd_dy = jnp.where(pick1, delta_x1, delta_x2)
    bnd_val = jnp.where(pick1, max1, max2)

    c_dx = jnp.where(oob, bnd_dx, dx0)
    c_dy = jnp.where(oob, bnd_dy, dy0)
    c_val = jnp.where(oob, bnd_val, quad(dx0, dy0))

    is_zero = h_det == 0
    is_corner = ~((h_det > 0) & (coeff1 < 0))

    delta_x = jnp.where(
        is_zero, 0.0, jnp.where(is_corner, b_dx, c_dx)
    ).astype(f32)
    delta_y = jnp.where(
        is_zero, 0.0, jnp.where(is_corner, b_dy, c_dy)
    ).astype(f32)
    val = jnp.where(
        is_zero,
        _dbl_div(coeff6.astype(f32), 18.0),
        jnp.where(is_corner, b_val, c_val),
    ).astype(f32)
    return delta_x, delta_y, val


# ---------------------------------------------------------------------------
# Refine1D variants (brisk-scale-space.cc:1101-1228).
# ---------------------------------------------------------------------------
def _refine1d(
    s_05, s0, s05, coeffs, lo, hi, lo_scale, hi_scale, div,
    div_is_double=True,
):
    """Shared 1-D parabola refinement. Returns (scale, max)."""
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = coeffs
    # C++ `int(1024.0 * s + 0.5)` is double arithmetic (:1103); in f32
    # the +0.5 can round at the 25-bit boundary and shift the trunc.
    i_05 = _trunc_i32(_nf(_dbl(s_05) * 1024.0) + 0.5)
    i0 = _trunc_i32(_nf(_dbl(s0) * 1024.0) + 0.5)
    i05 = _trunc_i32(_nf(_dbl(s05) * 1024.0) + 0.5)

    a = a0 * i_05 + a1 * i0 + a2 * i05
    b = b0 * i_05 + b1 * i0 + b2 * i05
    c = c0 * i_05 + c1 * i0 + c2 * i05

    # Degenerate: pick the plain maximum (order of checks matters).
    deg_scale = jnp.where(
        (s0 >= s_05) & (s0 >= s05),
        f32(1.0),
        jnp.where((s_05 >= s0) & (s_05 >= s05), f32(lo_scale),
                  f32(hi_scale)),
    )
    deg_max = jnp.where(
        (s0 >= s_05) & (s0 >= s05),
        s0,
        jnp.where((s_05 >= s0) & (s_05 >= s05), s_05, s05),
    )

    safe_a = jnp.where(a == 0, 1, 2 * a).astype(f32)
    ret = -b.astype(f32) / safe_a
    ret = jnp.clip(ret, lo, hi)
    mx_num = (
        c.astype(f32) + _fmul(_fmul(a.astype(f32), ret), ret)
        + _fmul(b.astype(f32), ret)
    )
    if div_is_double:
        # `max /= 3072.0` / `2048.0` are double divisions (:1140, :1184).
        mx = _dbl_div(mx_num, div)
    else:
        # Refine1D_2's `max /= 1024` divides by an *int* → float (:1227).
        mx = mx_num / f32(div)

    degenerate = a >= 0
    return (
        jnp.where(degenerate, deg_scale, ret),
        jnp.where(degenerate, deg_max, mx),
    )


def refine1d(s_05, s0, s05):
    """Octave layers >0: anchors 0.75 / 1.0 / 1.5 (:1101-1142)."""
    return _refine1d(
        s_05, s0, s05,
        ((16, -24, 8), (-40, 54, -14), (24, -27, 6)),
        0.75, 1.5, 0.75, 1.5, 3072.0,
    )


def refine1d_1(s_05, s0, s05):
    """Intra layers: anchors 2/3 / 1.0 / 4/3 (:1144-1186)."""
    return _refine1d(
        s_05, s0, s05,
        ((9, -18, 9), (-21, 36, -15), (12, -16, 6)),
        2.0 / 3.0, 4.0 / 3.0, 2.0 / 3.0, 4.0 / 3.0, 2048.0,
    )


def refine1d_2(s_05, s0, s05):
    """Layer 0 with the virtual 5_8 below: anchors 0.7/1.0/1.5 (:1188-1228)."""
    return _refine1d(
        s_05, s0, s05,
        ((2, -4, 2), (-5, 8, -3), (3, -3, 1)),
        0.7, 1.5, 0.7, 1.5, 1024.0, div_is_double=False,
    )


# ---------------------------------------------------------------------------
# Score accessors over dense maps.
# ---------------------------------------------------------------------------
def _gather(map2d: jnp.ndarray, ys, xs):
    h, w = map2d.shape
    yc = jnp.clip(ys, 0, h - 1)
    xc = jnp.clip(xs, 0, w - 1)
    return map2d[yc, xc]


def _int_score(layer: AstLayerMaps, xs, ys, center):
    """GetAgastScore(int x, int y, threshold=center) (brisk-layer.cc:118).

    With the dense maps: detected corners return their seeded cache value
    max(t*, thrmap); other pixels return t* if t* >= center else 0 (the
    lazy recompute path; cache reuse never changes any comparison against
    `center`, see module docs). Outside [3, n-4]: 0.
    """
    h, w = layer.img.shape
    inb = (xs >= 3) & (ys >= 3) & (xs < w - 3) & (ys < h - 3)
    is_corner = _gather(layer.corner, ys, xs)
    cache = _gather(layer.cache, ys, xs)
    t_star = _gather(layer.t_star, ys, xs)
    fresh = jnp.where(t_star >= center, t_star, 0)
    return jnp.where(inb, jnp.where(is_corner, cache, fresh), 0)


def _cache_score(layer: AstLayerMaps, xs, ys):
    """GetAgastScore(x, y, 1): the threshold-1 view = dense cache map."""
    h, w = layer.img.shape
    inb = (xs >= 3) & (ys >= 3) & (xs < w - 3) & (ys < h - 3)
    return jnp.where(inb, _gather(layer.cache, ys, xs), 0)


def _bilinear_from(score_fn, xf, yf):
    """GetAgastScore(float xf, float yf, 1, scale=1) (brisk-layer.cc:179-...):
    f32 bilinear of the 4 int scores from ``score_fn(x, y)``, truncated
    to uint8."""
    x = _trunc_i32(xf)
    y = _trunc_i32(yf)
    rx1 = xf - x.astype(f32)
    rx = f32(1.0) - rx1
    ry1 = yf - y.astype(f32)
    ry = f32(1.0) - ry1
    v00 = score_fn(x, y).astype(f32)
    v10 = score_fn(x + 1, y).astype(f32)
    v01 = score_fn(x, y + 1).astype(f32)
    v11 = score_fn(x + 1, y + 1).astype(f32)
    out = (
        _fmul(_fmul(rx, ry), v00) + _fmul(_fmul(rx1, ry), v10)
        + _fmul(_fmul(rx, ry1), v01) + _fmul(_fmul(rx1, ry1), v11)
    )
    return _trunc_i32(out).astype(f32)  # uint8 truncation (values <= 255)


def _bilinear_score(layer: AstLayerMaps, xf, yf):
    return _bilinear_from(
        lambda x, y: _cache_score(layer, x, y), xf, yf
    )


def _agast58_score(layer_t58: jnp.ndarray, xs, ys):
    """GetAgastScore_5_8(x, y, 1) (brisk-layer.cc:134-145)."""
    h, w = layer_t58.shape
    inb = (xs >= 2) & (ys >= 2) & (xs < w - 2) & (ys < h - 2)
    t = _gather(layer_t58, ys, xs)
    return jnp.where(inb & (t >= 1), t, 0)


def _patch33(score_fn, xs, ys):
    """(K, 3, 3) patch with patch[k, a, b] = score(x+a-1, y+b-1)."""
    d = jnp.arange(-1, 2)
    xg = xs[:, None, None] + d[None, :, None]   # a axis moves x
    yg = ys[:, None, None] + d[None, None, :]   # b axis moves y
    return score_fn(xg, yg)


# ---------------------------------------------------------------------------
# IsMax2D (brisk-scale-space.cc:430-531).
# ---------------------------------------------------------------------------
_NEIGH8 = (
    (-1, 0), (1, 0), (0, -1), (0, 1), (-1, 1), (1, 1), (1, -1), (-1, -1),
)
# Tie-scan order of the reference's delta list (:482-513):
_TIE_ORDER = (
    (-1, -1), (0, -1), (1, -1), (-1, 0), (1, 0), (-1, 1), (0, 1), (1, 1),
)


def earliest_toucher_map(layer: AstLayerMaps) -> jnp.ndarray:
    """Per pixel q: the smallest row-major index of an adjacent corner whose
    IsMax2D neighbor query would seed q's lazy score cache with t*(q) —
    i.e. an adjacent corner c with center(c) <= t*(q). INT32_MAX if none.

    Models the reference's order-dependent scores_ cache fill
    (brisk-layer.cc:118-132 writes on every GetAgastScore miss; corners
    are processed row-major, each querying its 8 neighbors).
    """
    h, w = layer.img.shape
    rm = (
        jnp.arange(h, dtype=jnp.int32)[:, None] * w
        + jnp.arange(w, dtype=jnp.int32)[None, :]
    )
    inf = jnp.int32(2**31 - 1)
    best = jnp.full((h, w), inf)
    for dx, dy in _NEIGH8:
        c_corner = _shift_bool(layer.corner, dy, dx)
        c_center = _shift_i32(layer.cache, dy, dx)
        c_rm = _shift_i32(rm, dy, dx, fill=inf)
        ok = c_corner & (c_center <= layer.t_star)
        best = jnp.minimum(best, jnp.where(ok, c_rm, inf))
    return best


def _shift_bool(x, dy, dx):
    h, w = x.shape
    out = jnp.zeros_like(x)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


def _shift_i32(x, dy, dx, fill=0):
    h, w = x.shape
    out = jnp.full_like(x, fill)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


def is_max_2d(
    layer: AstLayerMaps,
    xs,
    ys,
    raw_model: str = "emulated",
    e_query: Optional[jnp.ndarray] = None,
    e_patch: Optional[jnp.ndarray] = None,
    prefill: Optional[jnp.ndarray] = None,
):
    """Vectorized IsMax2D (brisk-scale-space.cc:430-531).

    The tie path reads raw scores_ memory, whose content depends on the
    candidate processing order. raw_model:
      * 'emulated' — earliest-toucher model of the lazy cache fill:
        - e_query(q): min row-major index of an adjacent corner whose
          IsMax2D query seeds q with t* (needs center <= t*, t* > 2);
        - e_patch(q): min row-major index of an adjacent *accepted*
          candidate whose Refine3D 3x3 patch seeds q at threshold 1
          (t* >= 1);
        - prefill(q): True where a preceding layer's cross-layer probes
          already seeded q at threshold 1;
      * 'cache'  — dense threshold-1 view (upper bound);
      * 'corner' — corners only (lower bound).
    """
    # Patch-prefetch: ONE (K, 5, 5) gather per map instead of ~300
    # separate (K,) gathers (each neighbor/raw read used to be its own
    # gather op).
    # _gather clips per element, so patch[2+oy, 2+ox] is value-identical
    # to _gather(map, ys+oy, xs+ox) for |ox|,|oy| <= 2.
    h_l, w = layer.img.shape
    d2 = jnp.arange(-2, 3)
    yy = ys[:, None, None] + d2[None, :, None]   # (K, 5oy, 1)
    xx = xs[:, None, None] + d2[None, None, :]   # (K, 1, 5ox)
    p_corner = _gather(layer.corner, yy, xx)     # (K, 5, 5)
    p_cache = _gather(layer.cache, yy, xx)
    p_t = _gather(layer.t_star, yy, xx)
    inb_p = (
        (xx >= 3) & (yy >= 3) & (xx < w - 3) & (yy < h_l - 3)
    )

    center = p_cache[:, 2, 2]  # candidates are corners
    cand_rm = ys * w + xs

    def int_score(ox, oy):
        """_int_score(layer, xs+ox, ys+oy, center) from the patches."""
        cnr = p_corner[:, 2 + oy, 2 + ox]
        cch = p_cache[:, 2 + oy, 2 + ox]
        ts = p_t[:, 2 + oy, 2 + ox]
        fresh = jnp.where(ts >= center, ts, 0)
        return jnp.where(
            inb_p[:, 2 + oy, 2 + ox], jnp.where(cnr, cch, fresh), 0
        )

    neigh = {(dx, dy): int_score(dx, dy) for dx, dy in _NEIGH8}
    reject = jnp.zeros_like(xs, bool)
    for v in neigh.values():
        reject |= v > center

    # Smoothed tie-break.
    s_10, s10 = neigh[(-1, 0)], neigh[(1, 0)]
    s0_1, s01 = neigh[(0, -1)], neigh[(0, 1)]
    s_1_1, s1_1 = neigh[(-1, -1)], neigh[(1, -1)]
    s_11, s11 = neigh[(-1, 1)], neigh[(1, 1)]
    smoothed_center = (
        4 * center + 2 * (s_10 + s10 + s0_1 + s01) + s_1_1 + s1_1 + s_11 + s11
    )

    if raw_model == "emulated" and e_query is None:
        e_query = earliest_toucher_map(layer)
    p_early = (
        _gather(e_query, yy, xx) if raw_model == "emulated" else None
    )
    p_epatch = _gather(e_patch, yy, xx) if e_patch is not None else None
    p_prefill = (
        _gather(prefill, yy, xx) if prefill is not None else None
    )

    def raw(ox, oy):
        """Raw scores_ read at candidate offset (ox, oy), |ox|,|oy| <= 2."""
        q_corner = p_corner[:, 2 + oy, 2 + ox]
        q_cache = p_cache[:, 2 + oy, 2 + ox]
        q_t = p_t[:, 2 + oy, 2 + ox]
        if raw_model == "corner":
            return jnp.where(q_corner, q_cache, 0)
        if raw_model == "cache":
            return jnp.where(inb_p[:, 2 + oy, 2 + ox], q_cache, 0)
        q_early = p_early[:, 2 + oy, 2 + ox]
        own = (
            (abs(ox) <= 1) and (abs(oy) <= 1)
        )  # static: q adjacent to the candidate itself
        touched_q = q_early < cand_rm
        if own:
            touched_q |= center <= q_t
        thr1 = jnp.zeros_like(touched_q)
        if p_epatch is not None:
            thr1 |= p_epatch[:, 2 + oy, 2 + ox] < cand_rm
        if p_prefill is not None:
            thr1 |= p_prefill[:, 2 + oy, 2 + ox]
        val = jnp.where(
            thr1 & (q_t >= 1),
            q_t,
            jnp.where(touched_q & (q_t > 2), q_t, 0),
        )
        return jnp.where(q_corner, q_cache, val)

    for dx, dy in _TIE_ORDER:
        tied = neigh[(dx, dy)] == center
        other = (
            raw(dx - 1, dy - 1)
            + 2 * raw(dx, dy - 1)
            + raw(dx + 1, dy - 1)
            + 2 * raw(dx + 1, dy)
            + 4 * raw(dx, dy)
            + 2 * raw(dx - 1, dy)
            + raw(dx - 1, dy + 1)
            + 2 * raw(dx, dy + 1)
            + raw(dx + 1, dy + 1)
        )
        reject |= tied & (other > smoothed_center)

    return ~reject


# ---------------------------------------------------------------------------
# GetScoreMaxAbove / GetScoreMaxBelow (brisk-scale-space.cc:757-1099).
# ---------------------------------------------------------------------------
def _score_patch_max(
    neighbor: AstLayerMaps,
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    thr: jnp.ndarray,
    mode: str,       # above_octave | above_intra | below_octave | below_intra
    drop: int = K_DROP_THRESHOLD,
):
    """Ordered probe scan over the neighbor-layer patch.

    Returns (ismax, score, dx, dy) per candidate — the reference's scan
    order, first-strict-maximum rule, the below-scan smoothing tie-break,
    the missing threshold check on the bottom row, and the final
    Subpixel2D + saturation are all reproduced.

    ``drop``: the v2 engine rejects when a probe exceeds thr +
    kDropThreshold_ (=5); the v1 engine compares against the center
    score directly (brisk-v1.cc:1113-1120 takes `threshold` verbatim) —
    pass drop=0.
    """
    threshold = (thr + drop).astype(f32)
    xsf = xs.astype(f32)
    ysf = ys.astype(f32)

    # Scan-window coords. Literal types per reference site: above-octave
    # `/ 6.0` double (:777), above-intra `/ 8.0f` FLOAT (:783),
    # below-octave `/ 6.0` double (:933), below-intra `/ 4.0` double
    # (:940) — double sites round to float once, after the division.
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

    ix_first = _trunc_i32(x_1 + 1)
    ix_last = _trunc_i32(x1)
    iy_first = _trunc_i32(y_1 + 1)
    iy_last = _trunc_i32(y1)

    # Prefetch: every read this scan makes (int probes, bilinear taps of
    # the float probes, the tie-break 3x3 sums, the final Subpixel 3x3)
    # lies inside a 7x7 window anchored 2 below (iy_first, ix_first):
    # trunc(x_1) >= ix_first-1, taps reach trunc(x1)+1 <= ix_first+n_int
    # +1, tie/patch reads stay within +-1 of scan positions. ONE (K,7,7)
    # gather replaces the ~50-90 per-probe gathers this function used to
    # issue. _cache_score's [3, n-4) zero-border is baked into the
    # window, so picks are value-identical.
    x0 = ix_first - 2
    y0 = iy_first - 2
    d7 = jnp.arange(7)
    yy7 = y0[:, None, None] + d7[None, :, None]
    xx7 = x0[:, None, None] + d7[None, None, :]
    h_n, w_n = neighbor.img.shape
    win = jnp.where(
        (xx7 >= 3) & (yy7 >= 3) & (xx7 < w_n - 3) & (yy7 < h_n - 3),
        _gather(neighbor.cache, yy7, xx7),
        0,
    ).astype(jnp.int32)
    win49 = win.reshape(win.shape[0], 49)
    iota49 = jnp.arange(49, dtype=jnp.int32)

    def cache_pick(ax, ay):
        """_cache_score(neighbor, ax, ay) from the prefetched window.

        ax/ay: (K,) or (K, ...) absolute coords inside the window."""
        extra = ax.ndim - 1
        x0e = x0.reshape(x0.shape + (1,) * extra)
        y0e = y0.reshape(y0.shape + (1,) * extra)
        idx = (ay - y0e) * 7 + (ax - x0e)
        w49 = win49.reshape(win49.shape[:1] + (1,) * extra + (49,))
        return jnp.sum(
            jnp.where(idx[..., None] == iota49, w49, 0), axis=-1
        )

    # Column specs: (kind, coord_f32_or_int, exists)
    cols = [("f", x_1, None)]
    for k in range(n_int):
        xi = ix_first + k
        cols.append(("i", xi, xi <= ix_last))
    cols.append(("f", x1, None))

    rows = [("f", y_1, None, True)]
    for k in range(n_int):
        yi = iy_first + k
        rows.append(("i", yi, yi <= iy_last, True))
    rows.append(("f", y1, None, False))  # bottom row: no threshold check

    def probe(ckind, cval, rkind, rval):
        if ckind == "i" and rkind == "i":
            return cache_pick(cval, rval).astype(f32)
        xf = cval.astype(f32) if ckind == "i" else cval
        yf = rval.astype(f32) if rkind == "i" else rval
        return _bilinear_from(cache_pick, xf, yf)

    k = xs.shape[0]
    exceeded = jnp.zeros((k,), bool)
    first = True
    mx = ix_first
    my = iy_first
    best: Optional[jnp.ndarray] = None

    for rkind, rval, rexists, rcheck in rows:
        for ci, (ckind, cval, cexists) in enumerate(cols):
            exists = jnp.ones((k,), bool)
            if cexists is not None:
                exists &= cexists
            if rexists is not None:
                exists &= rexists
            v = probe(ckind, cval, rkind, rval)
            # Position this probe would assign.
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
                exceeded |= exists & (v > threshold)
            if tie_break and ckind == "i" and rkind == "i":
                # GetScoreMaxBelow middle tie-break (:1004-1028): on
                # equality, compare smoothed 3x3 sums (threshold-1 scores).
                def sm(ax, ay):
                    return (
                        2 * (
                            cache_pick(ax - 1, ay)
                            + cache_pick(ax + 1, ay)
                            + cache_pick(ax, ay + 1)
                            + cache_pick(ax, ay - 1)
                        )
                        + cache_pick(ax + 1, ay + 1)
                        + cache_pick(ax - 1, ay + 1)
                        + cache_pick(ax + 1, ay - 1)
                        + cache_pick(ax - 1, ay - 1)
                    )

                tie = exists & (v == best)
                t1 = sm(cval, rval)
                t2 = sm(mx, my)
                move = tie & (t1 > t2)
                mx = jnp.where(move, cval, mx)
                my = jnp.where(move, rval, my)
            upd = exists & (v > best)
            best = jnp.where(upd, v, best)
            mx = jnp.where(upd, px, mx)
            my = jnp.where(upd, py, my)

    # Subpixel on the 3x3 around (mx, my) — picks from the prefetched
    # window ((mx, my) is a scan position, so the +-1 reads stay inside).
    patch = _patch33(cache_pick, mx, my)
    dx1, dy1, refined = ast_subpixel2d(patch)
    real_x = mx.astype(f32) + dx1
    real_y = my.astype(f32) + dy1

    # Back-conversion literal types: above-octave all-FLOAT `6.0f .. 4.0f`
    # (:884), above-intra double `* 8.0 + 1.0) / 6.0` (:887), below-octave
    # double (:1067), below-intra double (:1070). At the double sites the
    # whole chain INCLUDING `- x_layer` is double (float promotes), with
    # one round to float at the dx assignment.
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


# ---------------------------------------------------------------------------
# Refine3D (brisk-scale-space.cc:534-754).
# ---------------------------------------------------------------------------
def refine3d(
    layers: list[AstLayerMaps],
    i: int,
    xs: jnp.ndarray,
    ys: jnp.ndarray,
    t58_layer0: Optional[jnp.ndarray],
    v1: bool = False,
):
    """Vectorized Refine3D for candidates on layer i (not the last layer).

    Returns (ismax, score, x, y, scale_total) in original-image coords.

    ``v1``: the legacy engine (brisk-v1.cc:942-1110) has NO scale-axis
    weak/edge gates (always refines the scale) and its scan drop
    threshold is the center score itself (drop=0).
    """
    this = layers[i]
    center = _cache_score(this, xs, ys)
    drop = 0 if v1 else K_DROP_THRESHOLD

    is_octave = i % 2 == 0
    above_mode = "above_octave" if is_octave else "above_intra"
    ismax_a, max_above, dxa, dya = _score_patch_max(
        layers[i + 1], xs, ys, center, above_mode, drop=drop
    )

    # Patch on this layer.
    patch = _patch33(lambda xg, yg: _cache_score(this, xg, yg), xs, ys)
    dxl, dyl, max_layer = ast_subpixel2d(patch)
    s_1_1 = patch[:, 1, 1]

    centerf = center.astype(f32)
    max_layer_or_center = jnp.maximum(centerf, max_layer)

    if is_octave:
        if i == 0:
            # Virtual below from AGAST 5/8 (brisk-scale-space.cc:556-593).
            p58 = _patch33(
                lambda xg, yg: _agast58_score(t58_layer0, xg, yg), xs, ys
            )
            max_below = jnp.max(p58.reshape(p58.shape[0], -1), axis=1)
            dxb, dyb, _ = ast_subpixel2d(p58)
            max_below_f = max_below.astype(f32)
            ismax_b = jnp.ones_like(ismax_a)
        else:
            ismax_b, max_below_f, dxb, dyb = _score_patch_max(
                layers[i - 1], xs, ys, center, "below_octave", drop=drop
            )
        # Scale-axis tests (:612-630). v1 has none (brisk-v1.cc:1012).
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

        # Position interpolation (:655-684).
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
            # Layer 0: up-branch multiplies by scale()=1/offset()=0 anyway;
            # the down-branch explicitly omits the transform (:662-668).
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
        ismax_b, max_below_f, dxb, dyb = _score_patch_max(
            layers[i - 1], xs, ys, center, "below_intra", drop=drop
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

        r_scale, r_max = refine1d_1(max_below_f, max_layer_or_center,
                                    max_above)
        scale = jnp.where(no_refine, f32(1.0), r_scale)
        mx = jnp.where(no_refine, max_layer, r_max)

        # C++ `4.0 - scale * 3.0` / `scale * 3.0 - 2.0` are double chains
        # rounded once to float (:731, :739); f32 would round scale*3 too.
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
    return ismax, mx, x_out, y_out, scale_total, ismax_a, ismax_b


# ---------------------------------------------------------------------------
# Top-level detection (BriskFeatureDetector::detectImpl + GetKeypoints).
# ---------------------------------------------------------------------------
def _process_layer(
    layers, i, xs, ys, t58, e_query, e_patch, prefill, is2d_override=None,
    v1=False,
):
    """One layer's maxima pipeline. Returns (is2d, accepted, kp fields)."""
    layer = layers[i]
    n_layers = len(layers)
    if is2d_override is not None:
        is2d = is2d_override
    else:
        is2d = is_max_2d(
            layer, xs, ys, raw_model="emulated",
            e_query=e_query, e_patch=e_patch, prefill=prefill,
        )
    ls = f32(layer.scale)
    lo = f32(layer.offset)
    ones = jnp.ones_like(is2d)
    if n_layers == 1:
        patch = _patch33(lambda xg, yg: _cache_score(layer, xg, yg), xs, ys)
        dxl, dyl, mx = ast_subpixel2d(patch)
        x_out = xs.astype(f32) + dxl
        y_out = ys.astype(f32) + dyl
        score = mx
        size = jnp.full_like(x_out, K_BASIC_SIZE)
        accepted = is2d
        ismax_a = ismax_b = ones
        octave_idx = 0
    elif i == n_layers - 1:
        center = _cache_score(layer, xs, ys)
        below_mode = "below_octave" if i % 2 == 0 else "below_intra"
        ismax_b, _, _, _ = _score_patch_max(
            layers[i - 1], xs, ys, center, below_mode,
            drop=0 if v1 else K_DROP_THRESHOLD,
        )
        patch = _patch33(lambda xg, yg: _cache_score(layer, xg, yg), xs, ys)
        dxl, dyl, mx = ast_subpixel2d(patch)
        x_out = _fmul(xs.astype(f32) + dxl, ls) + lo
        y_out = _fmul(ys.astype(f32) + dyl, ls) + lo
        score = mx
        size = jnp.full_like(x_out, f32(K_BASIC_SIZE) * ls)
        accepted = is2d & ismax_b
        ismax_a = ones
        octave_idx = i
    else:
        ismax, score, x_out, y_out, scale_total, ismax_a, ismax_b = refine3d(
            layers, i, xs, ys, t58, v1=v1
        )
        size = f32(K_BASIC_SIZE) * scale_total
        accepted = is2d & ismax
        octave_idx = i
    return (
        is2d,
        accepted,
        (x_out, y_out, size, score, octave_idx),
        ismax_a,
        ismax_b,
    )


def _aux_maps(layers, cand, pass1):
    """Build (e_query, e_patch, prefill) per layer from a pass-1 estimate.

    pass1[i] = dict(is2d=, patch_touched=, above_ok=) per layer.
    e_patch: own-layer 3x3 patch touches (threshold 1) of earlier
    candidates whose Refine3D reached the patch gather. prefill: layer
    i-1's GetScoreMaxAbove probe taps on layer i — the full probe window
    when the scan completed (above_ok), only the first probe's 2x2 taps
    when it early-exited (the common failure is the very first probe
    exceeding the drop threshold).
    """
    inf = jnp.int32(2**31 - 1)
    n_layers = len(layers)
    aux = []
    for i, layer in enumerate(layers):
        h, w = layer.img.shape
        xs, ys, valid = cand[i]
        acc = jnp.zeros((h, w), bool).at[ys, xs].max(
            valid & pass1[i]["patch_touched"]
        )
        rm = (
            jnp.arange(h, dtype=jnp.int32)[:, None] * w
            + jnp.arange(w, dtype=jnp.int32)[None, :]
        )
        e_patch = jnp.full((h, w), inf)
        if i == n_layers - 1:
            # Last layer: the float-coord patch gather touches a 4x4
            # block, and the GetScoreMaxBelow threshold argument seeds
            # the own 2x2 after IsMax2D alone (see ast_exact
            # float_patch; brisk-scale-space.cc:227-241).
            # q is touched by candidate c at q - (dx, dy):
            # _shift_bool(m, dy, dx)[y, x] = m[y + dy, x + dx], so pass
            # the NEGATED offsets (the symmetric 3x3 set hid the sign).
            offs = [
                (dx, dy) for dy in (-1, 0, 1, 2) for dx in (-1, 0, 1, 2)
            ]
            for dx, dy in offs:
                a = _shift_bool(acc, -dy, -dx)
                r = _shift_i32(rm, -dy, -dx, fill=inf)
                e_patch = jnp.minimum(e_patch, jnp.where(a, r, inf))
            acc2 = jnp.zeros((h, w), bool).at[ys, xs].max(
                valid & pass1[i]["is2d"]
            )
            for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
                a = _shift_bool(acc2, -dy, -dx)
                r = _shift_i32(rm, -dy, -dx, fill=inf)
                e_patch = jnp.minimum(e_patch, jnp.where(a, r, inf))
        else:
            for dx, dy in _NEIGH8:
                a = _shift_bool(acc, dy, dx)
                r = _shift_i32(rm, dy, dx, fill=inf)
                e_patch = jnp.minimum(e_patch, jnp.where(a, r, inf))

        prefill = jnp.zeros((h, w), bool)
        if i >= 1:
            pxs, pys, pvalid = cand[i - 1]
            is2d_prev = pvalid & pass1[i - 1]["is2d"]
            above_ok = pass1[i - 1]["above_ok"]
            xf = pxs.astype(f32)
            yf = pys.astype(f32)
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
            # Early-exit: only the first probe's bilinear taps (2x2 at lo).
            hi_x_eff = jnp.where(above_ok, hi_x, lo_x + 1)
            hi_y_eff = jnp.where(above_ok, hi_y, lo_y + 1)
            for kx in range(3):
                for ky in range(3):
                    qx = jnp.clip(lo_x + kx, 0, w - 1)
                    qy = jnp.clip(lo_y + ky, 0, h - 1)
                    m = (
                        is2d_prev
                        & (lo_x + kx <= hi_x_eff)
                        & (lo_y + ky <= hi_y_eff)
                    )
                    prefill = prefill.at[qy, qx].max(m)
        aux.append((earliest_toucher_map(layer), e_patch, prefill))
    return aux


class AstDiagnostics(NamedTuple):
    """Device-side certificate that the per-layer candidate capacities
    did not truncate on THIS image (overflow silently drops corners —
    detect_ast_keypoints docs). Same contract as
    scale_space.DetectDiagnostics; assert ``ok`` when capacity tuning.
    """

    ok: jnp.ndarray             # () bool
    corner_counts: jnp.ndarray  # (L,) int32: AGAST corners per layer
    cand_caps: jnp.ndarray      # (L,) int32: static per-layer caps


def ast_capacity_diagnostics(
    img: jnp.ndarray,
    threshold: int,
    octaves: int,
    max_candidates_per_layer: "int | tuple",
    lower_threshold: int = 10,
    v1: bool = False,
) -> AstDiagnostics:
    """Pyramid-only capacity certificate (no detection tail): per-layer
    AGAST corner counts vs the candidate caps. Much cheaper to compile
    than detect_ast_keypoints(with_diagnostics=True); bench.py uses it
    to certify its caps on the bench frames before timing."""
    layers = build_ast_pyramid(
        img, octaves, threshold, lower=lower_threshold, v1=v1
    )
    n_layers = len(layers)
    caps = (
        max_candidates_per_layer
        if isinstance(max_candidates_per_layer, tuple)
        else (max_candidates_per_layer,) * n_layers
    )
    counts = jnp.stack(
        [jnp.sum(la.corner.astype(jnp.int32)) for la in layers]
    )
    caps_arr = jnp.asarray(caps[:n_layers], jnp.int32)
    # The dense engine (ast_dense) extracts corners with a per-2048-
    # block top-r (r = _EXTRACT_BLOCK_R = 256): no block may hold more
    # corners (a sufficient bound for its sharp exactness flag, which
    # detect-side diagnostics also carry).
    block_ok = jnp.bool_(True)
    for la in layers:
        cm = la.corner.reshape(-1).astype(jnp.int32)
        pad = (-cm.size) % 2048
        if pad:
            cm = jnp.pad(cm, (0, pad))
        block_ok &= (
            jnp.max(jnp.sum(cm.reshape(-1, 2048), axis=1)) <= 256
        )
    return AstDiagnostics(
        ok=jnp.all(counts <= caps_arr) & block_ok,
        corner_counts=counts,
        cand_caps=caps_arr,
    )


def detect_ast_keypoints(
    img: jnp.ndarray,
    threshold: int = 70,
    octaves: int = 3,
    max_candidates_per_layer: "int | tuple" = 2048,
    raw_cache_model: str = "emulated",
    suppress_scale_nonmaxima: bool = True,
    passed_keypoints: KeyPoints | None = None,
    lower_threshold: int = 10,
    v1: bool = False,
    with_diagnostics: bool = False,
) -> KeyPoints:
    """Dense BRISK-AST detection. Returns fixed-capacity KeyPoints.

    ``max_candidates_per_layer`` may be a per-layer tuple: per-
    candidate cost scales ~linearly with the slot total and corner
    counts fall steeply up the pyramid, so sized-down upper layers buy
    most of that without risking overflow (which silently truncates —
    keep >= 2-3x headroom over the expected per-layer corner counts).

    Two passes: pass 1 estimates per-layer decisions with query-only
    cache emulation; pass 2 re-runs with the patch/cross-layer cache-fill
    maps built from pass 1 (see is_max_2d).

    suppress_scale_nonmaxima=False mirrors the reference's non-suppressed
    mode (brisk-scale-space.cc:133-170): per-layer 2-D maxima with
    subpixel refinement only, no cross-layer checks. (The reference's loop
    indexes agastPoints.at(0) for every layer — an evident upstream bug we
    do not replicate; each layer processes its own candidates here.)

    ``passed_keypoints`` is the usePassedKeypoints mode
    (brisk-scale-space.cc:103-124): instead of detecting, every provided
    keypoint is mapped into every layer (x/scale - offset, float bounds
    check at 3..dim-3, then C float->int truncation), the 2-D maximum
    check is skipped (perform_2d_nonMax=false, :97/:139), and the normal
    refinement / 3-D suppression machinery runs on those candidates.
    """
    layers = build_ast_pyramid(
        img, octaves, threshold, lower=lower_threshold, v1=v1
    )
    n_layers = len(layers)
    t58 = agast5_8_score_map(layers[0].img) if n_layers > 1 else None

    cand = []
    diag = AstDiagnostics(
        ok=jnp.bool_(True),
        corner_counts=jnp.zeros((n_layers,), jnp.int32),
        cand_caps=jnp.zeros((n_layers,), jnp.int32),
    )
    if passed_keypoints is not None:
        for layer in layers:
            h, w = layer.img.shape
            lx = passed_keypoints.x / f32(layer.scale) - f32(layer.offset)
            ly = passed_keypoints.y / f32(layer.scale) - f32(layer.offset)
            ok = (
                passed_keypoints.valid
                & (lx >= 3) & (ly >= 3)
                & (lx <= w - 3) & (ly <= h - 3)
            )
            cand.append((_trunc_i32(lx), _trunc_i32(ly), ok))
    else:
        caps = (
            max_candidates_per_layer
            if isinstance(max_candidates_per_layer, tuple)
            else (max_candidates_per_layer,) * n_layers
        )
        assert len(caps) >= n_layers, (caps, n_layers)
        corner_counts = []
        for layer, cap in zip(layers, caps):
            ys, xs = jnp.nonzero(
                layer.corner, size=cap, fill_value=0
            )
            xs = xs.astype(jnp.int32)
            ys = ys.astype(jnp.int32)
            n_corners = jnp.sum(layer.corner.astype(jnp.int32))
            corner_counts.append(n_corners)
            valid = jnp.arange(cap) < n_corners
            cand.append((xs, ys, valid))
        counts = jnp.stack(corner_counts)
        caps_arr = jnp.asarray(caps[:n_layers], jnp.int32)
        diag = AstDiagnostics(
            ok=jnp.all(counts <= caps_arr),
            corner_counts=counts,
            cand_caps=caps_arr,
        )

    if not suppress_scale_nonmaxima:
        per_layer = []
        for i in range(n_layers):
            layer = layers[i]
            xs, ys, valid = cand[i]
            if passed_keypoints is not None:
                is2d = jnp.ones_like(valid)  # perform_2d_nonMax=false
            else:
                is2d = is_max_2d(layer, xs, ys, raw_model="emulated")
            patch = _patch33(
                lambda xg, yg, la=layer: _cache_score(la, xg, yg), xs, ys
            )
            dxl, dyl, mx = ast_subpixel2d(patch)
            ls = f32(layer.scale)
            lo = f32(layer.offset)
            # Non-suppressed mode emits layer-local coords + scaled size
            # (brisk-scale-space.cc:154-166: x = point + delta, no
            # scale/offset mapping; size = kBasicSize * layer.scale).
            per_layer.append(
                KeyPoints(
                    x=xs.astype(f32) + dxl,
                    y=ys.astype(f32) + dyl,
                    size=jnp.full_like(dxl, f32(K_BASIC_SIZE) * ls),
                    angle=jnp.full_like(dxl, -1.0),
                    response=mx.astype(f32),
                    octave=jnp.zeros(dxl.shape, jnp.int32),
                    valid=valid & is2d,
                )
            )
        kps = KeyPoints.concatenate(per_layer)
        return (kps, diag) if with_diagnostics else kps

    aux = [(None, None, None)] * n_layers
    exact_is2d: list = [None] * n_layers
    if passed_keypoints is not None:
        # usePassedKeypoints: IsMax2D skipped entirely; no cache-order
        # machinery needed (the passed-mode score writes are plain cache
        # warms, and the dense score maps already model them).
        for i in range(n_layers):
            exact_is2d[i] = jnp.ones_like(cand[i][2])
        raw_cache_model = "exact"  # reuse the is2d_override plumbing
    elif raw_cache_model == "emulated":
        pass1 = []
        for i in range(n_layers):
            xs, ys, valid = cand[i]
            is2d, _, _, ismax_a, ismax_b = _process_layer(
                layers, i, xs, ys, t58, None, None, None, v1=v1
            )
            pass1.append(
                dict(
                    is2d=is2d,
                    patch_touched=is2d & ismax_a & ismax_b,
                    above_ok=ismax_a,
                )
            )
        aux = _aux_maps(layers, cand, pass1)
    elif raw_cache_model == "exact":
        # Sequential-exact cache emulation (ast_exact.py): per layer,
        # exact IsMax2D via a candidate-order fori_loop over the stored
        # map, with exact above-scan prefill stamps feeding the next
        # layer. 3D gates (order-independent) feed the same-layer 3x3
        # write condition.
        from ethzasl_brisk_jax.detect.ast_exact import (
            above_scan_stamps,
            exact_is2d_layer,
            scatter_stamps,
        )

        prefill = jnp.zeros(layers[0].img.shape, bool)
        drop = 0 if v1 else K_DROP_THRESHOLD
        for i in range(n_layers):
            xs, ys, valid = cand[i]
            center = layers[i].cache[ys, xs]
            ones = jnp.ones_like(valid)
            if n_layers == 1:
                gate = ones
            elif i == n_layers - 1:
                mode_b = "below_octave" if i % 2 == 0 else "below_intra"
                gate, _, _, _ = _score_patch_max(
                    layers[i - 1], xs, ys, center, mode_b, drop=drop
                )
            else:
                mode_a = "above_octave" if i % 2 == 0 else "above_intra"
                ga, _, _, _ = _score_patch_max(
                    layers[i + 1], xs, ys, center, mode_a, drop=drop
                )
                if i == 0:
                    gb = ones  # layer-0 below-guess (5_8) never rejects
                else:
                    mode_b = (
                        "below_octave" if i % 2 == 0 else "below_intra"
                    )
                    gb, _, _, _ = _score_patch_max(
                        layers[i - 1], xs, ys, center, mode_b, drop=drop
                    )
                gate = ga & gb
            is2d = exact_is2d_layer(
                layers[i], xs, ys, valid, gate, prefill,
                # Last/single layer: float-coord GetAgastScore calls
                # widen the threshold-1 write footprint (see ast_exact).
                float_patch=(i == n_layers - 1),
            )
            exact_is2d[i] = is2d
            if i + 1 < n_layers:
                mode_a = "above_octave" if i % 2 == 0 else "above_intra"
                ax_, ay_, stamp = above_scan_stamps(
                    layers[i + 1], xs, ys, center, mode_a, drop=drop
                )
                prefill = scatter_stamps(
                    layers[i + 1], ax_, ay_, stamp, valid & is2d
                )

    per_layer = []
    for i in range(n_layers):
        xs, ys, valid = cand[i]
        e_q, e_p, pre = aux[i]
        if raw_cache_model == "exact":
            _, accepted, fields, _, _ = _process_layer(
                layers, i, xs, ys, t58, None, None, None,
                is2d_override=exact_is2d[i], v1=v1,
            )
        elif raw_cache_model != "emulated":
            is2d = is_max_2d(layers[i], xs, ys, raw_model=raw_cache_model)
            _, accepted, fields, _, _ = _process_layer(
                layers, i, xs, ys, t58, None, None, None, v1=v1
            )
            accepted &= is2d
        else:
            _, accepted, fields, _, _ = _process_layer(
                layers, i, xs, ys, t58, e_q, e_p, pre, v1=v1
            )
        x_out, y_out, size, score, octave_idx = fields
        per_layer.append(
            KeyPoints(
                x=x_out,
                y=y_out,
                size=size,
                angle=jnp.full_like(x_out, -1.0),
                response=score.astype(f32),
                octave=jnp.full(x_out.shape, octave_idx, jnp.int32),
                valid=valid & accepted,
            )
        )

    kps = KeyPoints.concatenate(per_layer)
    return (kps, diag) if with_diagnostics else kps
