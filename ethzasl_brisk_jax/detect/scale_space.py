"""BRISK v2 generic scale-space detection (Harris path), dense and batched.

Mirrors ``ScaleSpaceFeatureDetector<SCORE_CALCULATOR_T>`` +
``ScaleSpaceLayer`` (``brisk/include/brisk/scale-space-feature-detector.h:62-136``,
``internal/scale-space-layer-inl.h:60-428``) with a dense, statically-shaped
design:

* pyramid: layer 0 = input; layer 1 = two-thirds sample; layer i>=2 =
  half-sample of layer i-2 (scale-space-layer-inl.h:107-136);
* dense score maps per layer (Harris int path by default);
* 2-D maxima: dense 3x3 max-pool comparison (== Get2dMaxima);
* 3-D suppression: the reference evaluates the neighbor layers' score maps
  with bilinear interpolation at affine-mapped coordinates
  (ScoreAbove/ScoreBelow, scale-space-layer-inl.h:431-442). The affine maps
  are exact rationals (e.g. u = (4x-1)/6 for octave -> intra), so we compare
  ``center * D^2`` against integer-weighted bilinear sums in int64 — exact,
  no floating-point warp. The reference's truncated offsets
  (``const int one_over_scale_above = 1.0/_scale_above`` == 1, ``..._below``
  == 0, scale-space-layer-inl.h:225-226) make the above-check a 3x3
  neighborhood max of the warped map and the below-check a single sample;
* top-k candidate extraction (score-descending == the reference's sort);
* greedy uniformity enforcement / bucketing (see uniformity.py);
* sub-pixel quadratic refinement and coordinate un-mapping
  ``x = scale*((x+dx)+offset)`` (scale-space-layer-inl.h:394-412).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.detect.subpixel import subpixel2d
from ethzasl_brisk_jax.detect.uniformity import (
    bucket_keypoints,
    enforce_uniformity,
)
from ethzasl_brisk_jax.kernels.downsample import (
    halfsample8,
    halfsample16,
    twothirdsample8,
    twothirdsample16,
)
from ethzasl_brisk_jax.kernels.harris import (
    harris_score_f32,
    harris_score_i32,
)
from ethzasl_brisk_jax.kernels.nms import maxima2d_mask

INT32_MIN = -(2**31)


@dataclasses.dataclass(frozen=True)
class LayerGeometry:
    """Static geometry of one pyramid layer."""

    index: int
    is_octave: bool
    scale: float
    offset: float

    # Exact-rational affine map u -> (A*u + B) / D into the neighbor layer
    # (see module docstring). Derived from _scale_above/_offset_above and
    # _scale_below/_offset_below (scale-space-layer-inl.h:143-156).
    @property
    def above_map(self) -> tuple[int, int, int]:
        return (4, -1, 6) if self.is_octave else (6, -1, 8)

    @property
    def below_map(self) -> tuple[int, int, int]:
        return (12, 2, 9) if self.is_octave else (24, 3, 16)


def layer_geometry(index: int) -> LayerGeometry:
    is_octave = index % 2 == 0
    scale = float(2 ** (index // 2)) * (1.0 if is_octave else 1.5)
    return LayerGeometry(
        index=index,
        is_octave=is_octave,
        scale=scale,
        offset=scale * 0.5 - 0.5,
    )


def build_pyramid(img: jnp.ndarray, n_layers: int) -> list[jnp.ndarray]:
    """Layer images: [img, 2/3(img), 1/2(img), 1/2(layer1), ...].

    Dispatches on dtype like the reference's ScaleSpaceLayer::Halfsample
    / Twothirdsample (scale-space-layer-inl.h:445-470): uint8 and uint16
    pipelines share the geometry, each with its own SIMD-exact sampler.
    """
    if img.dtype == jnp.uint16:
        half, twothirds = halfsample16, twothirdsample16
    else:
        half, twothirds = halfsample8, twothirdsample8
    layers = [img]
    if n_layers > 1:
        layers.append(twothirds(img))
    for i in range(2, n_layers):
        layers.append(half(layers[i - 2]))
    return layers


def _trunc_div(val: jnp.ndarray, d: int) -> jnp.ndarray:
    """C-style truncating integer division by positive d."""
    return jnp.where(val >= 0, val // d, -((-val) // d))


def _axis_terms_np(n: int, limit: int, a: int, b: int, d: int):
    """Static (numpy) warp axis terms: UNCLIPPED C-truncated indices,
    fraction numerators and validity — exact integer math, so identical
    to the traced _trunc_div chain on any backend."""
    import numpy as _np

    val = a * _np.arange(n, dtype=_np.int64) + b
    i0 = _np.where(val >= 0, val // d, -((-val) // d)).astype(_np.int64)
    frac = (val - i0 * d).astype(_np.int32)
    ok = (i0 + 1 < limit) & (i0 >= 0)
    return i0, frac, ok


def _periodic_take(x: jnp.ndarray, idx, axis: int) -> jnp.ndarray:
    """``jnp.take(x, idx, axis)`` for a STATIC periodic index staircase,
    built from zero-padding + strided slices + an interleave instead of
    a gather (the warp staircases trunc((a*x+b)/d) are periodic with
    period d/gcd(a, d)). Out-of-range indices read the zero
    padding; callers mask those outputs anyway (the previous clip-gather
    read border values there — also masked). Falls back to a clipped
    gather when no small period fits.
    """
    import numpy as _np

    idx = _np.asarray(idx, _np.int64)
    n = idx.size
    size = x.shape[axis]
    p = None
    for cand in (1, 2, 3, 4, 6, 8):
        if cand < n and _np.all(
            idx[cand:] - idx[:-cand] == idx[cand] - idx[0]
        ):
            p, q = cand, int(idx[cand] - idx[0])
            break
    if p is None or q <= 0:
        cl = _np.clip(idx, 0, size - 1)
        return jnp.take(x, jnp.asarray(cl, _np.int32), axis=axis)

    t = -(-n // p)  # ceil
    starts = [int(idx[r]) for r in range(p)]
    pad_lo = max(0, -min(starts))
    pad_hi = max(
        0, max(s + q * (t - 1) for s in starts) + 1 - size
    )
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (pad_lo, pad_hi)
    xp = jnp.pad(x, pad_width) if (pad_lo or pad_hi) else x
    parts = []
    for r in range(p):
        s = starts[r] + pad_lo
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(s, s + q * t, q)
        parts.append(xp[tuple(sl)])
    stacked = jnp.stack(parts, axis=axis + 1)  # (..., t, p, ...)
    new_shape = list(x.shape)
    new_shape[axis] = t * p
    out = stacked.reshape(new_shape)
    sl = [slice(None)] * x.ndim
    sl[axis] = slice(0, n)
    return out[tuple(sl)]


def warp_scores_split(
    src_scores: jnp.ndarray,
    affine: tuple[int, int, int],
    dst_shape: tuple[int, int],
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """D^2-scaled bilinear sample of a neighbor layer's score map.

    Exact integer result W = D^2 * Score(u, v) with u = (A*x+B)/D,
    v = (A*y+B)/D, returned as an int32 split pair ``(w_hi, w_lo)`` with
    W = w_hi * 2^15 + w_lo — W itself can exceed int32 range and the
    pipeline runs without x64, so the 15-bit split keeps every partial
    product well inside int32. (0, 0) where the reference's bilinear returns 0
    (harris-score-calculator.h:57-74: u_int truncated toward zero, zero if
    u_int+1 >= cols or v_int+1 >= rows or u_int < 0 or v_int < 0; note u in
    (-1, 0) truncates to 0 and extrapolates with a negative weight — kept).
    """
    a, b, d = affine
    rows, cols = src_scores.shape
    h, w = dst_shape

    # Static exact-integer staircases (identical values to the traced
    # _trunc_div chain); the takes become strided-slice interleaves.
    u0, fu_np, oku_np = _axis_terms_np(w, cols, a, b, d)
    v0, fv_np, okv_np = _axis_terms_np(h, rows, a, b, d)
    fu = jnp.asarray(fu_np)
    fv = jnp.asarray(fv_np)

    s = src_scores.astype(jnp.int32)
    s_hi = s >> 15          # arithmetic shift: floor split, sign in hi
    s_lo = s & 0x7FFF       # in [0, 2^15)

    def bilerp(part):
        # Axis-separable resample via static periodic slices (out-of-
        # range taps read 0-padding; those outputs are masked below —
        # the previous clip-gather read border values there, equally
        # masked).
        rows0 = _periodic_take(part, v0, axis=0)
        rows1 = _periodic_take(part, v0 + 1, axis=0)
        p00 = _periodic_take(rows0, u0, axis=1)
        p01 = _periodic_take(rows0, u0 + 1, axis=1)
        p10 = _periodic_take(rows1, u0, axis=1)
        p11 = _periodic_take(rows1, u0 + 1, axis=1)
        fu_ = fu[None, :]
        fv_ = fv[:, None]
        return (d - fv_) * ((d - fu_) * p00 + fu_ * p01) + fv_ * (
            (d - fu_) * p10 + fu_ * p11
        )

    w_hi = bilerp(s_hi)
    w_lo = bilerp(s_lo)
    valid = jnp.asarray(okv_np)[:, None] & jnp.asarray(oku_np)[None, :]
    return jnp.where(valid, w_hi, 0), jnp.where(valid, w_lo, 0)


def warp_scores_f32(
    src_scores: jnp.ndarray,
    affine: tuple[int, int, int],
    dst_shape: tuple[int, int],
) -> jnp.ndarray:
    """Float bilinear warp of a neighbor layer's float score map.

    The float-score pipeline analog of warp_scores_split
    (HarrisScoreCalculatorFloat::Score semantics,
    harris-score-calculator-float.h:57-74: truncated u_int, zero outside
    bounds). Coordinates come from the same exact rationals; fractions
    are evaluated in float32.
    """
    a, b, d = affine
    rows, cols = src_scores.shape
    h, w = dst_shape

    u0, fu_np, oku_np = _axis_terms_np(w, cols, a, b, d)
    v0, fv_np, okv_np = _axis_terms_np(h, rows, a, b, d)
    fu = jnp.asarray(fu_np.astype("float32") / float(d))
    fv = jnp.asarray(fv_np.astype("float32") / float(d))
    s = src_scores
    rows0 = _periodic_take(s, v0, axis=0)
    rows1 = _periodic_take(s, v0 + 1, axis=0)
    p00 = _periodic_take(rows0, u0, axis=1)
    p01 = _periodic_take(rows0, u0 + 1, axis=1)
    p10 = _periodic_take(rows1, u0, axis=1)
    p11 = _periodic_take(rows1, u0 + 1, axis=1)
    fu_ = fu[None, :]
    fv_ = fv[:, None]
    out = (1.0 - fv_) * ((1.0 - fu_) * p00 + fu_ * p01) + fv_ * (
        (1.0 - fu_) * p10 + fu_ * p11
    )
    valid = jnp.asarray(okv_np)[:, None] & jnp.asarray(oku_np)[None, :]
    return jnp.where(valid, out, 0.0)


def center_ge_warped(
    center: jnp.ndarray,
    w_hi: jnp.ndarray,
    w_lo: jnp.ndarray,
    d: int,
) -> jnp.ndarray:
    """Exact int32 test ``center * d^2 >= w_hi * 2^15 + w_lo``.

    |w_hi| <= 4*d^2*|s|/2^15 and |w_lo| <= 4*d^2*2^15 both fit int32 for
    d <= 16 and Harris |s| < 2^30; the cross term is handled by cutting the
    hi-difference at +-2048 (2048 * 2^15 dominates any possible lo part).
    """
    d2 = d * d
    c_hi = center >> 15
    c_lo = center & 0x7FFF
    diff = c_hi * d2 - w_hi
    rhs = w_lo - c_lo * d2
    return jnp.where(
        diff >= 2048,
        True,
        jnp.where(
            diff <= -2048,
            False,
            jnp.clip(diff, -2048, 2048) * 32768 >= rhs,
        ),
    )


def _max3x3_pair(
    w_hi: jnp.ndarray, w_lo: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Separable 3x3 maximum of the split warp pair (0-filled borders).

    The warp pair as produced by warp_scores_split is NOT canonical:
    w_lo = bilerp(s_lo) ranges over (-d^2*2^15, d^2*2^15) (border
    extrapolation has negative weights), so comparing (w_hi, w_lo)
    lexicographically misorders W = w_hi*2^15 + w_lo (this exact bug
    shifted the bench detection set while every CPU test passed —
    2026-08-20). Canonicalizing first — carry = w_lo >> 15 (arithmetic
    = floor), hi += carry, lo &= 0x7FFF — makes the pair the true
    floor/remainder of W, whose lex order IS numeric order; the carry
    keeps hi well inside int32 (|W| <= 4*d^2*2^30 -> |hi| <= d^2*2^17).
    Then the pairwise max encodes max(W) without materializing W, which
    collapses the 9 shifted above-layer compares into ONE: AND over
    dy,dx of (center >= W(x+dx, y+dy)) == center >= max3x3(W), with
    the same 0-fill at the borders as the shifted compares
    (out-of-image probes read 0). About 2x fewer full-map passes.
    """
    carry = w_lo >> 15
    w_hi = w_hi + carry
    w_lo = w_lo & 0x7FFF

    def pmax(h1, l1, h2, l2):
        take1 = (h1 > h2) | ((h1 == h2) & (l1 >= l2))
        return jnp.where(take1, h1, h2), jnp.where(take1, l1, l2)

    for axis in (1, 0):
        dy0, dx0 = (0, 1) if axis == 1 else (1, 0)
        hm, lm = pmax(
            w_hi, w_lo,
            _shift2d(w_hi, -dy0, -dx0, 0), _shift2d(w_lo, -dy0, -dx0, 0),
        )
        w_hi, w_lo = pmax(
            hm, lm,
            _shift2d(w_hi, dy0, dx0, 0), _shift2d(w_lo, dy0, dx0, 0),
        )
    return w_hi, w_lo


def _max3x3_f32(wf: jnp.ndarray) -> jnp.ndarray:
    """Separable 3x3 maximum with 0-filled borders (float warp path)."""
    for dy0, dx0 in ((0, 1), (1, 0)):
        wf = jnp.maximum(
            jnp.maximum(wf, _shift2d(wf, -dy0, -dx0, 0.0)),
            _shift2d(wf, dy0, dx0, 0.0),
        )
    return wf


def _shift2d(x: jnp.ndarray, dy: int, dx: int, fill) -> jnp.ndarray:
    """out[y, x] = x[y+dy, x+dx], `fill` outside."""
    h, w = x.shape
    out = jnp.full_like(x, fill)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    """Mirrors ScaleSpaceFeatureDetector ctor args
    (scale-space-feature-detector.h:69-77)."""

    octaves: int = 0
    uniformity_radius: float = 30.0
    absolute_threshold: float = 0.0
    max_num_kpt: int = 2**31 - 1
    # Static capacity knobs. max_candidates may be a per-layer tuple:
    # per-candidate cost (uniformity, refine, top_k's k) scales with the
    # slot total and maxima counts fall up the pyramid. Overflow silently keeps only the top-k by score — keep
    # headroom.
    max_candidates: "int | tuple" = 4096   # per-layer top-k capacity
    max_keypoints: int = 4096    # output capacity (all layers combined)
    # The reference refines in double (Subpixel2D takes doubles,
    # scale-space-layer-inl.h:560). float32 is the default;
    # parity tests on CPU select float64 (requires jax_enable_x64).
    refine_dtype: str = "float32"
    # Candidate extraction: "sort" = lax.top_k over the full H*W map;
    # "select" = bisection threshold + prefix-compaction + k-element
    # sort (kernels/topk.py) — bit-identical, avoids the full-map sort
    # but is launch-latency-bound (31 sequential reduction steps);
    # "compact" = mask-count compaction + k-element lexsort — no
    # sequential loop at all, bit-identical to "sort" whenever the
    # layer's maxima count fits max_candidates (the configured-capacity
    # regime; see kernels/topk.topk_from_mask for overflow semantics);
    # "block" = two-stage per-block top-r then global top-k over the
    # survivors (kernels/topk.topk_block) — identical result incl. tie
    # order whenever no 2048-element block holds more than topk_block_r
    # candidates at/above the k-th value (exactness is
    # device-verifiable via the kernel's flag, asserted in bench.py and
    # tests; parity configs keep "sort").
    topk_impl: str = "sort"
    topk_block_size: int = 2048
    topk_block_r: int = 256
    # Static per-layer budget for the subpixel-refine tail (None =
    # min(max_num_kpt, k), the exact default). The refine patch gather
    # costs per SLOT, but only the uniformity-accepted prefix is ever
    # valid. A
    # tuple sized with 2-3x headroom over the accepted counts buys the
    # gather reduction; overflow silently drops the lowest-priority
    # accepted candidates (same capacity class as max_candidates;
    # bench.py certifies the accepted counts fit on its frames).
    refine_capacity: "int | tuple | None" = None
    # Uniformity interaction block size: the greedy pass serializes over
    # ceil(max_candidates / block) blocks; larger blocks shorten the
    # sequential chain at quadratic (B, B) pair-matrix cost.
    uniformity_block: int = 256

    @property
    def n_layers(self) -> int:
        return max(self.octaves * 2, 1)

    def layer_cap(self, i: int) -> int:
        """Per-layer candidate capacity (max_candidates[i] or scalar)."""
        mc = self.max_candidates
        return mc[i] if isinstance(mc, tuple) else mc

    def refine_cap(self, i: int) -> "int | None":
        """Per-layer refine-tail capacity (refine_capacity[i]/scalar)."""
        rc = self.refine_capacity
        if rc is None:
            return None
        return rc[i] if isinstance(rc, tuple) else rc


def layer_score_masks(
    img: jnp.ndarray,
    config: DetectorConfig,
    score_fn: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
) -> tuple[list[jnp.ndarray], list[jnp.ndarray]]:
    """Per-layer (scores, candidate masks) for one image.

    The first half of :func:`detect_keypoints`: pyramid, per-layer
    corner scores, and the 2d/3d-maxima + threshold candidate masks
    (warp compares against the neighbour layers). Split out so probes
    and alternative candidate-extraction backends can consume the real
    masks without running the full detection tail.
    """
    if score_fn is None:
        score_fn = (
            harris_score_f32 if img.dtype == jnp.uint16 else harris_score_i32
        )
    n_layers = config.n_layers
    pyramid = build_pyramid(img, n_layers)
    geoms = [layer_geometry(i) for i in range(n_layers)]
    scores = [score_fn(im) for im in pyramid]
    is_float = jnp.issubdtype(scores[0].dtype, jnp.floating)
    abs_thr = (
        float(config.absolute_threshold)
        if is_float
        else int(config.absolute_threshold)
    )

    masks: list[jnp.ndarray] = []
    for i in range(n_layers):
        sc = scores[i]
        h, w = sc.shape
        mask = maxima2d_mask(sc, abs_thr)

        if i + 1 < n_layers:
            # Check above: the truncated one_over_scale_above == 1
            # (scale-space-layer-inl.h:225), so the reference probes the
            # above layer at all 9 of (x+-1, y+-1) — 9 shifted compares
            # against the warped split maps (out-of-image probes read 0).
            a, b, d = geoms[i].above_map
            if is_float:
                wf = warp_scores_f32(scores[i + 1], (a, b, d), (h, w))
                mask &= sc >= _max3x3_f32(wf)
            else:
                w_hi, w_lo = warp_scores_split(
                    scores[i + 1], (a, b, d), (h, w)
                )
                # One compare vs the 3x3 max of the pair-encoded warp
                # (exactly the AND of the 9 shifted compares —
                # _max3x3_pair docs).
                mh, ml = _max3x3_pair(w_hi, w_lo)
                mask &= center_ge_warped(sc, mh, ml, d)
        if i > 0:
            # Check below: one_over_scale_below truncates to 0, so all 9
            # probes collapse to the single center sample.
            a, b, d = geoms[i].below_map
            if is_float:
                mask &= sc >= warp_scores_f32(
                    scores[i - 1], (a, b, d), (h, w)
                )
            else:
                w_hi, w_lo = warp_scores_split(
                    scores[i - 1], (a, b, d), (h, w)
                )
                mask &= center_ge_warped(sc, w_hi, w_lo, d)

        masks.append(mask)

    return scores, masks


class DetectDiagnostics(NamedTuple):
    """Device-side exactness certificate for the capacity-classed
    detection backends (all cheap by-products of the normal pass).

    The reference never silently drops candidates — its sort keeps all
    (score-calculator.h:66-85); this pipeline's static capacities
    (max_candidates, refine_capacity) and the two-stage block top-k are
    exact only when the data fits, so `ok` certifies THIS input. Request
    via ``detect_keypoints(..., with_diagnostics=True)`` and assert
    ``ok`` (bench.py, tools/kitti_eval.py, examples/live_pipeline.py do).
    """

    ok: jnp.ndarray              # () bool — everything below holds
    cand_counts: jnp.ndarray     # (L,) int32: 2d/3d maxima per layer
    cand_caps: jnp.ndarray       # (L,) int32: static per-layer caps
    topk_exact: jnp.ndarray      # (L,) bool: block top-k sharp flag
    accepted_counts: jnp.ndarray  # (L,) int32: uniformity-accepted
    refine_caps: jnp.ndarray     # (L,) int32 (INT32_MAX = uncapped)


def detect_keypoints(
    img: jnp.ndarray,
    config: DetectorConfig,
    score_fn: Callable[[jnp.ndarray], jnp.ndarray] | None = None,
    with_diagnostics: bool = False,
) -> "KeyPoints | tuple[KeyPoints, DetectDiagnostics]":
    """Full scale-space detection on one uint8/uint16 image.

    uint8 uses the integer Harris path (bit-exact vs the reference's
    HarrisScoresSSE); uint16 uses the float Harris path like the
    reference's 16-bit pipeline (HarrisScoreCalculatorFloat accepts
    CV_16U, harris-score-calculator-float.cc:115). Jit-compatible.

    ``with_diagnostics=True`` additionally returns a
    :class:`DetectDiagnostics` certifying that no capacity knob
    truncated on THIS image (~zero extra cost: every count is a sum of
    a mask the pass already computes).
    """
    n_layers = config.n_layers
    scores, masks = layer_score_masks(img, config, score_fn)
    geoms = [layer_geometry(i) for i in range(n_layers)]
    per_layer: list[KeyPoints] = []

    # Candidate extraction + uniformity per layer. (A single
    # layer-batched vmapped uniformity call measured NO faster: the
    # batched while_loop convoys on the max trip count across lanes,
    # eating the 4x step reduction.)
    cands = []
    for i in range(n_layers):
        cands.append(
            _layer_candidates(
                scores[i], masks[i], config, config.layer_cap(i)
            )
        )
    accepts = [
        _layer_accept(cands[i], scores[i].shape, config)
        for i in range(n_layers)
    ]

    diag = None
    if with_diagnostics:
        # Candidate-cap overflow is BENIGN (provably value-neutral) when
        # uniformity is off and the cap covers the output budget: the
        # 1x1-bucket accept keeps only the first min(max_num_kpt, k)
        # valid candidates in score order, and the final cross-layer
        # response top-k needs at most max_keypoints per layer — both
        # prefixes of the score-sorted list, unchanged by any cap >=
        # the budget. (With uniformity ON, greedy suppression consumes
        # weaker candidates, so overflow is a real truncation.)
        eff_kpt = min(config.max_num_kpt, config.max_keypoints)
        caps = jnp.asarray(
            [
                (2**31 - 1)
                if (
                    config.uniformity_radius == 0.0
                    and config.layer_cap(i) >= eff_kpt
                )
                else min(config.layer_cap(i), scores[i].size)
                for i in range(n_layers)
            ],
            jnp.int32,
        )
        counts = jnp.stack(
            [jnp.sum(masks[i].astype(jnp.int32)) for i in range(n_layers)]
        )
        exact = jnp.stack([cands[i][4] for i in range(n_layers)])
        acc_counts = jnp.stack(
            [jnp.sum(accepts[i].astype(jnp.int32))
             for i in range(n_layers)]
        )
        rcaps = jnp.asarray(
            [
                (2**31 - 1) if config.refine_cap(i) is None
                else config.refine_cap(i)
                for i in range(n_layers)
            ],
            jnp.int32,
        )
        diag = DetectDiagnostics(
            ok=(
                jnp.all(counts <= caps)
                & jnp.all(exact)
                & jnp.all(acc_counts <= rcaps)
            ),
            cand_counts=counts,
            cand_caps=caps,
            topk_exact=exact,
            accepted_counts=acc_counts,
            refine_caps=rcaps,
        )

    compacted = [
        compact_accepted(
            *cands[i][:4], accepts[i], config, cap=config.refine_cap(i)
        )
        for i in range(n_layers)
    ]
    if n_layers > 1 and len({t[0].shape[0] for t in compacted}) == 1:
        kps = _refine_keypoints_fused(scores, compacted, geoms, config)
        return (kps, diag) if with_diagnostics else kps

    for i in range(n_layers):
        xs, ys, top_scores, valid, accept = compacted[i]
        kps = _refine_layer_keypoints(
            scores[i], xs, ys, top_scores, valid, accept, geoms[i],
            config,
        )
        per_layer.append(kps)

    kps = KeyPoints.concatenate(per_layer)
    return (kps, diag) if with_diagnostics else kps


def compact_accepted(xs, ys, top_scores, valid, accept, config, *extra,
                     cap=None):
    """Compact accepted candidates to a min(max_num_kpt, k) prefix.

    Uniformity/bucketing accepts at most min(max_num_kpt, k) candidates;
    the stable partition preserves the score-descending order, and the
    subpixel refinement then touches ONLY that prefix instead of all k
    candidates. Order among valid entries is
    unchanged, so the downstream concatenate + response top_k resolves
    ties identically to the uncompacted layout (verified bitwise). The
    tile-sharded path applies the same compaction so its output packing
    stays bitwise-equal to the dense path.
    """
    cap = min(
        xs.shape[0], config.max_num_kpt,
        xs.shape[0] if cap is None else cap,
    )
    if cap < xs.shape[0]:
        from ethzasl_brisk_jax.core.keypoints import take_packed

        order = jnp.argsort(~accept, stable=True)[:cap]
        # One packed gather for every 1-D column; multi-dim extras keep
        # their own take.
        flat = [xs, ys, top_scores, valid, accept] + [
            e for e in extra if e.ndim == 1
        ]
        taken = list(take_packed(flat, order))
        xs, ys, top_scores, valid, accept = taken[:5]
        rest = taken[5:]
        extra = tuple(
            rest.pop(0) if e.ndim == 1
            else jnp.take(e, order, axis=0)
            for e in extra
        )
    return (xs, ys, top_scores, valid, accept) + extra


def _layer_candidates(sc, mask, config, cap=None):
    """Score-descending candidate list: (xs, ys, scores, valid, exact).

    ``exact`` is a device scalar bool: True when this extraction is
    bitwise-identical to the full-map sort (always, except the "block"
    backend on data where some 2048-block overflows topk_block_r at or
    above the k-th value — the sharp topk_block flag). Consumed by
    detect_keypoints(with_diagnostics=True); callers that index [:4]
    are unaffected.
    """
    h, w = sc.shape
    k = min(
        config.max_candidates if cap is None else cap, h * w
    )
    sentinel = (
        -jnp.inf if jnp.issubdtype(sc.dtype, jnp.floating) else INT32_MIN
    )
    # topk_impl="select" replaces the full-map sort with bisection
    # threshold + prefix compaction (kernels/topk.py, bit-identical).
    masked = jnp.where(mask, sc, sentinel)
    is_int = not jnp.issubdtype(sc.dtype, jnp.floating)
    exact = jnp.bool_(True)
    if config.topk_impl == "block" and is_int:
        from ethzasl_brisk_jax.kernels.topk import topk_block

        top_scores, top_idx, exact = topk_block(
            masked.reshape(-1), k,
            block=config.topk_block_size, r=config.topk_block_r,
        )
    elif config.topk_impl == "select" and is_int:
        from ethzasl_brisk_jax.kernels.topk import topk_int32

        top_scores, top_idx = topk_int32(masked.reshape(-1), k)
    elif config.topk_impl == "compact" and is_int:
        from ethzasl_brisk_jax.kernels.topk import topk_from_mask

        top_scores, top_idx = topk_from_mask(
            sc.reshape(-1), mask.reshape(-1), k
        )
    else:
        top_scores, top_idx = jax.lax.top_k(masked.reshape(-1), k)
    ys = top_idx // w
    xs = top_idx % w
    valid = jnp.take(mask.reshape(-1), top_idx)
    return xs, ys, top_scores, valid, exact


def _layer_accept(cand, shape, config):
    xs, ys, top_scores, valid = cand[:4]
    h, w = shape
    k = xs.shape[0]
    if config.uniformity_radius > 0.0:
        return enforce_uniformity(
            xs, ys, top_scores, valid, rows=h, cols=w,
            radius=float(config.uniformity_radius),
            max_num_kpt=min(config.max_num_kpt, k),
            block=config.uniformity_block,
        )
    return bucket_keypoints(
        xs, ys, valid, rows=h, cols=w,
        max_num_kpt=min(config.max_num_kpt, k),
        num_buckets_u=1, num_buckets_v=1,
    )


def _refine_keypoints_fused(
    scores, compacted, geoms, config: DetectorConfig
) -> KeyPoints:
    """Cross-layer fused subpixel-refine + packing tail.

    The per-layer tail (9 patch takes + subpixel + KeyPoints packing,
    repeated for each layer) is dozens of small kernels over (B, 1024)
    arrays. After compact_accepted every layer shares the same capacity
    C, so the candidates stack to (L, C) and the whole tail runs ONCE
    against a single concatenated flat score map (9 takes total), with
    per-layer scale/offset/size/octave broadcast from (L,) constants.
    Output ordering (layer-major) and every float chain match the
    per-layer path; the same optimization_barrier fences pin the FMA
    contraction (see refine_from_patches).
    """
    import numpy as _np

    n_layers = len(scores)
    c = compacted[0][0].shape[0]
    xs = jnp.stack([t[0] for t in compacted])        # (L, C)
    ys = jnp.stack([t[1] for t in compacted])
    tsc = jnp.stack([t[2] for t in compacted])
    accept = jnp.stack([t[4] for t in compacted])
    flat_all = jnp.concatenate([s.reshape(-1) for s in scores])
    h_l = jnp.asarray([[s.shape[0]] for s in scores], jnp.int32)
    w_l = jnp.asarray([[s.shape[1]] for s in scores], jnp.int32)
    off_l = jnp.asarray(
        _np.cumsum([0] + [s.size for s in scores[:-1]]), jnp.int32
    )[:, None]

    rows = []
    for dy in (-1, 0, 1):
        taps = []
        for dx in (-1, 0, 1):
            yy = jnp.clip(ys + dy, 0, h_l - 1)
            xx = jnp.clip(xs + dx, 0, w_l - 1)
            taps.append(
                jnp.take(flat_all, (yy * w_l + xx + off_l).reshape(-1))
            )
        rows.append(jnp.stack(taps, axis=-1))
    patches = jnp.stack(rows, axis=-2)               # (L*C, 3, 3)

    rdt = jnp.dtype(config.refine_dtype)
    patches_b, xs_b, ys_b = jax.lax.optimization_barrier(
        (patches.astype(rdt), xs.reshape(-1), ys.reshape(-1))
    )
    delta_x, delta_y, _ = subpixel2d(patches_b)
    scale = jnp.repeat(
        jnp.asarray([g.scale for g in geoms], rdt), c
    )
    offset = jnp.repeat(
        jnp.asarray([g.offset for g in geoms], rdt), c
    )
    fx = (scale * ((xs_b.astype(rdt) + delta_x) + offset)).astype(
        jnp.float32
    )
    fy = (scale * ((ys_b.astype(rdt) + delta_y) + offset)).astype(
        jnp.float32
    )
    fx, fy = jax.lax.optimization_barrier((fx, fy))

    n = n_layers * c
    return KeyPoints(
        x=fx,
        y=fy,
        size=jnp.repeat(
            jnp.asarray([g.scale * 12.0 for g in geoms], jnp.float32), c
        ),
        angle=jnp.full((n,), -1.0, jnp.float32),
        response=tsc.reshape(-1).astype(jnp.float32),
        octave=jnp.repeat(
            jnp.asarray([g.index // 2 for g in geoms], jnp.int32), c
        ),
        valid=accept.reshape(-1),
    )


def _refine_layer_keypoints(
    sc: jnp.ndarray,
    xs, ys, top_scores, valid, accept,
    geom: LayerGeometry,
    config: DetectorConfig,
) -> KeyPoints:
    h, w = sc.shape

    # Sub-pixel refinement on every candidate (masked later): gather the
    # 3x3 patch around each; patch[a, b] = Score(x+b-1, y+a-1), matching the
    # reference's argument order (scale-space-layer-inl.h:394-402).
    # Nine 1-D flat takes instead of one 2-D advanced-index gather.
    def gather_patch(x, y):
        flat = sc.reshape(-1)
        rows = []
        for dy in (-1, 0, 1):
            taps = []
            for dx in (-1, 0, 1):
                yy = jnp.clip(y + dy, 0, h - 1)
                xx = jnp.clip(x + dx, 0, w - 1)
                taps.append(jnp.take(flat, yy * w + xx))
            rows.append(jnp.stack(taps, axis=-1))
        return jnp.stack(rows, axis=-2)  # (K, 3y, 3x)

    return refine_from_patches(
        gather_patch(xs, ys), xs, ys, top_scores, accept, geom, config
    )


def refine_from_patches(
    patches, xs, ys, top_scores, accept,
    geom: LayerGeometry,
    config: DetectorConfig,
) -> KeyPoints:
    """Sub-pixel refine + coordinate un-mapping from pre-gathered 3x3
    score patches (shared by the dense and tile-sharded paths).

    The float chain is fenced with ``optimization_barrier`` so XLA
    compiles the identical subgraph identically in every surrounding jit
    context (dense jit vs shard_map) — without the fences, fusion-
    context-dependent FMA contraction flips the last ULP of x/y between
    the two paths.
    """
    k = xs.shape[0]
    rdt = jnp.dtype(config.refine_dtype)
    patches, xs_b, ys_b = jax.lax.optimization_barrier(
        (patches.astype(rdt), xs, ys)
    )
    delta_x, delta_y, _ = subpixel2d(patches)

    # KeyPointX = _scale * ((x + delta_x) + _offset) in double, stored float
    # (scale-space-layer-inl.h:405-406).
    scale = jnp.asarray(geom.scale, rdt)
    offset = jnp.asarray(geom.offset, rdt)
    fx = (scale * ((xs_b.astype(rdt) + delta_x) + offset)).astype(jnp.float32)
    fy = (scale * ((ys_b.astype(rdt) + delta_y) + offset)).astype(jnp.float32)
    fx, fy = jax.lax.optimization_barrier((fx, fy))

    return KeyPoints(
        x=fx,
        y=fy,
        size=jnp.full((k,), geom.scale * 12.0, jnp.float32),
        angle=jnp.full((k,), -1.0, jnp.float32),
        response=top_scores.astype(jnp.float32),
        octave=jnp.full((k,), geom.index // 2, jnp.int32),
        valid=accept,
    )

