"""Dense BriskLayer: threshold map, OAST corner detection, score maps.

Mirrors ``brisk/src/brisk-layer.cc`` with whole-image dense compute:

* ``threshold_map`` — local contrast = max-min over {center, four 5x5
  corners, 3x3-max/min blocks at the four 5x5 edge midpoints}
  (``CalculateThresholdMap``, brisk-layer.cc:278-598); valid on
  [3, n-4], zero elsewhere.
* ``corner_mask`` — the OAST 9/16 detection rule with per-pixel threshold
  modulation (``oast9-16.cc:86-96``): skip if thrmap < b*lower/100; else
  corner iff t* >= clamp(thrmap, lower, upper)*b/100.
* ``score_cache`` — the effective lazily-cached score values
  (brisk-layer.cc:99-132): ``max(t*, thrmap)`` at detected corners (the
  reference seeds the cache from ``cornerScore`` with the *unclamped*
  threshold-map value), ``max(t*, 0)`` elsewhere (every other query uses
  threshold 1).

The decision trees + bisection collapse to the dense closed-form t* map
(kernels/agast.py), verified value-exact against the reference.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ethzasl_brisk_jax.kernels.agast import oast9_16_score_map


def _shift(x: jnp.ndarray, dy: int, dx: int, fill=0) -> jnp.ndarray:
    h, w = x.shape
    out = jnp.full_like(x, fill)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(x[ys, xs])


def threshold_map(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W) -> int32 threshold map (CalculateThresholdMap).

    Internals run in int16 (values <= 255, max-min <= 255 — every
    comparison exact) at half the memory traffic of the ~20 shifted maps;
    the returned map stays int32 (the established contract).
    """
    p = img.astype(jnp.int16)
    h, w = img.shape

    n3 = [_shift(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    max3 = n3[0]
    min3 = n3[0]
    for v in n3[1:]:
        max3 = jnp.maximum(max3, v)
        min3 = jnp.minimum(min3, v)

    cands_max = [
        p,
        _shift(p, -2, -2), _shift(p, -2, 2), _shift(p, 2, 2),
        _shift(p, 2, -2),
        _shift(max3, -2, 0), _shift(max3, 2, 0), _shift(max3, 0, -2),
        _shift(max3, 0, 2),
    ]
    cands_min = [
        p,
        _shift(p, -2, -2), _shift(p, -2, 2), _shift(p, 2, 2),
        _shift(p, 2, -2),
        _shift(min3, -2, 0), _shift(min3, 2, 0), _shift(min3, 0, -2),
        _shift(min3, 0, 2),
    ]
    mx = cands_max[0]
    mn = cands_min[0]
    for a, b in zip(cands_max[1:], cands_min[1:]):
        mx = jnp.maximum(mx, a)
        mn = jnp.minimum(mn, b)

    valid = jnp.zeros((h, w), bool).at[3 : h - 3, 3 : w - 3].set(True)
    return jnp.where(valid, (mx - mn).astype(jnp.int32), 0)


@dataclasses.dataclass(frozen=True)
class AstLayerMaps:
    """All dense per-layer maps the AST pipeline needs."""

    img: jnp.ndarray          # uint8 (H, W)
    t_star: jnp.ndarray       # int32 OAST 9/16 closed-form score (-1 border)
    thrmap: jnp.ndarray       # int32
    corner: jnp.ndarray       # bool detected-corner mask
    cache: jnp.ndarray        # int32 effective score cache (threshold-1 view)
    scale: float
    offset: float


def build_ast_layer(
    img: jnp.ndarray,
    threshold: int,
    upper: int = 230,
    lower: int = 10,
    scale: float = 1.0,
    offset: float = 0.0,
    v1: bool = False,
) -> AstLayerMaps:
    """Dense BriskLayer maps.

    ``v1=True`` mirrors the legacy engine (brisk-v1.cc:1684-1707): no
    adaptive threshold map — detection is plain OAST 9/16 at the given
    threshold (``getAgastPoints`` sets the detector threshold directly),
    and the corner score seeds are ``cornerScore`` at that threshold,
    which equals t* for every detected corner (t* >= threshold).
    """
    t_star = oast9_16_score_map(img)
    h, w = img.shape
    # detect() loop bounds: y in [3, rows-4] (y < ysize-3), x in [3, cols-4]
    # (x++ then break when x > xsize-4; oast9-16.cc:50-84).
    detect_region = jnp.zeros((h, w), bool).at[3 : h - 3, 3 : w - 3].set(True)
    if v1:
        thr = jnp.full((h, w), int(threshold), jnp.int32)
        corner = detect_region & (t_star >= int(threshold))
        cache = jnp.maximum(t_star, 0)
    else:
        thr = threshold_map(img)
        cmp_thr = (threshold * lower) // 100
        clamped = jnp.clip(thr, lower, upper)
        b2 = (clamped * threshold) // 100
        corner = detect_region & (thr >= cmp_thr) & (t_star >= b2)
        cache = jnp.where(
            corner, jnp.maximum(t_star, thr), jnp.maximum(t_star, 0)
        )
    return AstLayerMaps(
        img=img,
        t_star=t_star,
        thrmap=thr,
        corner=corner,
        cache=cache,
        scale=scale,
        offset=offset,
    )
