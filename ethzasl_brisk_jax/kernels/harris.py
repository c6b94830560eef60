"""Harris corner scores with the reference's exact integer fixed-point math.

Reference: ``brisk/src/harris-scores.cc:53-279`` (``HarrisScoresSSE``):
  1. Scharr gradients x8:  dx = (10*(L-R) + 3*(UL-UR) + 3*(LL-LR)) << 3
     (int16; max |dx| = 32640, no overflow).
  2. Products via ``_mm_mulhi_epi16``: dxdx = (dx*dx) >> 16 (int16).
  3. 3x3 binomial smoothing:  (4c + 2*edge + corner) >> 4.
  4. score = dxdx*dydy - dxdy^2 - ((trace/2)^2 >> 2), int32.
Gradients live on rows/cols [1, n-2]; scores on [2, n-3]; zero elsewhere.

All intermediates fit int32, and C arithmetic shifts equal jnp's, so this
dense jnp formulation is bit-identical. XLA fuses the shifted slices and
the elementwise chain into a few loop fusions over the image. The ops
carry the ``harris`` name scope, so a profile can attribute them.

Also provides the float variant mirroring ``HarrisScoreCalculatorFloat``
(``brisk/src/harris-score-calculator-float.cc:53-57``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def _shift(p: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """p shifted so out[i,j] = p[i+dy, j+dx], zero-padded.

    Pad + slice (not a scatter into zeros), so XLA fuses the shift into
    its consumers instead of materialising each shifted map.
    """
    h, w = p.shape
    q = jnp.pad(p, ((max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))))
    return q[max(dy, 0) : max(dy, 0) + h, max(dx, 0) : max(dx, 0) + w]


# 3x3 binomial smoothing weights (4c + 2*edge + corner) >> 4.
_SMOOTH = {
    (dy, dx): 4 if dy == dx == 0 else (2 if dy == 0 or dx == 0 else 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
}


@jax.named_scope("harris")
def harris_score_i32(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W) -> int32 (H, W) Harris scores, reference-exact.

    One elementwise expression over 25 shifted views of the zero-padded
    input: the gradient products each smoothing tap needs are recomputed
    at that tap's offset instead of being stored as maps, so XLA emits a
    single loop fusion that reads the image once and writes the scores
    once. Integer sums are exact in any order, so this equals the
    map-by-map formulation bit for bit.
    """
    h, w = img.shape
    pad = jnp.pad(img, 2)
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    def tap(dy, dx):  # out[y, x] = img[y + dy, x + dx], zero outside
        return pad[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w].astype(jnp.int32)

    sxx = syy = sxy = 0
    for (oy, ox), wgt in _SMOOTH.items():
        n = {
            (dy, dx): tap(oy + dy, ox + dx)
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
        }
        dx = (
            10 * (n[(0, -1)] - n[(0, 1)])
            + 3 * (n[(-1, -1)] - n[(-1, 1)])
            + 3 * (n[(1, -1)] - n[(1, 1)])
        ) << 3
        dy = (
            10 * (n[(-1, 0)] - n[(1, 0)])
            + 3 * (n[(-1, -1)] - n[(1, -1)])
            + 3 * (n[(-1, 1)] - n[(1, 1)])
        ) << 3
        # Gradients live on rows/cols [1, n-2] only; the smoothing reads
        # zeros elsewhere.
        inside = (
            (rows + oy >= 1) & (rows + oy < h - 1)
            & (cols + ox >= 1) & (cols + ox < w - 1)
        )
        dx = jnp.where(inside, dx, 0)
        dy = jnp.where(inside, dy, 0)
        # mulhi_epi16: high 16 bits of the exact 32-bit product.
        sxx = sxx + wgt * ((dx * dx) >> 16)
        syy = syy + wgt * ((dy * dy) >> 16)
        sxy = sxy + wgt * ((dx * dy) >> 16)
    sxx, syy, sxy = sxx >> 4, syy >> 4, sxy >> 4

    trace_half = (sxx + syy) >> 1
    score = sxx * syy - sxy * sxy - ((trace_half * trace_half) >> 2)
    valid = (rows >= 2) & (rows < h - 2) & (cols >= 2) & (cols < w - 2)
    return jnp.where(valid, score, 0)


def harris_score_f32(img: jnp.ndarray) -> jnp.ndarray:
    """Float Harris variant (HarrisScoreCalculatorFloat semantics).

    Scharr/16 kernel, float 3x3 Gaussian [[1,2,1],[2,4,2],[1,2,1]]/16
    applied to gradient products, score = det - trace^2/16
    (harris-score-calculator-float.cc:53-57 + vectorized-filters 32F).
    """
    h, w = img.shape
    p = img.astype(jnp.float32)
    n = {
        (dy, dx): _shift(p, dy, dx)
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    }
    gx = (
        10.0 * (n[(0, -1)] - n[(0, 1)])
        + 3.0 * (n[(-1, -1)] - n[(-1, 1)])
        + 3.0 * (n[(1, -1)] - n[(1, 1)])
    ) / 16.0
    gy = (
        10.0 * (n[(-1, 0)] - n[(1, 0)])
        + 3.0 * (n[(-1, -1)] - n[(1, -1)])
        + 3.0 * (n[(-1, 1)] - n[(1, 1)])
    ) / 16.0
    interior = jnp.zeros((h, w), bool).at[1 : h - 1, 1 : w - 1].set(True)
    gx = jnp.where(interior, gx, 0.0)
    gy = jnp.where(interior, gy, 0.0)

    def smooth(v):
        s = (
            4.0 * v
            + 2.0
            * (
                _shift(v, -1, 0)
                + _shift(v, 1, 0)
                + _shift(v, 0, -1)
                + _shift(v, 0, 1)
            )
            + _shift(v, -1, -1)
            + _shift(v, -1, 1)
            + _shift(v, 1, -1)
            + _shift(v, 1, 1)
        )
        return s / 16.0

    sxx, syy, sxy = smooth(gx * gx), smooth(gy * gy), smooth(gx * gy)
    trace = sxx + syy
    score = sxx * syy - sxy * sxy - trace * trace / 16.0
    valid = jnp.zeros((h, w), bool).at[2 : h - 2, 2 : w - 2].set(True)
    return jnp.where(valid, score, 0.0)
