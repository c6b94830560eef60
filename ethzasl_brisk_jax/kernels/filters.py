"""Generic 2-D filters: box 3x3, Gaussian 3x3, arbitrary odd kernels.

Mirrors the reference's SSE ``Filter2D``/``FilterBox3by316S``/
``FilterGauss3by316S``/``FilterGauss3by332F``
(``brisk/include/brisk/internal/vectorized-filters.h:53-74``): small
fixed-kernel stencils over 8U/16S/32F images. Here these are one fused
pass built from static shifts (XLA fuses the taps); the integer
variants reproduce the reference's >> shifts.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def _shift(p: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    h, w = p.shape
    out = jnp.zeros_like(p)
    ys = slice(max(dy, 0), h + min(dy, 0))
    yd = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(dx, 0), w + min(dx, 0))
    xd = slice(max(-dx, 0), w + min(-dx, 0))
    return out.at[yd, xd].set(p[ys, xs])


def filter2d(img: jnp.ndarray, kernel: np.ndarray) -> jnp.ndarray:
    """Correlate with an odd-sized kernel, zero border (Filter2D)."""
    kh, kw = kernel.shape
    assert kh % 2 == 1 and kw % 2 == 1
    acc = None
    p = img
    for i in range(kh):
        for j in range(kw):
            c = kernel[i, j]
            if c == 0:
                continue
            term = c * _shift(p, i - kh // 2, j - kw // 2)
            acc = term if acc is None else acc + term
    h, w = img.shape
    inb = jnp.zeros((h, w), bool).at[
        kh // 2 : h - kh // 2, kw // 2 : w - kw // 2
    ].set(True)
    return jnp.where(inb, acc, 0)


def filter_box_3x3_i16(img: jnp.ndarray) -> jnp.ndarray:
    """3x3 box filter on int16, sum >> 0 semantics kept raw (16S out)."""
    p = img.astype(jnp.int32)
    s = sum(
        _shift(p, dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
    )
    return _border_zero(s, img.shape).astype(jnp.int16)


def filter_gauss_3x3_i16(img: jnp.ndarray) -> jnp.ndarray:
    """[[1,2,1],[2,4,2],[1,2,1]] >> 4 on int16 (FilterGauss3by316S)."""
    p = img.astype(jnp.int32)
    s = (
        4 * p
        + 2 * (_shift(p, -1, 0) + _shift(p, 1, 0) + _shift(p, 0, -1)
               + _shift(p, 0, 1))
        + _shift(p, -1, -1) + _shift(p, -1, 1) + _shift(p, 1, -1)
        + _shift(p, 1, 1)
    ) >> 4
    return _border_zero(s, img.shape).astype(jnp.int16)


def filter_gauss_3x3_f32(img: jnp.ndarray) -> jnp.ndarray:
    """[[1,2,1],[2,4,2],[1,2,1]]/16 on float32 (FilterGauss3by332F)."""
    p = img.astype(jnp.float32)
    s = (
        4.0 * p
        + 2.0 * (_shift(p, -1, 0) + _shift(p, 1, 0) + _shift(p, 0, -1)
                 + _shift(p, 0, 1))
        + _shift(p, -1, -1) + _shift(p, -1, 1) + _shift(p, 1, -1)
        + _shift(p, 1, 1)
    ) / 16.0
    return _border_zero(s, img.shape)


def _border_zero(x: jnp.ndarray, shape) -> jnp.ndarray:
    h, w = shape
    inb = jnp.zeros((h, w), bool).at[1 : h - 1, 1 : w - 1].set(True)
    return jnp.where(inb, x, 0)
