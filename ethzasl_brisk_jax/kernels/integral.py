"""Integral images.

Reference: ``brisk/include/brisk/internal/integral-image.h:56-218`` computes
the standard exclusive integral image with SSE two-rows-at-a-time passes; the
unit test (``test-integral-image.cc:48-90``) checks it against the naive
double loop. Here the same result is two ``cumsum`` passes, which XLA
lowers to efficient scans — integer arithmetic is exact, so this is
bit-identical to the reference.

Layout matches OpenCV/the reference: output is ``(H+1, W+1)`` with
``I[y, x] = sum(img[:y, :x])``, first row/col zero.
"""
from __future__ import annotations

import jax.numpy as jnp


def integral_image_i32(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W) -> int32 (H+1, W+1) exclusive integral image."""
    s = jnp.cumsum(jnp.cumsum(img.astype(jnp.int32), axis=0), axis=1)
    return jnp.pad(s, ((1, 0), (1, 0)))


def integral_image_f32(img: jnp.ndarray) -> jnp.ndarray:
    """uint16/float (H, W) -> float32 (H+1, W+1) integral image.

    Mirrors ``IntegralImage16`` (integral-image.h:163-218) which accumulates
    16-bit inputs into float32.
    """
    s = jnp.cumsum(
        jnp.cumsum(img.astype(jnp.float32), axis=0), axis=1
    )
    return jnp.pad(s, ((1, 0), (1, 0)))


def integral_image_16_f32(img: jnp.ndarray) -> jnp.ndarray:
    """uint16 (H, W) -> float32 (H+1, W+1) integral of img/65536.

    Mirrors ``IntegralImage16`` (integral-image.h:163-218): 16-bit input
    scaled by 1/65536 accumulated in float32. Exact summation order
    differs from the reference's row-sequential adds (XLA cumsum uses an
    associative scan), so values agree to f32 round-off, not bitwise.
    """
    x = img.astype(jnp.float32) * jnp.float32(1.0 / 65536.0)
    s = jnp.cumsum(jnp.cumsum(x, axis=0), axis=1)
    out = jnp.zeros(
        (img.shape[0] + 1, img.shape[1] + 1), jnp.float32
    )
    return out.at[1:, 1:].set(s)
