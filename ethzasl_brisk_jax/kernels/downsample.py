"""Pyramid down-sampling with the reference's exact integer rounding.

Reference: ``brisk/src/image-down-sampling.cc`` — SIMD half-sampling
(2x2 average, round-up-by-one at each pairwise step, ``Halfsample8``
:142) and two-thirds sampling (3x3 -> 2x2 weighted average,
``Twothirdsample8`` :550). The scalar rounding spec is the reference's own
unit test (``test-downsampling.cc:67-140``): every pairwise average is
``(a + b + 1) / 2`` in integer arithmetic.

Here these are fixed-weight strided window reductions — implemented as
reshapes + integer averages so XLA fuses them into a single pass; rounding
is reproduced exactly.
"""
from __future__ import annotations

import jax.numpy as jnp


def _avg_round_up(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    return (a + b + 1) >> 1


def halfsample8(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W) -> uint8 (H//2, W//2), reference rounding.

    dst = min(((v11+1+v21)/2 + (v12+1+v22)/2 + 1)/2, 255)
    (test-downsampling.cc:83-85).
    """
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    v = img[: 2 * h2, : 2 * w2].astype(jnp.int32)
    blocks = v.reshape(h2, 2, w2, 2)
    col0 = _avg_round_up(blocks[:, 0, :, 0], blocks[:, 1, :, 0])
    col1 = _avg_round_up(blocks[:, 0, :, 1], blocks[:, 1, :, 1])
    out = _avg_round_up(col0, col1)
    return jnp.minimum(out, 255).astype(jnp.uint8)


def twothirdsample8(img: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W) -> uint8 (H//3*2, W//3*2), reference rounding.

    Each 3x3 source block {A1..C3} produces a 2x2 output:
      D = ((A + B + 1)/2 + A + 1)/2 per column (rows A,B -> upper; C,B ->
      lower), then the same two-thirds blend horizontally
    (test-downsampling.cc:118-140).
    """
    h3, w3 = img.shape[0] // 3, img.shape[1] // 3
    v = img[: 3 * h3, : 3 * w3].astype(jnp.int32)
    b = v.reshape(h3, 3, w3, 3)  # (bh, 3, bw, 3)

    a_row, b_row, c_row = b[:, 0], b[:, 1], b[:, 2]  # (bh, bw, 3)
    upper = _avg_round_up(_avg_round_up(a_row, b_row), a_row)  # (bh, bw, 3)
    lower = _avg_round_up(_avg_round_up(c_row, b_row), c_row)

    def blend_h(row):  # (bh, bw, 3) -> (bh, bw, 2)
        left = _avg_round_up(_avg_round_up(row[..., 0], row[..., 1]),
                             row[..., 0])
        right = _avg_round_up(_avg_round_up(row[..., 2], row[..., 1]),
                              row[..., 2])
        return jnp.stack([left, right], axis=-1)

    up2 = blend_h(upper)   # (bh, bw, 2)
    lo2 = blend_h(lower)
    out = jnp.stack([up2, lo2], axis=1)  # (bh, 2, bw, 2)
    out = out.reshape(2 * h3, 2 * w3)
    return (out & 0xFF).astype(jnp.uint8)


def halfsample16(img: jnp.ndarray) -> jnp.ndarray:
    """uint16 variant (Halfsample16, image-down-sampling.cc:56)."""
    h2, w2 = img.shape[0] // 2, img.shape[1] // 2
    v = img[: 2 * h2, : 2 * w2].astype(jnp.int32)
    blocks = v.reshape(h2, 2, w2, 2)
    col0 = _avg_round_up(blocks[:, 0, :, 0], blocks[:, 1, :, 0])
    col1 = _avg_round_up(blocks[:, 0, :, 1], blocks[:, 1, :, 1])
    out = _avg_round_up(col0, col1)
    return jnp.minimum(out, 65535).astype(jnp.uint16)


def twothirdsample16(img: jnp.ndarray) -> jnp.ndarray:
    """uint16 variant (Twothirdsample16, image-down-sampling.cc:394)."""
    h3, w3 = img.shape[0] // 3, img.shape[1] // 3
    v = img[: 3 * h3, : 3 * w3].astype(jnp.int32)
    b = v.reshape(h3, 3, w3, 3)
    a_row, b_row, c_row = b[:, 0], b[:, 1], b[:, 2]
    upper = _avg_round_up(_avg_round_up(a_row, b_row), a_row)
    lower = _avg_round_up(_avg_round_up(c_row, b_row), c_row)

    def blend_h(row):
        left = _avg_round_up(_avg_round_up(row[..., 0], row[..., 1]),
                             row[..., 0])
        right = _avg_round_up(_avg_round_up(row[..., 2], row[..., 1]),
                              row[..., 2])
        return jnp.stack([left, right], axis=-1)

    out = jnp.stack([blend_h(upper), blend_h(lower)], axis=1)
    out = out.reshape(2 * h3, 2 * w3)
    return (out & 0xFFFF).astype(jnp.uint16)


# ---------------------------------------------------------------------------
# BRISK v1 legacy resamplers (brisk-v1.cc:1847-2072). The v1 engine ships
# its OWN SSE downsamplers whose rounding differs from the v2 kernels
# above: everything goes through saturating avg_epu8 chains (round-up
# halving), the 15->10 two-thirds shuffle has a byte-12 quirk (the last
# group's "middle" tap reads column 12 instead of 13 — mask1/mask2 at
# :1989-1990), and the non-SIMD tails (half_end 16-px block, leftover
# columns) round DIFFERENTLY from the main path (truncating /2, /4, /9).
# Validated bit-exact against the compiled reference on every pyramid
# layer of img1 (tools/refbuild; tests/test_v1.py pins crops).
# ---------------------------------------------------------------------------

_V1_T2 = (0, 2, 3, 5, 6, 8, 9, 11, 12, 14)
_V1_T1 = (1, 1, 4, 4, 7, 7, 10, 10, 12, 12)


def twothirdsample8_v1(img: jnp.ndarray) -> jnp.ndarray:
    """v1 two-thirds sampling (brisk_v1::BriskLayer::twothirdsample,
    brisk-v1.cc:1984-2072): vertical avg(avg(a,b),a) chains, 15->10
    horizontal shuffle+avg per SIMD group, exact /9 weighted average on
    the leftover columns."""
    import numpy as np

    h, w = img.shape
    dh, dw = 2 * (h // 3), 2 * (w // 3)
    k = h // 3
    hsize = w // 15
    leftover = ((w // 3) * 3) % 15

    s = img.astype(jnp.int32)
    a_row = s[0 : 3 * k : 3]
    b_row = s[1 : 3 * k : 3]
    c_row = s[2 : 3 * k : 3]
    up = _avg_round_up(_avg_round_up(a_row, b_row), a_row)
    lo = _avg_round_up(_avg_round_up(c_row, b_row), c_row)

    base = np.arange(hsize) * 15
    i_t2 = jnp.asarray((base[:, None] + np.array(_V1_T2)).ravel())
    i_t1 = jnp.asarray((base[:, None] + np.array(_V1_T1)).ravel())

    def horiz(v):  # (k, w) -> (k, 10*hsize) SIMD-group shuffle+avg
        t2 = v[:, i_t2]
        t1 = v[:, i_t1]
        return _avg_round_up(_avg_round_up(t2, t1), t2)

    c0 = 15 * hsize
    up_cols = [horiz(up)]
    lo_cols = [horiz(lo)]
    # Leftover columns use the RAW rows (not the avg chains), /9 trunc.
    for j in range(0, leftover, 3):
        a1, a2, a3 = (a_row[:, c0 + j + t] for t in range(3))
        b1, b2, b3 = (b_row[:, c0 + j + t] for t in range(3))
        c1, c2, c3 = (c_row[:, c0 + j + t] for t in range(3))
        up_cols.append(
            jnp.stack(
                [(4 * a1 + 2 * (a2 + b1) + b2) // 9,
                 (4 * a3 + 2 * (a2 + b3) + b2) // 9], axis=1
            )
        )
        lo_cols.append(
            jnp.stack(
                [(4 * c1 + 2 * (c2 + b1) + b2) // 9,
                 (4 * c3 + 2 * (c2 + b3) + b2) // 9], axis=1
            )
        )
    up_full = jnp.concatenate(up_cols, axis=1)
    lo_full = jnp.concatenate(lo_cols, axis=1)
    out = jnp.stack([up_full, lo_full], axis=1).reshape(dh, dw)
    return (out & 0xFF).astype(jnp.uint8)


def halfsample8_v1(img: jnp.ndarray) -> jnp.ndarray:
    """v1 half sampling (brisk_v1::BriskLayer::halfsample,
    brisk-v1.cc:1847-1982): avg_epu8 vertical+horizontal on 32-px double
    blocks; the odd trailing 16-px block averages horizontally with a
    TRUNCATING /2; leftover columns use overlapping (a[k]+a[k+1]+b[k]+
    b[k+1])/4 truncating pairs."""
    h, w = img.shape
    dh = h // 2
    hsize = w // 16
    end = hsize // 2
    half_end = hsize % 2 == 1
    leftover = (w % 16) // 2

    s = img.astype(jnp.int32)
    a_row = s[0 : 2 * dh : 2]
    b_row = s[1 : 2 * dh : 2]
    v = _avg_round_up(a_row, b_row)

    cols = []
    c_main = 32 * end
    if end:
        main = v[:, :c_main]
        cols.append(_avg_round_up(main[:, 0::2], main[:, 1::2]))
    c = c_main
    if half_end:
        blk = v[:, c : c + 16]
        cols.append((blk[:, 0::2] + blk[:, 1::2]) // 2)
        c += 16
    for kk in range(leftover):
        cols.append(
            (
                (a_row[:, c + kk] + a_row[:, c + kk + 1]
                 + b_row[:, c + kk] + b_row[:, c + kk + 1]) // 4
            )[:, None]
        )
    out = jnp.concatenate(cols, axis=1)
    return (out & 0xFF).astype(jnp.uint8)
