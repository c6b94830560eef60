"""Independent NumPy scalar references for kernel twin tests.

These implement the *specifications* documented in SURVEY.md / the kernel
docstrings (integer rounding rules, fixed-point Harris, etc.) as plain
scalar NumPy, mirroring how the reference's own unit tests pit SIMD kernels
against scalar loops (e.g. test-downsampling.cc:66-140).
"""
from __future__ import annotations

import numpy as np


def integral_image(img: np.ndarray) -> np.ndarray:
    h, w = img.shape
    out = np.zeros((h + 1, w + 1), np.int64)
    for y in range(h):
        for x in range(w):
            out[y + 1, x + 1] = (
                int(img[y, x]) + out[y, x + 1] + out[y + 1, x] - out[y, x]
            )
    return out.astype(np.int32)


def halfsample(src: np.ndarray) -> np.ndarray:
    h2, w2 = src.shape[0] // 2, src.shape[1] // 2
    out = np.zeros((h2, w2), np.uint8)
    s = src.astype(np.int64)
    for r in range(h2):
        for c in range(w2):
            v11 = s[2 * r, 2 * c]
            v12 = s[2 * r, 2 * c + 1]
            v21 = s[2 * r + 1, 2 * c]
            v22 = s[2 * r + 1, 2 * c + 1]
            out[r, c] = min(
                ((v11 + 1 + v21) // 2 + (v12 + 1 + v22) // 2 + 1) // 2, 255
            )
    return out


def twothirdsample(src: np.ndarray) -> np.ndarray:
    dh, dw = src.shape[0] // 3 * 2, src.shape[1] // 3 * 2
    out = np.zeros((dh, dw), np.uint8)
    s = src.astype(np.int64)
    for row in range(0, dh, 2):
        for col in range(0, dw, 2):
            blk = s[
                row // 2 * 3 : row // 2 * 3 + 3,
                col // 2 * 3 : col // 2 * 3 + 3,
            ]
            (a1, a2, a3), (b1, b2, b3), (c1, c2, c3) = blk

            d1 = ((a1 + b1 + 1) // 2 + a1 + 1) // 2
            d2 = ((a2 + b2 + 1) // 2 + a2 + 1) // 2
            d3 = ((a3 + b3 + 1) // 2 + a3 + 1) // 2
            e1 = ((c1 + b1 + 1) // 2 + c1 + 1) // 2
            e2 = ((c2 + b2 + 1) // 2 + c2 + 1) // 2
            e3 = ((c3 + b3 + 1) // 2 + c3 + 1) // 2

            out[row, col] = ((d1 + d2 + 1) // 2 + d1 + 1) // 2 & 0xFF
            out[row, col + 1] = ((d3 + d2 + 1) // 2 + d3 + 1) // 2 & 0xFF
            out[row + 1, col] = ((e1 + e2 + 1) // 2 + e1 + 1) // 2 & 0xFF
            out[row + 1, col + 1] = ((e3 + e2 + 1) // 2 + e3 + 1) // 2 & 0xFF
    return out


def _shr(v: int, n: int) -> int:
    """Arithmetic shift right for Python ints (floor division by 2^n)."""
    return v >> n


def harris_scores(img: np.ndarray) -> np.ndarray:
    """Scalar fixed-point Harris, int32 wrap-around semantics explicit."""
    h, w = img.shape
    p = img.astype(np.int64)
    dxdx = np.zeros((h, w), np.int64)
    dydy = np.zeros((h, w), np.int64)
    dxdy = np.zeros((h, w), np.int64)
    for i in range(1, h - 1):
        for j in range(1, w - 1):
            dx = (
                10 * (p[i, j - 1] - p[i, j + 1])
                + 3 * (p[i - 1, j - 1] - p[i - 1, j + 1])
                + 3 * (p[i + 1, j - 1] - p[i + 1, j + 1])
            ) << 3
            dy = (
                10 * (p[i - 1, j] - p[i + 1, j])
                + 3 * (p[i - 1, j - 1] - p[i + 1, j - 1])
                + 3 * (p[i - 1, j + 1] - p[i + 1, j + 1])
            ) << 3
            dxdx[i, j] = (dx * dx) >> 16
            dydy[i, j] = (dy * dy) >> 16
            dxdy[i, j] = (dx * dy) >> 16
    scores = np.zeros((h, w), np.int64)
    for i in range(2, h - 2):
        for j in range(2, w - 2):

            def smooth(m):
                return (
                    4 * m[i, j]
                    + 2 * (m[i - 1, j] + m[i + 1, j] + m[i, j - 1] + m[i, j + 1])
                    + m[i - 1, j - 1]
                    + m[i - 1, j + 1]
                    + m[i + 1, j - 1]
                    + m[i + 1, j + 1]
                ) >> 4

            sxx = smooth(dxdx)
            syy = smooth(dydy)
            sxy = smooth(dxdy)
            t2 = (sxx + syy) >> 1
            scores[i, j] = sxx * syy - sxy * sxy - ((t2 * t2) >> 2)
    return scores.astype(np.int32)


def harris_scores_f32(img):
    """Scalar float Harris (HarrisScoreCalculatorFloat semantics)."""
    img = img.astype(np.float32)
    h, w = img.shape
    gx = np.zeros((h, w), np.float32)
    gy = np.zeros((h, w), np.float32)
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            gx[y, x] = (
                10.0 * (img[y, x - 1] - img[y, x + 1])
                + 3.0 * (img[y - 1, x - 1] - img[y - 1, x + 1])
                + 3.0 * (img[y + 1, x - 1] - img[y + 1, x + 1])
            ) / 16.0
            gy[y, x] = (
                10.0 * (img[y - 1, x] - img[y + 1, x])
                + 3.0 * (img[y - 1, x - 1] - img[y + 1, x - 1])
                + 3.0 * (img[y - 1, x + 1] - img[y + 1, x + 1])
            ) / 16.0

    def smooth(v):
        out = np.zeros_like(v)
        for y in range(1, h - 1):
            for x in range(1, w - 1):
                out[y, x] = (
                    4 * v[y, x]
                    + 2 * (v[y - 1, x] + v[y + 1, x] + v[y, x - 1]
                           + v[y, x + 1])
                    + v[y - 1, x - 1] + v[y - 1, x + 1]
                    + v[y + 1, x - 1] + v[y + 1, x + 1]
                ) / 16.0
        return out

    # zero-pad semantics of the dense kernel: borders contribute zeros
    sxx = smooth(gx * gx)
    syy = smooth(gy * gy)
    sxy = smooth(gx * gy)
    tr = sxx + syy
    score = sxx * syy - sxy * sxy - tr * tr / 16.0
    out = np.zeros((h, w), np.float32)
    out[2 : h - 2, 2 : w - 2] = score[2 : h - 2, 2 : w - 2]
    return out


def maxima2d(scores: np.ndarray, threshold, border: int = 2) -> np.ndarray:
    """Scalar 2-D maxima (Get2dMaxima): >= threshold and >= all eight
    neighbours, on rows/cols [border, n-border)."""
    h, w = scores.shape
    out = np.zeros((h, w), bool)
    for i in range(border, h - border):
        for j in range(border, w - border):
            c = scores[i, j]
            if c < threshold:
                continue
            out[i, j] = all(
                scores[i + dy, j + dx] <= c
                for dy in (-1, 0, 1)
                for dx in (-1, 0, 1)
                if (dy, dx) != (0, 0)
            )
    return out


def box_mean(img: np.ndarray, xf, yf, sigma) -> np.ndarray:
    """Area-weighted mean intensity over the square [xf - sigma, xf +
    sigma] x [yf - sigma, yf + sigma], pixel (r, c) covering
    [c - 0.5, c + 0.5] x [r - 0.5, r + 0.5], in float64: what BRISK's
    box SmoothedIntensity approximates in fixed point. Broadcasts over
    the tap arrays."""
    img = np.asarray(img, np.float64)
    xf, yf, sigma = np.broadcast_arrays(
        np.asarray(xf, np.float64), np.asarray(yf, np.float64),
        np.asarray(sigma, np.float64),
    )

    def weights(c, s, n):
        centers = np.arange(n, dtype=np.float64)
        lo = np.maximum(centers - 0.5, c - s)
        hi = np.minimum(centers + 0.5, c + s)
        return np.clip(hi - lo, 0.0, None)

    out = np.empty(xf.shape)
    h, w = img.shape
    for idx in np.ndindex(xf.shape):
        wx = weights(xf[idx], sigma[idx], w)
        wy = weights(yf[idx], sigma[idx], h)
        out[idx] = wy @ img @ wx / (wx.sum() * wy.sum())
    return out
