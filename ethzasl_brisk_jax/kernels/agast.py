"""Dense AGAST/OAST corner-score maps.

The reference scores corners with machine-generated decision trees plus a
per-corner bisection over the threshold (``agast/src/oast9-16.cc``,
``oast9-16-nms.cc:36-90``, ``agast5-8-nms.cc``). The corner test is
"all of >= N contiguous circle pixels brighter than p + t or darker than
p - t"; the bisection returns the largest t in [b, 254] passing the test,
i.e. ``max(b, t*)`` with the closed form

    t* = max over arcs A of max( min_A(c) - p - 1,  p - max_A(c) - 1 )

(derived from ``c > p + t`` ⇔ ``t <= min_A(c) - p - 1`` and the darker
mirror). Here this becomes a dense whole-image computation: shift the
image by each circle offset, compute running arc min/max with log-depth
pairwise reductions, one fused pass — no branching tree, no bisection, and
the score of *every* pixel at once (the reference computes them lazily,
``brisk-layer.cc:118-132``).

Circle geometries:
* OAST 9/16: radius-3 Bresenham circle, 16 offsets
  (``oast9-16.h:99-116``), arcs of 9.
* AGAST 5/8: radius-1 ring, 8 offsets (``agast5-8.h:66-75``), arcs of 5.

Validated value-exact against the compiled reference decision trees.
"""
from __future__ import annotations

import jax.numpy as jnp

# (dx, dy) circle offsets, index order of the reference.
OAST_9_16_OFFSETS = (
    (-3, 0), (-3, -1), (-2, -2), (-1, -3), (0, -3), (1, -3), (2, -2),
    (3, -1), (3, 0), (3, 1), (2, 2), (1, 3), (0, 3), (-1, 3), (-2, 2),
    (-3, 1),
)
AGAST_5_8_OFFSETS = (
    (-1, 0), (-1, -1), (0, -1), (1, -1), (1, 0), (1, 1), (0, 1), (-1, 1),
)


def _shifted_stack(img: jnp.ndarray, offsets, border: int) -> jnp.ndarray:
    """(K, H, W) stack with stack[k][y, x] = img[y + dy_k, x + dx_k].

    Only pixels with full in-bounds circles (border px margin) are used
    downstream; outside values are zero-padded.
    """
    p = jnp.pad(img, border)
    h, w = img.shape
    return jnp.stack(
        [
            p[border + dy : border + dy + h, border + dx : border + dx + w]
            for dx, dy in offsets
        ]
    )


def vals_run(vals: jnp.ndarray, run: int, op) -> jnp.ndarray:
    """op-reduction over runs of `run` consecutive circular entries."""
    out = vals
    length = 1
    while length < run:
        step = min(length, run - length)
        # out covers [k, k+length); extend with a (step)-run starting k+length.
        ext = vals_run(vals, step, op) if step != length else out
        out = op(out, jnp.roll(ext, -length, axis=0))
        length += step
    return out


def _score_map(img: jnp.ndarray, offsets, arc: int, border: int
               ) -> jnp.ndarray:
    # int16 internals: pixel values <= 255 and bright/dark margins lie
    # in [-256, 255] — every min/max/subtract exact, at half the memory
    # traffic of the (K, H, W) circle stack. Returned map stays int32.
    p = img.astype(jnp.int16)
    c = _shifted_stack(p, offsets, border)
    arc_min = vals_run(c, arc, jnp.minimum)  # (K, H, W)
    arc_max = vals_run(c, arc, jnp.maximum)
    bright = jnp.max(arc_min, axis=0) - p - jnp.int16(1)
    dark = p - jnp.min(arc_max, axis=0) - jnp.int16(1)
    t_star = jnp.maximum(bright, dark).astype(jnp.int32)

    h, w = img.shape
    inb = jnp.zeros((h, w), bool).at[
        border : h - border, border : w - border
    ].set(True)
    return jnp.where(inb, t_star, -1)


def oast9_16_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense t* map for OAST 9/16 (int32; -1 on the 3-px border).

    ``cornerScore`` with threshold b equals ``max(b, map[y, x])``
    (oast9-16-nms.cc:36-90 bisection semantics).
    """
    return _score_map(img, OAST_9_16_OFFSETS, 9, 3)


def agast5_8_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense t* map for AGAST 5/8 (int32; -1 on the 2-px border)."""
    return _score_map(img, AGAST_5_8_OFFSETS, 5, 2)


AGAST_7_12S_OFFSETS = (
    (-2, 0), (-2, -1), (-1, -2), (0, -2), (1, -2), (2, -1), (2, 0),
    (2, 1), (1, 2), (0, 2), (-1, 2), (-2, 1),
)  # agast7-12s.h:70-82 (square ring)
AGAST_7_12D_OFFSETS = (
    (-3, 0), (-2, -1), (-1, -2), (0, -3), (1, -2), (2, -1), (3, 0),
    (2, 1), (1, 2), (0, 3), (-1, 2), (-2, 1),
)  # agast7-12d.h:70-82 (diamond ring)


def agast7_12s_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense t* map for AGAST 7/12s (int32; -1 on the 2-px border)."""
    return _score_map(img, AGAST_7_12S_OFFSETS, 7, 2)


def agast7_12d_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Dense t* map for AGAST 7/12d (int32; -1 on the 3-px border)."""
    return _score_map(img, AGAST_7_12D_OFFSETS, 7, 3)
