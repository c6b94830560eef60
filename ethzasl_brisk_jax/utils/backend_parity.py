"""Backend parity: the same jitted step on two backends (GPU and CPU).

What must agree, and how closely:

* bitwise: ``valid``, ``octave``, ``size``, ``response``, every
  descriptor word, and the matches (``match_idx``, ``match_dist``). These
  feed matching and are integer- or quantisation-protected.
* refined ``x``/``y``: at most 1 ULP, on at most ``XY_MAX_SHARE`` of the
  valid keypoints. Backends contract the subpixel float chain into FMAs
  differently.
* ``angle``: at most ``ANGLE_MAX_DEG`` degrees. The backends ship
  different f32 ``arctan2`` approximations; the 1024-bin rotation
  quantisation absorbs the difference, which the bitwise descriptor
  check proves.

The AST detector refines through a longer f32 chain (2-D quadratic fits
per layer, then 1-D fits across scale) with a division at each fit. On
the H100 about 29% of random f32 quotients differ from the CPU's
correctly rounded ones, and ``a*b + c*d`` is contracted differently;
fencing every product of the chain leaves as many mismatches, so the
divisions dominate (PERF.md). Refined values move by a few ULP. For
the AST path, ``compare(..., refined_rel=AST_REFINED_REL)`` bounds x,
y, size and response relatively instead (observed at most 8.0e-7);
validity, octave, descriptors and matches stay bitwise.

Geometry (VO and BA on seeded scenes) cannot be bitwise: cuSOLVER and
LAPACK SVDs, and reductions, round differently. Its bounds sit between
the GPU-vs-CPU reading and what TF32 products (about 11 significant
bits, the GPU's default for f32 dots) move: on the CPU by emulation
(``tests/test_geometry_parity.py``), and on the H100 with the products
at default precision (chip_smoke.py, PERF.md):

* ``REFIT_*``: the relative pose refit from one given inlier set
  (``geometry.ransac.pose_from_inliers``). On the H100 it reads 1.7e-3
  degrees and 4.7e-3 in the unit translation (whose direction is weakly
  held by the short baseline); default precision moves it by 0.12
  degrees and flips one translation (a difference of 2.0).
* ``VO_*``: the integrated 12-frame VO trajectory, where each backend
  also runs its own RANSAC vote: a match at the inlier threshold may
  change sides, and one such flip moves a pair's rotation by 0.004-0.034
  degrees (seeded scene, CPU). On the H100 the trajectories are 9.8e-3
  degrees and 4.6e-4 m apart; at default precision 0.86 degrees and
  8.4e-2 m.
"""
from __future__ import annotations

import numpy as np

XY_MAX_ULP = 1
XY_MAX_SHARE = 0.007
ANGLE_MAX_DEG = 2e-3
AST_REFINED_REL = 2.0**-18
REFIT_MAX_ROT_DEG = 1e-2
REFIT_MAX_T = 5e-2
VO_MAX_ROT_DEG = 0.1
VO_MAX_CENTER_M = 2e-3

BITWISE = ("valid", "octave", "desc", "match_idx", "match_dist")
REFINED = ("x", "y", "size", "response")


def ulp_diff(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in units in the last place of float32 (int64)."""
    ai = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    bi = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    # Monotone integer mapping of IEEE floats (sign-magnitude -> biased).
    ai = np.where(ai < 0, -(2**31) - ai, ai)
    bi = np.where(bi < 0, -(2**31) - bi, bi)
    return np.abs(ai - bi)


def step_outputs(kps, desc, match_idx, match_dist) -> dict:
    """Host copies of a pipeline step's outputs, keyed for compare()."""
    out = {f: np.asarray(getattr(kps, f))
           for f in ("x", "y", "size", "angle", "response", "octave",
                     "valid")}
    out.update(desc=np.asarray(desc), match_idx=np.asarray(match_idx),
               match_dist=np.asarray(match_dist))
    return out


def compare(
    ref: dict, got: dict, refined_rel: float | None = None
) -> tuple[list[str], dict]:
    """Compare two step_outputs() dicts.

    ``refined_rel=None`` holds size and response bitwise and x/y to the
    ULP bounds; a number bounds |got - ref| <= refined_rel * |ref| for
    x, y, size and response instead. Returns (failures, maxima): one
    message per violated bound, and the observed maxima (mismatch counts
    of the bitwise fields, max ULP of the refined fields, share of valid
    keypoints off in x/y, max angle difference).
    """
    fails: list[str] = []
    seen: dict = {}
    bitwise = BITWISE if refined_rel else BITWISE + ("size", "response")
    for f in bitwise:
        n = int(np.sum(np.asarray(ref[f]) != np.asarray(got[f])))
        seen[f"{f}_mismatches"] = n
        if n:
            fails.append(f"{f}: {n} entries differ")
    valid = np.asarray(ref["valid"], bool)
    n_valid = max(int(valid.sum()), 1)
    for f in REFINED:
        a, b = ref[f][valid], got[f][valid]
        d = ulp_diff(a, b)
        seen[f"{f}_max_ulp"] = int(d.max(initial=0))
        if refined_rel:
            rel = np.abs(a.astype(np.float64) - b) / np.maximum(
                np.abs(a.astype(np.float64)), np.finfo(np.float32).tiny
            )
            seen[f"{f}_max_rel"] = float(rel.max(initial=0.0))
            if seen[f"{f}_max_rel"] > refined_rel:
                fails.append(
                    f"{f}: max relative diff {seen[f'{f}_max_rel']:.3e} "
                    f"(bound {refined_rel:.3e})"
                )
        elif f in ("x", "y"):
            share = float((d > 0).sum()) / n_valid
            seen[f"{f}_ulp_share"] = share
            if seen[f"{f}_max_ulp"] > XY_MAX_ULP or share > XY_MAX_SHARE:
                fails.append(
                    f"{f}: max {seen[f'{f}_max_ulp']} ULP, {share:.4%} of "
                    f"keypoints differ (bounds {XY_MAX_ULP} ULP, "
                    f"{XY_MAX_SHARE:.2%})"
                )
    da = np.abs(
        np.asarray(ref["angle"], np.float64)[valid]
        - np.asarray(got["angle"], np.float64)[valid]
    )
    da = np.minimum(da, 360.0 - da)
    seen["angle_max_deg"] = float(da.max(initial=0.0))
    if seen["angle_max_deg"] > ANGLE_MAX_DEG:
        fails.append(
            f"angle: max |diff| {seen['angle_max_deg']:.3e} deg "
            f"(bound {ANGLE_MAX_DEG:g})"
        )
    seen["n_valid"] = int(valid.sum())
    return fails, seen


def rotation_deg(a, b) -> float:
    """Angle of the rotation a b^T in degrees, from its skew part: stable
    near identity, where arccos((trace - 1) / 2) of f32 rotations reads
    ~0.03 degrees of pure rounding."""
    d = np.asarray(a, np.float64) @ np.asarray(b, np.float64).T
    v = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.degrees(
        np.arctan2(np.linalg.norm(v) / 2, (np.trace(d) - 1) / 2)
    ))
