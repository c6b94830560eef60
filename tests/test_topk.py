"""Sort-free exact top-k (kernels/topk.py) == lax.top_k, bitwise."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_jax.detect.scale_space import (  # noqa: E402
    DetectorConfig,
    detect_keypoints,
)
from ethzasl_brisk_jax.kernels.topk import (  # noqa: E402
    INT32_MIN,
    topk_from_mask,
    topk_int32,
)

pytestmark = pytest.mark.quick


@pytest.mark.parametrize("kind", ["uniform", "ties", "sparse", "const"])
def test_topk_matches_lax(kind):
    seeds = {"uniform": 101, "ties": 202, "sparse": 303, "const": 404}
    rng = np.random.default_rng(seeds[kind])
    n, k = 200_000, 4096
    if kind == "uniform":
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32
        )
    elif kind == "ties":
        x = rng.integers(-4, 4, n).astype(np.int32)
    elif kind == "sparse":
        x = np.full(n, INT32_MIN, np.int32)
        m = rng.random(n) < 0.01
        x[m] = rng.integers(0, 500, m.sum()).astype(np.int32)
    else:
        x = np.full(n, 7, np.int32)
    xv = jnp.asarray(x)
    rv, ri = jax.lax.top_k(xv, k)
    tv, ti = jax.jit(lambda a: topk_int32(a, k))(xv)
    np.testing.assert_array_equal(np.asarray(rv), np.asarray(tv))
    np.testing.assert_array_equal(np.asarray(ri), np.asarray(ti))


@pytest.mark.parametrize(
    "density,kind",
    [(0.005, "values"), (0.019, "values"), (0.01, "ties"),
     (0.01, "min_vals"), (0.0, "empty")],
)
def test_topk_from_mask_matches_lax(density, kind):
    """Bit-equal to lax.top_k(where(mask, x, MIN), k) when count <= k —
    including tie order and the sentinel padding rows."""
    rng = np.random.default_rng(int(density * 1e4) + len(kind))
    n, k = 200_000, 4096
    mask = rng.random(n) < density
    assert mask.sum() <= k
    if kind == "ties":
        x = rng.integers(-3, 3, n).astype(np.int32)
    elif kind == "min_vals":
        # Masked values at the extreme negative end (but > INT32_MIN:
        # equality with the sentinel is a documented precondition —
        # detection masks imply score >= threshold).
        x = rng.integers(-100, 100, n).astype(np.int32)
        x[mask] = np.where(
            rng.random(mask.sum()) < 0.3, INT32_MIN + 1, x[mask]
        )
    else:
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32
        )
    xv, mv = jnp.asarray(x), jnp.asarray(mask)
    rv, ri = jax.lax.top_k(jnp.where(mv, xv, INT32_MIN), k)
    tv, ti = jax.jit(lambda a, m: topk_from_mask(a, m, k))(xv, mv)
    np.testing.assert_array_equal(np.asarray(rv), np.asarray(tv))
    np.testing.assert_array_equal(np.asarray(ri), np.asarray(ti))


def test_topk_from_mask_overflow_semantics():
    """count > k: first k masked positions in index order, sorted by
    descending score (documented capacity-overflow degradation)."""
    rng = np.random.default_rng(5)
    n, k = 50_000, 512
    mask = rng.random(n) < 0.05
    assert mask.sum() > k
    x = rng.integers(0, 10_000, n).astype(np.int32)
    tv, ti = jax.jit(
        lambda a, m: topk_from_mask(a, m, k)
    )(jnp.asarray(x), jnp.asarray(mask))
    first_k = np.flatnonzero(mask)[:k]
    assert set(np.asarray(ti).tolist()) == set(first_k.tolist())
    got_v = np.asarray(tv)
    assert (np.diff(got_v) <= 0).all()
    np.testing.assert_array_equal(np.sort(got_v)[::-1], np.sort(x[first_k])[::-1])


def test_detect_with_compact_topk_bitwise():
    from scipy import ndimage

    rng = np.random.default_rng(12)
    base = rng.integers(0, 256, (240, 320)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((5, 5)) / 25.0, mode="nearest")
    img = jnp.asarray(np.clip(sm, 0, 255).astype(np.uint8))
    # max_candidates must cover every maximum (4050 on layer 0 of this
    # image) — the regime "compact" is exact in; under capacity
    # overflow it degrades differently from "sort" (documented).
    cfgs = [
        DetectorConfig(
            octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
            max_candidates=8192, max_keypoints=512, max_num_kpt=512,
            topk_impl=impl,
        )
        for impl in ("sort", "compact")
    ]
    a = jax.jit(lambda im: detect_keypoints(im, cfgs[0]))(img)
    b = jax.jit(lambda im: detect_keypoints(im, cfgs[1]))(img)
    for f in ("x", "y", "size", "response", "octave", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )


def test_detect_with_select_topk_bitwise():
    from scipy import ndimage

    rng = np.random.default_rng(11)
    base = rng.integers(0, 256, (240, 320)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((5, 5)) / 25.0, mode="nearest")
    img = jnp.asarray(np.clip(sm, 0, 255).astype(np.uint8))
    cfgs = [
        DetectorConfig(
            octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
            max_candidates=2048, max_keypoints=512, max_num_kpt=512,
            topk_impl=impl,
        )
        for impl in ("sort", "select")
    ]
    a = jax.jit(lambda im: detect_keypoints(im, cfgs[0]))(img)
    b = jax.jit(lambda im: detect_keypoints(im, cfgs[1]))(img)
    for f in ("x", "y", "size", "response", "octave", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), err_msg=f
        )


def test_detect_per_layer_caps_bitwise():
    """Per-layer max_candidates == uniform capacity when both cover
    every maximum (valid keypoints bitwise equal)."""
    from scipy import ndimage

    rng = np.random.default_rng(13)
    base = rng.integers(0, 256, (240, 320)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((5, 5)) / 25.0, mode="nearest")
    img = jnp.asarray(np.clip(sm, 0, 255).astype(np.uint8))
    # Maxima per layer on this image: (4050, 1787, 955, 395).
    a = jax.jit(lambda im: detect_keypoints(im, DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=8192, max_keypoints=512, max_num_kpt=512,
    )))(img)
    b = jax.jit(lambda im: detect_keypoints(im, DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=(8192, 2048, 1024, 512), max_keypoints=512,
        max_num_kpt=512,
    )))(img)
    va = np.asarray(a.valid)
    vb = np.asarray(b.valid)
    assert va.sum() == vb.sum()
    oa = np.lexsort((np.asarray(a.x)[va], np.asarray(a.y)[va]))
    ob = np.lexsort((np.asarray(b.x)[vb], np.asarray(b.y)[vb]))
    for f in ("x", "y", "size", "response"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f))[va][oa],
            np.asarray(getattr(b, f))[vb][ob], err_msg=f,
        )


@pytest.mark.parametrize("kind", ["sparse", "ties", "uniform"])
def test_topk_block_matches_lax(kind):
    """topk_block == lax.top_k bitwise (valid entries) when exact=True."""
    from ethzasl_brisk_jax.kernels.topk import topk_block

    seeds = {"sparse": 11, "ties": 22, "uniform": 33}
    rng = np.random.default_rng(seeds[kind])
    n, k = 307_200, 8192
    if kind == "sparse":
        # Candidate-mask-like data: ~2% valid, like bench layer 0.
        x = np.full(n, INT32_MIN, np.int32)
        m = rng.random(n) < 0.02
        x[m] = rng.integers(20, 10_000, m.sum()).astype(np.int32)
    elif kind == "ties":
        x = np.full(n, INT32_MIN, np.int32)
        m = rng.random(n) < 0.05
        x[m] = rng.integers(0, 6, m.sum()).astype(np.int32)
    else:
        x = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64).astype(
            np.int32
        )
    xv = jnp.asarray(x)
    rv, ri = jax.lax.top_k(xv, k)
    tv, ti, ex = jax.jit(
        lambda a: topk_block(a, k, block=2048, r=256)
    )(xv)
    # Dense uniform data fills every block past r, yet stays exact:
    # the global k-th (~top 2.7%) sits well above each block's r-th
    # (~top 12.5%), so nothing dropped was relevant — the flag must
    # recognize that, not cry wolf on mere block fullness.
    assert bool(ex)
    rv, ri, tv, ti = map(np.asarray, (rv, ri, tv, ti))
    valid = rv > INT32_MIN
    np.testing.assert_array_equal(rv, tv)
    np.testing.assert_array_equal(ri[valid], ti[valid])


def test_topk_block_overflow_flag_is_sharp():
    """Flag stays True when overflow is BELOW the k-th value (harmless)."""
    from ethzasl_brisk_jax.kernels.topk import topk_block

    n, k, block, r = 16_384, 64, 2048, 32
    x = np.full(n, INT32_MIN, np.int32)
    # Block 0: r+10 entries but all small (below the global k-th).
    x[: r + 10] = 1
    # The k winners spread over blocks 1-4 (16 each, under r).
    for b in range(1, 5):
        x[b * block : b * block + 16] = 1000
    tv, ti, ex = jax.jit(
        lambda a: topk_block(a, k, block=block, r=r)
    )(jnp.asarray(x))
    rv, ri = jax.lax.top_k(jnp.asarray(x), k)
    assert bool(ex)
    np.testing.assert_array_equal(np.asarray(rv), np.asarray(tv))
    np.testing.assert_array_equal(np.asarray(ri), np.asarray(ti))
    # Now push block 0's overflow INTO the k-th-value range: not exact.
    x2 = x.copy()
    x2[: r + 10] = 1000
    _, _, ex2 = jax.jit(
        lambda a: topk_block(a, k, block=block, r=r)
    )(jnp.asarray(x2))
    assert not bool(ex2)


def test_detect_block_topk_bitwise_equal():
    """Full detect with topk_impl='block' == 'sort', bitwise, real image."""
    rng = np.random.default_rng(5)
    from scipy import ndimage

    img = ndimage.gaussian_filter(
        rng.uniform(0, 255, (240, 320)), 1.5
    ).astype(np.uint8)
    base = dict(
        octaves=2, absolute_threshold=20.0, max_candidates=2048,
        max_num_kpt=512, uniformity_radius=30.0,
    )
    from ethzasl_brisk_jax.kernels.harris import harris_score_i32

    kp_sort = jax.jit(
        lambda im: detect_keypoints(
            im, DetectorConfig(**base), harris_score_i32
        )
    )(jnp.asarray(img))
    kp_block = jax.jit(
        lambda im: detect_keypoints(
            im, DetectorConfig(**base, topk_impl="block"),
            harris_score_i32,
        )
    )(jnp.asarray(img))
    for f in ("x", "y", "response", "size", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kp_sort, f)),
            np.asarray(getattr(kp_block, f)), err_msg=f,
        )


def test_fused_refine_bitwise_equals_per_layer():
    """The cross-layer fused refine tail == the per-layer path, bitwise.

    The fused path engages when every layer shares the compacted
    capacity; forcing distinct per-layer caps under max_num_kpt selects
    the per-layer path on the same input for comparison.
    """
    rng = np.random.default_rng(9)
    from scipy import ndimage

    img = ndimage.gaussian_filter(
        rng.uniform(0, 255, (240, 320)), 1.5
    ).astype(np.uint8)
    from ethzasl_brisk_jax.kernels.harris import harris_score_i32

    base = dict(
        octaves=2, absolute_threshold=20.0, max_num_kpt=512,
        uniformity_radius=30.0,
    )
    # Equal per-layer caps -> fused tail; per-layer caps staying above
    # max_num_kpt keep the candidate sets identical, so the only
    # difference is the refine code path.
    kp_f = jax.jit(
        lambda im: detect_keypoints(
            im, DetectorConfig(**base, max_candidates=2048),
            harris_score_i32,
        )
    )(jnp.asarray(img))
    import ethzasl_brisk_jax.detect.scale_space as ss
    orig = ss._refine_keypoints_fused
    try:
        ss._refine_keypoints_fused = None  # force the per-layer branch

        def detect_per_layer(im):
            cfg = DetectorConfig(**base, max_candidates=2048)
            n = cfg.n_layers
            scores, masks = ss.layer_score_masks(im, cfg, harris_score_i32)
            geoms = [ss.layer_geometry(i) for i in range(n)]
            cands = [
                ss._layer_candidates(scores[i], masks[i], cfg,
                                     cfg.layer_cap(i))
                for i in range(n)
            ]
            accepts = [
                ss._layer_accept(cands[i], scores[i].shape, cfg)
                for i in range(n)
            ]
            from ethzasl_brisk_jax.core.keypoints import KeyPoints
            per = []
            for i in range(n):
                xs, ys, tsc, valid, acc = ss.compact_accepted(
                    *cands[i][:4], accepts[i], cfg
                )
                per.append(ss._refine_layer_keypoints(
                    scores[i], xs, ys, tsc, valid, acc, geoms[i], cfg
                ))
            return KeyPoints.concatenate(per)

        kp_p = jax.jit(detect_per_layer)(jnp.asarray(img))
    finally:
        ss._refine_keypoints_fused = orig
    assert int(np.asarray(kp_f.valid).sum()) > 100
    for f in ("x", "y", "size", "angle", "response", "octave", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kp_f, f)),
            np.asarray(getattr(kp_p, f)), err_msg=f,
        )


def test_refine_capacity_bitwise_when_counts_fit():
    """refine_capacity covering every accepted candidate == default
    (valid keypoints bitwise equal; capacity class like max_candidates)."""
    from scipy import ndimage

    rng = np.random.default_rng(21)
    base = rng.integers(0, 256, (240, 320)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((5, 5)) / 25.0, mode="nearest")
    img = jnp.asarray(np.clip(sm, 0, 255).astype(np.uint8))
    kw = dict(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=2048, max_keypoints=512, max_num_kpt=512,
    )
    a = jax.jit(lambda im: detect_keypoints(
        im, DetectorConfig(**kw)))(img)
    b = jax.jit(lambda im: detect_keypoints(
        im, DetectorConfig(**kw, refine_capacity=(256, 128, 128, 64)),
    ))(img)
    va, vb = np.asarray(a.valid), np.asarray(b.valid)
    assert va.sum() == vb.sum() and va.sum() > 100, (va.sum(), vb.sum())
    oa = np.lexsort((np.asarray(a.x)[va], np.asarray(a.y)[va]))
    ob = np.lexsort((np.asarray(b.x)[vb], np.asarray(b.y)[vb]))
    for f in ("x", "y", "size", "response", "octave"):
        np.testing.assert_array_equal(
            np.asarray(getattr(a, f))[va][oa],
            np.asarray(getattr(b, f))[vb][ob], err_msg=f,
        )


def test_max3x3_pair_collapse_equals_nine_compares():
    """center >= max3x3(W) (canonicalized pair) == AND of the 9 shifted
    center_ge_warped compares, on real warp pairs incl. negative scores
    and border extrapolation (the non-canonical-pair misorder bug)."""
    from ethzasl_brisk_jax.detect.scale_space import (
        _max3x3_pair,
        _shift2d,
        center_ge_warped,
        layer_geometry,
        warp_scores_split,
    )

    rng = np.random.default_rng(3)
    h, w = 96, 128
    geom = layer_geometry(0)
    a, b, d = geom.above_map
    sh, sw = 2 * h // 3, 2 * w // 3 + 1
    for trial in range(3):
        src = jnp.asarray(rng.integers(
            -2**29, 2**29, (sh, sw), dtype=np.int64).astype(np.int32))
        sc = jnp.asarray(rng.integers(
            -2**29, 2**29, (h, w), dtype=np.int64).astype(np.int32))
        w_hi, w_lo = warp_scores_split(src, (a, b, d), (h, w))
        ref = jnp.ones((h, w), bool)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ref &= center_ge_warped(
                    sc, _shift2d(w_hi, dy, dx, 0),
                    _shift2d(w_lo, dy, dx, 0), d,
                )
        mh, ml = _max3x3_pair(w_hi, w_lo)
        got = center_ge_warped(sc, mh, ml, d)
        np.testing.assert_array_equal(
            np.asarray(ref), np.asarray(got), err_msg=f"trial {trial}"
        )

    # Sharp check vs an int64 ground truth on adversarial pairs (hi/lo
    # drawn independently over the real bilerp ranges, where the
    # UNCANONICAL lex max misorders; random warp pairs above rarely
    # trigger it but the bench frames did).
    for dd in (2, 4, 16):
        hi = rng.integers(-dd * dd * 4, dd * dd * 4, (h, w)).astype(
            np.int32
        )
        lo = rng.integers(
            -(dd * dd) * 2**15 + 1, (dd * dd) * 2**15, (h, w)
        ).astype(np.int32)
        wv = hi.astype(np.int64) * 2**15 + lo.astype(np.int64)
        wp = np.zeros((h + 2, w + 2), np.int64)
        wp[1:-1, 1:-1] = wv
        ref64 = np.max(
            np.lib.stride_tricks.sliding_window_view(wp, (3, 3)),
            axis=(2, 3),
        )
        mh, ml = _max3x3_pair(jnp.asarray(hi), jnp.asarray(lo))
        got64 = (
            np.asarray(mh).astype(np.int64) * 2**15
            + np.asarray(ml).astype(np.int64)
        )
        np.testing.assert_array_equal(got64, ref64, err_msg=f"d={dd}")
