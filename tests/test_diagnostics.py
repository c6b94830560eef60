"""Library-level exactness diagnostics.

The capacity-classed perf backends (per-layer candidate caps, block
top-k, refine caps, describe compaction) silently truncate on overflow;
`with_diagnostics=True` must FLAG undersized caps instead, while ample
caps certify ok without changing any output value. The reference never
drops candidates — its sort keeps all (score-calculator.h:66-85) — so
the diagnostics are this pipeline's contract for matching that.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.quick


@pytest.fixture(scope="module")
def crop(img1):
    return np.asarray(img1)[:240, :320]


def test_harris_diag_flags_small_caps(crop):
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.detect.scale_space import (
        DetectorConfig,
        detect_keypoints,
    )

    img = jnp.asarray(crop)
    ample = DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=8192, max_keypoints=1024,
    )
    # Same jit context on both sides (fusion-context FMA contraction
    # flips last ULPs between eager and jit on XLA:CPU — NOTES).
    kps_plain = jax.jit(lambda im: detect_keypoints(im, ample))(img)
    kps, diag = jax.jit(
        lambda im: detect_keypoints(im, ample, with_diagnostics=True)
    )(img)
    assert bool(diag.ok)
    assert np.all(
        np.asarray(diag.cand_counts) <= np.asarray(diag.cand_caps)
    )
    # Diagnostics must not perturb the detection itself.
    for f in ("x", "y", "size", "response", "octave", "valid"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kps, f)), np.asarray(getattr(kps_plain, f))
        )

    tiny = DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=8, max_keypoints=1024,
    )
    _, diag_t = jax.jit(
        lambda im: detect_keypoints(im, tiny, with_diagnostics=True)
    )(img)
    assert not bool(diag_t.ok)
    assert np.any(
        np.asarray(diag_t.cand_counts) > np.asarray(diag_t.cand_caps)
    )


def test_harris_diag_flags_refine_and_block_topk(crop):
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.detect.scale_space import (
        DetectorConfig,
        detect_keypoints,
    )

    img = jnp.asarray(crop)
    # Refine caps far below the accepted counts -> flagged.
    rc_tiny = DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=8192, max_keypoints=1024, refine_capacity=2,
    )
    _, diag = jax.jit(
        lambda im: detect_keypoints(im, rc_tiny, with_diagnostics=True)
    )(img)
    assert not bool(diag.ok)
    assert np.any(
        np.asarray(diag.accepted_counts) > np.asarray(diag.refine_caps)
    )

    # Block top-k with r=2 and k=64 on a layer with ~1.5k maxima in 38
    # blocks: some block holds >2 of the top-64, so the sharp exactness
    # flag must trip (r=1 would hit the nb*r <= k exact fallback).
    blk = DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=64, max_keypoints=1024,
        topk_impl="block", topk_block_size=2048, topk_block_r=2,
    )
    _, diag_b = jax.jit(
        lambda im: detect_keypoints(im, blk, with_diagnostics=True)
    )(img)
    assert not bool(diag_b.ok)
    assert not np.all(np.asarray(diag_b.topk_exact))

    # Generous r: exact and ok (given ample caps).
    blk_ok = DetectorConfig(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=8192, max_keypoints=1024,
        topk_impl="block", topk_block_size=2048, topk_block_r=256,
    )
    _, diag_ok = jax.jit(
        lambda im: detect_keypoints(im, blk_ok, with_diagnostics=True)
    )(img)
    assert bool(diag_ok.ok)


def test_ast_diag_flags_small_caps(crop):
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.detect.ast_scale_space import (
        ast_capacity_diagnostics,
        detect_ast_keypoints,
    )

    img = jnp.asarray(crop)
    kps, diag = detect_ast_keypoints(
        img, threshold=70, octaves=1, max_candidates_per_layer=2048,
        with_diagnostics=True,
    )
    assert bool(diag.ok)
    kps_plain = detect_ast_keypoints(
        img, threshold=70, octaves=1, max_candidates_per_layer=2048
    )
    np.testing.assert_array_equal(
        np.asarray(kps.valid), np.asarray(kps_plain.valid)
    )

    _, diag_t = detect_ast_keypoints(
        img, threshold=70, octaves=1, max_candidates_per_layer=4,
        with_diagnostics=True,
    )
    assert not bool(diag_t.ok)

    # The pyramid-only fast path agrees with the full-detect counts.
    fast = jax.jit(
        lambda im: ast_capacity_diagnostics(im, 70, 1, 2048)
    )(img)
    np.testing.assert_array_equal(
        np.asarray(fast.corner_counts), np.asarray(diag.corner_counts)
    )
    assert bool(fast.ok)


def test_describe_diag_counts_describable(crop):
    import jax.numpy as jnp

    from ethzasl_brisk_jax.describe.extractor import (
        extract_descriptors_compact,
    )
    from ethzasl_brisk_jax.pipeline import BriskFeature

    feature = BriskFeature(
        octaves=2, uniformity_radius=30.0, absolute_threshold=20.0,
        max_candidates=8192, max_keypoints=512,
    )
    img = jnp.asarray(crop)
    kps = feature.detect(img)
    imgs = img[None]
    bkps = type(kps)(
        **{
            f: getattr(kps, f)[None]
            for f in ("x", "y", "size", "angle", "response", "octave",
                      "valid")
        }
    )
    okp, desc, n_desc = extract_descriptors_compact(
        feature.extractor.pattern, imgs, bkps, capacity=512,
        with_diagnostics=True,
    )
    n_desc = int(np.asarray(n_desc))
    n_described = int(np.asarray(okp.valid).sum())
    assert 0 < n_desc <= 512
    # Every describable keypoint was described (capacity not exceeded).
    assert n_described == n_desc

    # Undersized capacity: the count flags the overflow, and exactly
    # `capacity` keypoints get described.
    cap = max(1, n_desc // 2)
    okp2, _, n2 = extract_descriptors_compact(
        feature.extractor.pattern, imgs, bkps, capacity=cap,
        with_diagnostics=True,
    )
    assert int(np.asarray(n2)) == n_desc  # count reports the true need
    assert int(np.asarray(n2)) > cap
    assert int(np.asarray(okp2.valid).sum()) == cap
