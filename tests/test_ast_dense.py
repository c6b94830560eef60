"""Dense AST detect (ast_dense.py) == candidate path.

The dense rewrite recomputes every IsMax2D / Refine3D / scan decision
over full maps; these tests pin equality against
detect_ast_keypoints(raw_cache_model="emulated") on the reference's own
images, at two strictness levels:

* EAGER + x64: bitwise on every field. Op-by-op execution removes the
  jit fusion context, so this is the true semantic-equality gate (the
  same rule the golden-parity harness uses: XLA:CPU FMA-contracts
  f32/f64 mul+add chains differently per fusion context — two DIFFERENT
  jit graphs can legally disagree in the last ULP of refined tails even
  under x64; observed ~4/4096 slots flipping with a change in an
  UNRELATED subgraph).
* JIT + x64: bitwise on the decision fields (valid, octave) and
  near-exact floats (<= 2 ULP-class tolerance, >= 99% bitwise) — the
  value-class-bug tripwire that still runs the production graph shape.

The GPU-vs-CPU comparison of the dense AST step runs in chip_smoke.py.
"""
import numpy as np
import pytest

FIELDS = ("valid", "octave", "x", "y", "size", "response", "angle")


def _detectors(**kw):
    from ethzasl_brisk_jax.detect.ast_dense import (
        detect_ast_keypoints_dense,
    )
    from ethzasl_brisk_jax.detect.ast_scale_space import (
        detect_ast_keypoints,
    )

    def cand(im):
        return detect_ast_keypoints(im, raw_cache_model="emulated", **kw)

    def dense(im):
        return detect_ast_keypoints_dense(im, **kw)

    return cand, dense


def _compare_eager(img, **kw):
    import jax

    cand, dense = _detectors(**kw)
    with jax.enable_x64(True):
        kp_c = cand(img)
        kp_d = dense(img)
        for f in FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(kp_c, f)),
                np.asarray(getattr(kp_d, f)),
                err_msg=f"dense {f} mismatch (eager)",
            )
        return int(np.asarray(kp_c.valid).sum())


def _compare_jit(img, **kw):
    import jax

    cand, dense = _detectors(**kw)
    with jax.enable_x64(True):
        kp_c = jax.jit(cand)(img)
        kp_d = jax.jit(dense)(img)
        for f in ("valid", "octave"):
            np.testing.assert_array_equal(
                np.asarray(getattr(kp_c, f)),
                np.asarray(getattr(kp_d, f)),
                err_msg=f"dense {f} mismatch (jit)",
            )
        for f in ("x", "y", "size", "response", "angle"):
            a = np.asarray(getattr(kp_c, f))
            b = np.asarray(getattr(kp_d, f))
            exact = float(np.mean(a == b))
            assert exact >= 0.99, (f, exact)
            np.testing.assert_allclose(
                a, b, rtol=2e-5, atol=1e-4, err_msg=f"dense {f} (jit)"
            )
        return int(np.asarray(kp_c.valid).sum())


@pytest.mark.quick
def test_dense_equals_candidates_eager_bitwise(img1):
    import jax.numpy as jnp

    crop = jnp.asarray(np.asarray(img1)[100:300, 200:460])
    n = _compare_eager(
        crop, threshold=50, octaves=1, max_candidates_per_layer=1024
    )
    assert n > 30


@pytest.mark.quick
def test_dense_equals_candidates_jit_crop(img1):
    import jax.numpy as jnp

    crop = jnp.asarray(np.asarray(img1)[:240, :320])
    n = _compare_jit(
        crop, threshold=70, octaves=3, max_candidates_per_layer=2048
    )
    assert n > 30


@pytest.mark.slow
def test_dense_equals_candidates_eager_octaves3(img1):
    import jax.numpy as jnp

    crop = jnp.asarray(np.asarray(img1)[:200, :260])
    n = _compare_eager(
        crop, threshold=70, octaves=3, max_candidates_per_layer=1024
    )
    assert n > 20


@pytest.mark.slow
def test_dense_equals_candidates_full_image_jit(img1):
    import jax.numpy as jnp

    n = _compare_jit(
        jnp.asarray(np.asarray(img1)),
        threshold=70, octaves=3, max_candidates_per_layer=2048,
    )
    assert n > 300


@pytest.mark.slow
def test_dense_equals_candidates_img2_thr30(img2):
    import jax.numpy as jnp

    # Caps must cover the corner counts (6134/2799/1569/779 at thr=30):
    # an undersized cap truncates the CANDIDATE path's aux-map
    # construction (its pass-1 masks only see extracted candidates),
    # while the dense engine's decisions never depend on the caps —
    # equality holds only in the untruncated regime the diagnostics API
    # certifies.
    crop = jnp.asarray(np.asarray(img2)[:320, :448])
    n = _compare_jit(
        crop, threshold=30, octaves=2, max_candidates_per_layer=8192
    )
    assert n > 100


@pytest.mark.slow
def test_dense_equals_candidates_v1_eager(img1):
    import jax.numpy as jnp

    crop = jnp.asarray(np.asarray(img1)[100:300, 200:460])
    n = _compare_eager(
        crop, threshold=70, octaves=1, max_candidates_per_layer=1024,
        v1=True,
    )
    assert n > 10


@pytest.mark.quick
def test_stairs_twin():
    """The numpy index-staircase twin (_stairs_np) must equal the
    traced f32/f64 chain bit for bit under BOTH x64 settings — the
    dense grid is built from the twin via static strided slices."""
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.detect.ast_dense import _stairs_np
    from ethzasl_brisk_jax.detect.ast_scale_space import (
        _dbl_div,
        _fmul,
        _trunc_i32,
        f32,
    )

    def traced(n, mode):
        xs = jnp.arange(n, dtype=jnp.int32)
        xsf = xs.astype(f32)
        if mode == "above_octave":
            x_1 = _dbl_div((4 * xs - 3).astype(f32), 6.0)
            x1 = _dbl_div((4 * xs + 1).astype(f32), 6.0)
        elif mode == "above_intra":
            x_1 = (_fmul(f32(6.0), xsf) - 4) / f32(8.0)
            x1 = (_fmul(f32(6.0), xsf) + 2) / f32(8.0)
        elif mode == "below_octave":
            x_1 = _dbl_div((8 * xs - 3).astype(f32), 6.0)
            x1 = _dbl_div((8 * xs + 5).astype(f32), 6.0)
        else:
            x_1 = _dbl_div((6 * xs - 2).astype(f32), 4.0)
            x1 = _dbl_div((6 * xs + 4).astype(f32), 4.0)
        return (
            np.asarray(_trunc_i32(x_1 + 1)),
            np.asarray(_trunc_i32(x1)),
        )

    for use64 in (False, True):
        with jax.enable_x64(use64):
            for mode in ("above_octave", "above_intra",
                         "below_octave", "below_intra"):
                for n in (107, 214, 321, 427, 641):
                    tf, tl = traced(n, mode)
                    sf, sl = _stairs_np(n, mode)
                    np.testing.assert_array_equal(
                        tf, sf, err_msg=f"{mode} n={n} x64={use64}"
                    )
                    np.testing.assert_array_equal(
                        tl, sl, err_msg=f"{mode} n={n} x64={use64}"
                    )


@pytest.mark.quick
def test_dense_facade_dispatch(img1):
    """BriskFeatureDetector(detect_impl='dense') routes to the dense
    engine and matches the candidate facade (jit-level strictness)."""
    import jax
    import jax.numpy as jnp

    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    crop = jnp.asarray(np.asarray(img1)[:240, :320])
    det_c = BriskFeatureDetector(threshold=70, octaves=3,
                                 max_candidates_per_layer=1024)
    det_d = BriskFeatureDetector(threshold=70, octaves=3,
                                 max_candidates_per_layer=1024,
                                 detect_impl="dense")
    with jax.enable_x64(True):
        kp_c = jax.jit(det_c.detect)(crop)
        kp_d = jax.jit(det_d.detect)(crop)
        for f in ("valid", "octave"):
            np.testing.assert_array_equal(
                np.asarray(getattr(kp_c, f)),
                np.asarray(getattr(kp_d, f)),
            )
        for f in ("x", "y", "size", "response"):
            np.testing.assert_allclose(
                np.asarray(getattr(kp_c, f)),
                np.asarray(getattr(kp_d, f)),
                rtol=2e-5, atol=1e-4,
            )
