"""End-to-end golden parity vs the reference's shipped verification set.

Mirrors the reference's own correctness notion (test-binary-equal.cc):
bit-exact keypoints + descriptors on test_data/img{1,2}.pgm, modulo
response-tie ordering which the reference's unstable std::sort leaves
undefined (uniformity-enforcement-inl.h:55).
"""
import numpy as np
import pytest

from ethzasl_brisk_jax.core.golden import read_set

from .conftest import TEST_DATA


@pytest.fixture(scope="module")
def harris_golden():
    path = TEST_DATA / "brisk_verification_harris.set"
    if not path.exists():
        pytest.skip("golden set not available")
    return read_set(str(path))


@pytest.fixture(scope="module")
def harris_feature():
    from ethzasl_brisk_jax.pipeline import BriskFeature

    # Params of the reference's golden run (test-binary-equal.cc:82-88).
    return BriskFeature(
        octaves=0,
        uniformity_radius=30.0,
        absolute_threshold=20.0,
        max_candidates=16384,
        max_keypoints=16384,
        refine_dtype="float64",
    )


def _align(got_xy, want_xy, tol=2e-3):
    from scipy.spatial import cKDTree

    d, j = cKDTree(want_xy).query(got_xy, distance_upper_bound=tol)
    gi = np.where(np.isfinite(d))[0]
    wi = j[gi]
    _, first = np.unique(wi, return_index=True)
    return gi[np.sort(first)], wi[np.sort(first)]


@pytest.mark.parametrize("entry_idx", [0, 1])
def test_harris_golden_parity(harris_golden, harris_feature, entry_idx):
    import jax
    import jax.numpy as jnp

    e = harris_golden[entry_idx]
    # The golden run refines in float64 (Subpixel2D takes doubles);
    # without x64 the refine_dtype="float64" request silently degrades
    # to float32 and only the atol hides it.
    with jax.enable_x64(True):
        kps, desc = harris_feature.detect_and_compute(jnp.asarray(e.image))
    host = kps.to_numpy()
    got_xy = np.stack([host["x"], host["y"]], axis=1)
    got_desc = (
        np.asarray(desc)[np.asarray(kps.valid)]
        .view(np.uint8)
        .reshape(len(got_xy), -1)
    )
    want = e.keypoint_array()
    want_xy = want[:, :2]

    # Same number of keypoints (up to one tie-order swap per image).
    assert abs(len(got_xy) - len(want_xy)) <= 1

    gi, wi = _align(got_xy, want_xy)
    assert len(gi) >= len(want_xy) - 1

    # Responses bit-exact.
    np.testing.assert_array_equal(host["response"][gi], want[wi, 4])
    # Positions to refinement precision.
    np.testing.assert_allclose(got_xy[gi], want_xy[wi], atol=1e-4)
    # Angles within atan2-rounding slack.
    dang = np.abs(host["angle"][gi] - want[wi, 3])
    assert np.minimum(dang, 360 - dang).max() < 0.1
    # Descriptors bit-exact.
    np.testing.assert_array_equal(got_desc[gi], e.descriptors[wi])


def test_exact_angle_host_matches_reference_fixtures():
    """Pins the exact angle/theta chain (_exact_angle_host) on direction
    sums captured from the golden runs: atan2 in DOUBLE of float-cast
    sums (brisk-descriptor-extractor.cc:732 — the unqualified atan2
    resolves to the C double function; the double chain matches 454/454
    + 443/443 golden angles, the atan2f float-overload chain only
    ~55%)."""
    from ethzasl_brisk_jax.describe.extractor import _exact_angle_host

    fixtures = [  # (d0, d1, golden angle, theta)
        (4535757, -2590177, np.float32(-29.728842), 940),
        (4481776, -5669780, np.float32(-51.67478), 878),
        (7998779, -1551955, np.float32(-10.980327), 994),
        (1533999, -3030746, np.float32(-63.153946), 845),
        (2854528, 7931858, np.float32(70.20714), 200),
        (2131479, -7041702, np.float32(-73.15926), 817),
        (-5853073, 798459, np.float32(172.23183), 490),
        (300112, -2749580, np.float32(-83.77092), 787),
        (-2286869, 1554434, np.float32(145.79521), 415),
        (4632015, -2381660, np.float32(-27.211033), 948),
    ]
    d0 = np.array([f[0] for f in fixtures], np.int64)
    d1 = np.array([f[1] for f in fixtures], np.int64)
    want_ang = np.array([f[2] for f in fixtures], np.float32)
    want_theta = np.array([f[3] for f in fixtures], np.int32)
    ang, theta = _exact_angle_host(
        d0, d1, np.full(len(fixtures), -1.0, np.float32),
        np.ones(len(fixtures), bool),
    )
    np.testing.assert_array_equal(ang, want_ang)
    np.testing.assert_array_equal(theta, want_theta)
    # Provided-angle branch: angle passes through, theta from the given
    # value (brisk-descriptor-extractor.cc:744-753).
    given = np.array([10.0, -90.0], np.float32)
    ang2, theta2 = _exact_angle_host(
        np.zeros(2, np.int64), np.zeros(2, np.int64), given,
        np.zeros(2, bool),
    )
    np.testing.assert_array_equal(ang2, given)
    # -90deg: trunc(-256 + 0.5) = -255 (C int cast truncates toward
    # zero), wrapped to 769 — NOT -256 -> 768.
    np.testing.assert_array_equal(
        theta2, [int(1024 * 10.0 / 360.0 + 0.5), 769]
    )
