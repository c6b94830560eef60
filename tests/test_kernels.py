"""Kernel twin tests: jnp kernels vs independent scalar NumPy references.

Mirrors the reference's unit-test strategy (SURVEY.md section 4): each SIMD
kernel has a scalar twin (test-integral-image.cc, test-downsampling.cc).
"""
import numpy as np
import pytest

from ethzasl_brisk_jax.kernels.downsample import halfsample8, twothirdsample8
from ethzasl_brisk_jax.kernels.harris import harris_score_i32
from ethzasl_brisk_jax.kernels.integral import integral_image_i32
from ethzasl_brisk_jax.kernels.nms import maxima2d_mask

from . import np_reference as ref

RNG = np.random.default_rng(42)


def random_u8(h, w):
    return RNG.integers(0, 256, size=(h, w), dtype=np.uint8)


class TestIntegralImage:
    def test_matches_naive(self):
        img = random_u8(37, 53)
        got = np.asarray(integral_image_i32(img))
        want = ref.integral_image(img)
        np.testing.assert_array_equal(got, want)

    def test_shape_and_border(self):
        img = random_u8(8, 8)
        got = np.asarray(integral_image_i32(img))
        assert got.shape == (9, 9)
        assert (got[0] == 0).all() and (got[:, 0] == 0).all()
        assert got[-1, -1] == img.astype(np.int64).sum()


class TestDownsampling:
    @pytest.mark.parametrize("shape", [(20, 30), (37, 53), (64, 64)])
    def test_halfsample(self, shape):
        img = random_u8(*shape)
        got = np.asarray(halfsample8(img))
        want = ref.halfsample(img)
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("shape", [(21, 30), (36, 54), (63, 63)])
    def test_twothirdsample(self, shape):
        img = random_u8(*shape)
        got = np.asarray(twothirdsample8(img))
        want = ref.twothirdsample(img)
        np.testing.assert_array_equal(got, want)

    def test_halfsample_saturation(self):
        img = np.full((4, 4), 255, np.uint8)
        got = np.asarray(halfsample8(img))
        assert (got == 255).all()


class TestHarris:
    def test_matches_scalar(self):
        img = random_u8(24, 31)
        got = np.asarray(harris_score_i32(img))
        want = ref.harris_scores(img)
        np.testing.assert_array_equal(got, want)

    def test_zero_border(self):
        img = random_u8(16, 16)
        got = np.asarray(harris_score_i32(img))
        assert (got[:2] == 0).all() and (got[-2:] == 0).all()
        assert (got[:, :2] == 0).all() and (got[:, -2:] == 0).all()


class TestMaxima2d:
    def test_simple_peak(self):
        score = np.zeros((10, 10), np.int32)
        score[5, 5] = 100
        score[5, 6] = 50
        mask = np.asarray(maxima2d_mask(score, 1))
        assert mask[5, 5]
        assert not mask[5, 6]

    def test_border_excluded(self):
        score = np.zeros((10, 10), np.int32)
        score[1, 1] = 100
        mask = np.asarray(maxima2d_mask(score, 1))
        assert not mask.any()

    def test_plateau_ties_survive(self):
        score = np.zeros((10, 10), np.int32)
        score[4:6, 4:6] = 7
        mask = np.asarray(maxima2d_mask(score, 1))
        assert mask[4:6, 4:6].all()

    def test_threshold(self):
        score = np.zeros((10, 10), np.int32)
        score[5, 5] = 10
        assert not np.asarray(maxima2d_mask(score, 11)).any()
        assert np.asarray(maxima2d_mask(score, 10))[5, 5]


class TestWarpSplit:
    """Split-int32 warped-score compare vs an int64 NumPy reference."""

    @pytest.mark.parametrize("affine", [(4, -1, 6), (12, 2, 9), (6, -1, 8),
                                        (24, 3, 16)])
    def test_center_ge_warped_exact(self, affine):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.detect.scale_space import (
            center_ge_warped,
            warp_scores_split,
        )

        a, b, d = affine
        rng = np.random.default_rng(5)
        src = rng.integers(-(2**29), 2**29, size=(40, 52), dtype=np.int64)
        dst_shape = (30, 40)
        w_hi, w_lo = warp_scores_split(
            jnp.asarray(src, jnp.int32), affine, dst_shape
        )

        # int64 reference with identical truncation semantics.
        def trunc_div(v, dd):
            return np.where(v >= 0, v // dd, -((-v) // dd))

        def terms(n, limit):
            val = a * np.arange(n) + b
            i0 = trunc_div(val, d)
            frac = val - i0 * d
            ok = (i0 + 1 < limit) & (i0 >= 0)
            return np.clip(i0, 0, limit - 2), frac, ok

        u0, fu, oku = terms(dst_shape[1], src.shape[1])
        v0, fv, okv = terms(dst_shape[0], src.shape[0])
        s00 = src[v0[:, None], u0[None, :]]
        s01 = src[v0[:, None], u0[None, :] + 1]
        s10 = src[v0[:, None] + 1, u0[None, :]]
        s11 = src[v0[:, None] + 1, u0[None, :] + 1]
        fu_, fv_ = fu[None, :], fv[:, None]
        ref64 = (d - fv_) * ((d - fu_) * s00 + fu_ * s01) + fv_ * (
            (d - fu_) * s10 + fu_ * s11
        )
        ref64 = np.where(okv[:, None] & oku[None, :], ref64, 0)

        got = np.asarray(w_hi).astype(np.int64) * 32768 + np.asarray(w_lo)
        np.testing.assert_array_equal(got, ref64)

        center = rng.integers(-(2**29), 2**29, size=dst_shape)
        want_cmp = center * (d * d) >= ref64
        got_cmp = np.asarray(
            center_ge_warped(jnp.asarray(center, jnp.int32), w_hi, w_lo, d)
        )
        np.testing.assert_array_equal(got_cmp, want_cmp)

        # Exercise the cutoff branch boundary: center == warped exactly.
        eq_center = trunc_div(ref64, d * d)
        exact = eq_center * (d * d) == ref64
        got_eq = np.asarray(
            center_ge_warped(
                jnp.asarray(eq_center, jnp.int32), w_hi, w_lo, d
            )
        )
        np.testing.assert_array_equal(got_eq[exact], True)


class TestGoldenRoundtrip:
    def test_set_write_read(self, tmp_path):
        from ethzasl_brisk_jax.core.golden import (
            GoldenEntry,
            GoldenKeyPoint,
            read_set,
            write_set,
        )

        rng = np.random.default_rng(9)
        e = GoldenEntry(
            path="x.pgm",
            image=rng.integers(0, 256, (8, 10), np.uint8).astype(np.uint8),
            keypoints=[
                GoldenKeyPoint(1.5, -1, 0, 3.25, 4.5, 100.0, 12.0),
                GoldenKeyPoint(-1.0, -1, 2, 7.0, 2.0, 55.0, 24.0),
            ],
            descriptors=rng.integers(0, 256, (2, 48), np.uint8).astype(
                np.uint8
            ),
            userdata={"blob": b"\x01\x02\x03"},
        )
        p = str(tmp_path / "t.set")
        write_set(p, [e])
        back = read_set(p)[0]
        np.testing.assert_array_equal(back.image, e.image)
        np.testing.assert_array_equal(back.descriptors, e.descriptors)
        assert back.userdata == e.userdata
        for a, b in zip(back.keypoints, e.keypoints):
            assert (a.x, a.y, a.angle, a.size) == (b.x, b.y, b.angle, b.size)

    def test_reference_set_roundtrip(self):
        import pathlib

        from ethzasl_brisk_jax.core.golden import read_set, write_set

        src = pathlib.Path(
            "/root/reference/brisk/src/test/test_data/"
            "brisk_verification_harris.set"
        )
        if not src.exists():
            pytest.skip("no reference set")
        import tempfile

        entries = read_set(str(src))
        with tempfile.NamedTemporaryFile(suffix=".set") as f:
            write_set(f.name, entries)
            data_out = open(f.name, "rb").read()
        assert data_out == open(src, "rb").read()


class TestV1Pattern:
    def test_v1_extractor_runs(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.core.keypoints import KeyPoints
        from ethzasl_brisk_jax.describe.extractor import BriskExtractor

        rng = np.random.default_rng(4)
        img = jnp.asarray(rng.integers(0, 256, (120, 160), np.uint8))
        ext = BriskExtractor(version="v1")
        # v1 ring pattern: 60 points, 512 short pairs -> 64-byte descriptor.
        assert ext.pattern.n_points == 60
        assert ext.descriptor_bytes == 64
        kps = KeyPoints.from_numpy(
            x=rng.uniform(40, 120, 16),
            y=rng.uniform(40, 80, 16),
        )
        out, desc = ext(img, kps)
        assert desc.shape == (16, 16)
        assert int(out.valid.sum()) > 0
        assert (np.asarray(desc)[np.asarray(out.valid)] != 0).any()


class TestHarrisFloat:
    def test_matches_scalar(self):
        from ethzasl_brisk_jax.kernels.harris import harris_score_f32

        img = random_u8(20, 24)
        got = np.asarray(harris_score_f32(img))
        want = ref.harris_scores_f32(img)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-2)


class TestAgastVariants:
    """7/12 variants + 16-bit integral (value-exactness of the 9/16 and
    5/8 maps vs the compiled reference is established in tools/)."""

    def test_712_shapes_and_selfconsistency(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.kernels.agast import (
            agast7_12d_score_map,
            agast7_12s_score_map,
        )

        img = random_u8(32, 40)
        s = np.asarray(agast7_12s_score_map(jnp.asarray(img)))
        d = np.asarray(agast7_12d_score_map(jnp.asarray(img)))
        assert s.shape == img.shape and d.shape == img.shape
        # Flat image: no corners anywhere.
        flat = np.asarray(
            agast7_12s_score_map(jnp.full((20, 20), 7, jnp.uint8))
        )
        assert (flat[2:-2, 2:-2] <= 0).all()

    def test_integral16(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.kernels.integral import integral_image_16_f32

        img = RNG.integers(0, 65536, (16, 20), np.uint16)
        got = np.asarray(integral_image_16_f32(jnp.asarray(img)))
        want = np.zeros((17, 21), np.float64)
        want[1:, 1:] = np.cumsum(
            np.cumsum(img.astype(np.float64) / 65536.0, 0), 1
        )
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-4)


class TestFilters:
    def test_gauss_i16(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.kernels.filters import filter_gauss_3x3_i16

        img = RNG.integers(-1000, 1000, (12, 14)).astype(np.int16)
        got = np.asarray(filter_gauss_3x3_i16(jnp.asarray(img)))
        k = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]])
        want = np.zeros_like(img, np.int32)
        for y in range(1, 11):
            for x in range(1, 13):
                want[y, x] = (
                    (img[y - 1 : y + 2, x - 1 : x + 2].astype(np.int32) * k)
                    .sum() >> 4
                )
        np.testing.assert_array_equal(got, want.astype(np.int16))

    def test_filter2d_matches_scipy(self):
        import jax.numpy as jnp
        from scipy import ndimage

        from ethzasl_brisk_jax.kernels.filters import filter2d

        img = RNG.normal(size=(15, 17)).astype(np.float32)
        k = RNG.normal(size=(3, 5)).astype(np.float32)
        got = np.asarray(filter2d(jnp.asarray(img), k))
        want = ndimage.correlate(img, k, mode="constant")
        want[:1] = 0; want[-1:] = 0; want[:, :2] = 0; want[:, -2:] = 0
        np.testing.assert_allclose(got[1:-1, 2:-2], want[1:-1, 2:-2],
                                   rtol=1e-4, atol=1e-4)


class TestPopcount:
    """test-popcount.cc equivalent: matcher distances vs scalar bit loop."""

    def test_popcnt_xor_paths_agree(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.match.matcher import (
            hamming_distance_matrix,
            hamming_distance_matrix_popcnt,
        )

        q = RNG.integers(0, 2**32, (20, 12), dtype=np.uint32)
        t = RNG.integers(0, 2**32, (30, 12), dtype=np.uint32)
        mxu = np.asarray(hamming_distance_matrix(jnp.asarray(q),
                                                 jnp.asarray(t)))
        pop = np.asarray(
            hamming_distance_matrix_popcnt(jnp.asarray(q), jnp.asarray(t))
        )
        # Scalar reference: per-bit loop.
        want = np.zeros((20, 30), np.int32)
        qb = np.unpackbits(q.view(np.uint8), axis=1)
        tb = np.unpackbits(t.view(np.uint8), axis=1)
        for i in range(20):
            for j in range(30):
                want[i, j] = int((qb[i] != tb[j]).sum())
        np.testing.assert_array_equal(pop, want)
        np.testing.assert_array_equal(mxu, want)


class TestTimingRegistry:
    def test_timer_and_report(self):
        import time

        from ethzasl_brisk_jax.utils.timing import Timer, Timing, timer

        Timing.reset()
        with timer("unit/stage-a"):
            time.sleep(0.01)
        t = Timer("unit/stage-b")
        time.sleep(0.005)
        t.stop()
        assert not t.is_timing()
        a = Timing.get("unit/stage-a")
        assert a is not None and a.total_samples == 1
        assert a.rolling_mean >= 0.009
        report = Timing.print_timing()
        assert "unit/stage-a" in report and "unit/stage-b" in report
        Timing.reset()
        assert Timing.get("unit/stage-a") is None


class TestKeyPointsHelpers:
    def test_compact_and_topk(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.core.keypoints import KeyPoints

        kps = KeyPoints.from_numpy(
            x=np.array([1.0, 2.0, 3.0, 4.0]),
            y=np.array([5.0, 6.0, 7.0, 8.0]),
            response=np.array([10.0, 40.0, 20.0, 30.0]),
            capacity=6,
        )
        # Invalidate one entry, compact moves valid to front.
        kps = kps.__class__(**{
            **{f.name: getattr(kps, f.name)
               for f in __import__("dataclasses").fields(kps)},
            "valid": kps.valid.at[0].set(False),
        })
        c = kps.compact()
        assert bool(c.valid[:3].all()) and not bool(c.valid[3:].any())

        top2 = kps.top_k(2)
        assert top2.capacity == 2
        np.testing.assert_array_equal(
            np.sort(np.asarray(top2.response)), [30.0, 40.0]
        )


class TestPatternFile:
    def test_ptn_loader_matches_builtin(self):
        """Runtime .ptn loading (brisk-descriptor-extractor.cc:357-367)
        reproduces the built-in v2 tables exactly."""
        import os

        from ethzasl_brisk_jax.core.pattern import (
            brisk_v2_pattern,
            pattern_from_file,
        )

        ptn = "/root/reference/brisk/brisk.ptn"
        if not os.path.exists(ptn):
            import pytest

            pytest.skip("reference brisk.ptn not available")
        ref = brisk_v2_pattern(1.0)
        got = pattern_from_file(ptn, 1.0)
        for f in (
            "lut_x", "lut_y", "lut_sigma", "scale_list", "size_list",
            "short_pairs", "long_pairs", "long_weights",
        ):
            np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))


class TestUniformity:
    def test_blocked_equals_sequential_oracle(self):
        """The blocked-interaction uniformity pass is bit-identical to the
        direct transcription of the reference's greedy grid loop."""
        import jax.numpy as jnp

        from ethzasl_brisk_jax.detect.uniformity import (
            enforce_uniformity,
            enforce_uniformity_sequential,
        )

        rng = np.random.default_rng(42)
        for k, radius, span in (
            (200, 30.0, 640),
            (513, 15.0, 640),
            (256, 45.0, 640),
            # Dense cluster: long accept/reject dependency chains stress
            # the interval-bound fixpoint's middle ("wait") state.
            (512, 30.0, 120),
        ):
            n_valid = int(rng.integers(1, k + 1))
            xs = rng.integers(0, span, k).astype(np.int32)
            ys = rng.integers(0, min(span, 480), k).astype(np.int32)
            sc = np.sort(rng.integers(20, 100000, k))[::-1].astype(np.int32)
            sc[n_valid:] = -(2**31)
            valid = np.zeros(k, bool)
            valid[:n_valid] = True
            args = (
                jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(sc),
                jnp.asarray(valid),
            )
            kw = dict(rows=480, cols=640, radius=radius,
                      max_num_kpt=min(k, 300))
            a = np.asarray(enforce_uniformity(*args, **kw))
            b = np.asarray(enforce_uniformity_sequential(*args, **kw))
            np.testing.assert_array_equal(a, b)


class TestAgastScoreMapGoldens:
    """Arc-detector cornerScore rasters vs the COMPILED reference
    (tests/fixtures/agast_scoremaps_img1crop.npz, generated by
    tools/refbuild/ref_harness.cc `scoremaps` on img1[100:280,150:370]).
    cornerScore with threshold b equals max(b, t*-map) — the fixtures
    use b=0, so each dense map must satisfy max(0, map) == raster on the
    common interior. Pins OAST9/16 (oast9-16-nms.cc), AGAST5/8
    (agast5-8-nms.cc) and both 7/12 variants (agast7-12{s,d}-nms.cc)."""

    BORDERS = {  # ours (the reference border is in the fixture)
        "oast9_16": 3, "agast5_8": 2, "agast7_12s": 2, "agast7_12d": 3,
    }

    @pytest.fixture(scope="class")
    def fixture(self):
        import pathlib

        p = pathlib.Path(__file__).parent / "fixtures" / \
            "agast_scoremaps_img1crop.npz"
        return np.load(p)

    @pytest.fixture(scope="class")
    def crop(self, fixture):
        from ethzasl_brisk_jax.core.image_io import read_pgm

        from .conftest import TEST_DATA

        p = TEST_DATA / "img1.pgm"
        if not p.exists():
            pytest.skip("reference test data unavailable")
        y0, y1, x0, x1 = fixture["image_crop"]
        return read_pgm(str(p))[y0:y1, x0:x1]

    @pytest.mark.parametrize(
        "name", ["oast9_16", "agast5_8", "agast7_12s", "agast7_12d"]
    )
    def test_scoremap_matches_compiled_reference(self, fixture, crop, name):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.kernels import agast as agast_kernels

        fn = getattr(agast_kernels, f"{name}_score_map")
        got = np.asarray(fn(jnp.asarray(crop)))
        want = fixture[name]
        b = max(self.BORDERS[name], int(fixture[name + "_border"]))
        sl = np.s_[b:-b, b:-b]
        np.testing.assert_array_equal(np.maximum(0, got[sl]), want[sl])
