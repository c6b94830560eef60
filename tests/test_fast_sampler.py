"""Sampler and batched-describe exactness.

The flat stacked-frame batch path (describe/extractor
.extract_descriptors_batch) and the compacting path must be
BIT-identical to the per-frame gather path (SmoothedIntensity,
brisk-descriptor-extractor.cc:370-530); the sampler itself must measure
the box mean it stands for, also for the largest keypoints.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.core.pattern import brisk_v2_pattern
from ethzasl_brisk_jax.describe.extractor import (
    DevicePattern,
    extract_descriptors,
    extract_descriptors_batch,
)

H, W = 240, 320


@pytest.fixture(scope="module")
def pat():
    return DevicePattern.from_host(brisk_v2_pattern())


def _random_keypoints(rng, k, h=H, w=W):
    # Sizes spanning the detector's octave range; positions include
    # near-border ones (border filtering itself is under test too).
    size = rng.choice([8.4, 12.0, 16.8, 24.0, 33.6], size=k).astype(
        np.float32
    )
    return KeyPoints(
        x=jnp.asarray(rng.uniform(2, w - 2, k).astype(np.float32)),
        y=jnp.asarray(rng.uniform(2, h - 2, k).astype(np.float32)),
        size=jnp.asarray(size),
        angle=jnp.full((k,), -1.0, jnp.float32),
        response=jnp.zeros((k,), jnp.float32),
        octave=jnp.zeros((k,), jnp.int32),
        valid=jnp.ones((k,), bool),
    )


def test_batch_describe_matches_per_frame(pat):
    rng = np.random.default_rng(1)
    b, k = 4, 97
    imgs = jnp.asarray(rng.integers(0, 256, (b, H, W), dtype=np.uint8))

    frames = [_random_keypoints(rng, k) for _ in range(b)]
    # Frame boundaries are where the stacked layout can go wrong: pin
    # keypoints against the valid-border limit at the top and bottom of
    # each frame.
    for i, f in enumerate(frames):
        y = np.asarray(f.y).copy()
        y[:8] = np.linspace(17.0, 40.0, 8)          # near top edge
        y[8:16] = np.linspace(H - 40.0, H - 17.5, 8)  # near bottom edge
        frames[i] = dataclasses.replace(f, y=jnp.asarray(y))

    batched = KeyPoints(
        **{
            fld.name: jnp.stack(
                [getattr(f, fld.name) for f in frames]
            )
            for fld in dataclasses.fields(KeyPoints)
        }
    )

    kp_b, d_b = extract_descriptors_batch(pat, imgs, batched)

    for i in range(b):
        kp_1, d_1 = extract_descriptors(pat, imgs[i], frames[i])
        valid = np.asarray(kp_1.valid)
        assert valid.sum() > k // 3
        np.testing.assert_array_equal(
            valid, np.asarray(kp_b.valid[i]), err_msg=f"frame {i}"
        )
        np.testing.assert_array_equal(
            np.asarray(kp_1.angle)[valid],
            np.asarray(kp_b.angle[i])[valid],
            err_msg=f"frame {i}",
        )
        np.testing.assert_array_equal(
            np.asarray(d_1)[valid],
            np.asarray(d_b[i])[valid],
            err_msg=f"frame {i}",
        )


class TestDescribeCompact:
    """extract_descriptors_compact == extract_descriptors_batch bitwise
    for every described keypoint, with overflow dropped (valid=False)."""

    def _batch(self, b=3, k=40, seed=5):
        import jax
        import jax.numpy as jnp
        from scipy import ndimage

        from ethzasl_brisk_jax.core.keypoints import KeyPoints

        rng = np.random.default_rng(seed)
        base = rng.integers(0, 256, (b, 120, 160)).astype(np.float32)
        imgs = np.clip(
            ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0,
                             mode="nearest"), 0, 255
        ).astype(np.uint8)
        x = rng.uniform(25, 135, (b, k)).astype(np.float32)
        y = rng.uniform(25, 95, (b, k)).astype(np.float32)
        valid = rng.random((b, k)) < 0.5
        kps = KeyPoints(
            x=jnp.asarray(x), y=jnp.asarray(y),
            size=jnp.full((b, k), 12.0, jnp.float32),
            angle=jnp.full((b, k), -1.0, jnp.float32),
            response=jnp.asarray(rng.uniform(1, 9, (b, k)), ),
            octave=jnp.zeros((b, k), jnp.int32),
            valid=jnp.asarray(valid),
        )
        return jnp.asarray(imgs), kps

    def test_compact_matches_batch(self):
        import numpy as np

        from ethzasl_brisk_jax.describe.extractor import (
            BriskExtractor,
            extract_descriptors_batch,
            extract_descriptors_compact,
        )

        imgs, kps = self._batch()
        ext = BriskExtractor()
        pat = ext.pattern
        ref_kp, ref_desc = extract_descriptors_batch(
            pat, imgs, kps, skip_small=ext.skip_small
        )
        got_kp, got_desc = extract_descriptors_compact(
            pat, imgs, kps, capacity=kps.x.size,
            skip_small=ext.skip_small,
        )
        np.testing.assert_array_equal(
            np.asarray(got_kp.valid), np.asarray(ref_kp.valid)
        )
        m = np.asarray(ref_kp.valid)
        np.testing.assert_array_equal(
            np.asarray(got_desc)[m], np.asarray(ref_desc)[m]
        )
        np.testing.assert_array_equal(
            np.asarray(got_kp.angle)[m], np.asarray(ref_kp.angle)[m]
        )

    def test_compact_overflow_drops(self):
        import numpy as np

        from ethzasl_brisk_jax.describe.extractor import (
            BriskExtractor,
            extract_descriptors_batch,
            extract_descriptors_compact,
        )

        imgs, kps = self._batch()
        ext = BriskExtractor()
        pat = ext.pattern
        cap = 30  # fewer than the number of valid inputs
        ref_kp, ref_desc = extract_descriptors_batch(
            pat, imgs, kps, skip_small=ext.skip_small
        )
        got_kp, got_desc = extract_descriptors_compact(
            pat, imgs, kps, capacity=cap, skip_small=ext.skip_small,
        )
        gv = np.asarray(got_kp.valid)
        assert gv.sum() <= cap
        # Every surviving keypoint is bitwise identical to the batch path.
        m = gv
        np.testing.assert_array_equal(
            np.asarray(got_desc)[m], np.asarray(ref_desc)[m]
        )
        # Non-described slots keep their input coordinates.
        drop = np.asarray(kps.valid) & ~gv
        np.testing.assert_array_equal(
            np.asarray(got_kp.x)[drop], np.asarray(kps.x)[drop]
        )


class TestLargeKeypoints:
    """Keypoints of size 96 and 128 (tap radius up to ~195 px) on a
    bright 480x640 frame whose integral image exceeds 2^24."""

    @staticmethod
    def _frame_and_keypoints(size, seed=11):
        from scipy import ndimage

        rng = np.random.default_rng(seed)
        h, w, k = 480, 640, 16
        noise = ndimage.gaussian_filter(rng.uniform(0, 1, (h, w)), 3.0)
        noise = (noise - noise.min()) / np.ptp(noise)
        img = (200 + 55 * noise).astype(np.uint8)
        assert int(img.astype(np.int64).sum()) > 2**24
        border = 196 if size == 128 else 151  # pattern border, these sizes
        kps = KeyPoints(
            x=jnp.asarray(rng.uniform(border, w - border - 1, k)
                          .astype(np.float32)),
            y=jnp.asarray(rng.uniform(border, h - border - 1, k)
                          .astype(np.float32)),
            size=jnp.full((k,), size, jnp.float32),
            angle=jnp.full((k,), -1.0, jnp.float32),
            response=jnp.zeros((k,), jnp.float32),
            octave=jnp.zeros((k,), jnp.int32),
            valid=jnp.ones((k,), bool),
        )
        return img, kps

    @pytest.mark.parametrize("size", [96.0, 128.0])
    def test_taps_are_box_means(self, pat, size):
        """Every tap equals the float64 area-weighted mean over its box
        (np_reference.box_mean) to within the fixed-point weights."""
        from ethzasl_brisk_jax.describe.extractor import (
            _stack_frames,
            scale_index,
            smoothed_intensity_u8,
        )
        from tests.np_reference import box_mean

        img, kps = self._frame_and_keypoints(size)
        img_pad, int_flat = _stack_frames(jnp.asarray(img[None]))
        sidx = scale_index(kps.size, True)
        got = np.asarray(smoothed_intensity_u8(
            img_pad, int_flat, kps.x, kps.y, pat.lut_x[sidx, 0],
            pat.lut_y[sidx, 0], pat.lut_sigma[sidx], pat.lut_scaling[sidx],
            pat.lut_scaling2[sidx], row_base=jnp.zeros_like(sidx),
            frame_rows=img.shape[0],
        )) / 1024.0
        xs = np.asarray(kps.x)[:, None] + np.asarray(pat.lut_x[sidx, 0])
        ys = np.asarray(kps.y)[:, None] + np.asarray(pat.lut_y[sidx, 0])
        want = box_mean(img, xs, ys, np.asarray(pat.lut_sigma[sidx]))
        np.testing.assert_allclose(got, want, rtol=0, atol=0.1)

    @pytest.mark.parametrize("size", [96.0, 128.0])
    def test_batch_and_compact_match_per_frame(self, pat, size):
        from ethzasl_brisk_jax.describe.extractor import (
            extract_descriptors_compact,
        )

        img, kps = self._frame_and_keypoints(size)
        img2, kps2 = self._frame_and_keypoints(size, seed=12)
        imgs = jnp.asarray(np.stack([img, img2]))
        batched = KeyPoints(**{
            fld.name: jnp.stack([getattr(kps, fld.name),
                                 getattr(kps2, fld.name)])
            for fld in dataclasses.fields(KeyPoints)
        })
        kp_b, d_b = extract_descriptors_batch(pat, imgs, batched)
        kp_c, d_c = extract_descriptors_compact(
            pat, imgs, batched, capacity=2 * kps.x.shape[0]
        )
        for i, (im, kp) in enumerate(((img, kps), (img2, kps2))):
            kp_1, d_1 = extract_descriptors(pat, jnp.asarray(im), kp)
            valid = np.asarray(kp_1.valid)
            assert valid.all()
            for kp_x, d_x in ((kp_b, d_b), (kp_c, d_c)):
                np.testing.assert_array_equal(
                    np.asarray(kp_x.valid[i]), valid
                )
                np.testing.assert_array_equal(
                    np.asarray(kp_x.angle[i]), np.asarray(kp_1.angle)
                )
                np.testing.assert_array_equal(
                    np.asarray(d_x[i]), np.asarray(d_1)
                )


class TestBorderAwareCompaction:
    """Capacity budget counts DESCRIBABLE keypoints only: valid
    keypoints outside the pattern border (which describe invalidates
    regardless) must not consume compaction slots. Regression for the
    silent whole-frame drop when capacity covered the describable
    population but compaction still spent slots on border rejects
    (bench keypoints/frame min=0, 2026-08-20)."""

    def test_capacity_counts_describable_only(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.core.keypoints import KeyPoints
        from ethzasl_brisk_jax.describe.extractor import (
            BriskExtractor,
            extract_descriptors_batch,
            extract_descriptors_compact,
        )
        from scipy import ndimage

        rng = np.random.default_rng(7)
        b, k = 3, 48
        base = rng.integers(0, 256, (b, 120, 160)).astype(np.float32)
        imgs = np.clip(
            ndimage.convolve(base, np.ones((1, 5, 5)) / 25.0,
                             mode="nearest"), 0, 255
        ).astype(np.uint8)
        # Half the keypoints sit INSIDE the border margin, half within
        # a few px of the edge (outside the ~23 px pattern border for
        # size 12): all are detect-valid, only the inner ones are
        # describable.
        x = np.where(
            np.arange(k)[None, :] % 2 == 0,
            rng.uniform(30, 130, (b, k)),
            rng.uniform(1, 8, (b, k)),
        ).astype(np.float32)
        y = rng.uniform(30, 90, (b, k)).astype(np.float32)
        kps = KeyPoints(
            x=jnp.asarray(x), y=jnp.asarray(y),
            size=jnp.full((b, k), 12.0, jnp.float32),
            angle=jnp.full((b, k), -1.0, jnp.float32),
            response=jnp.asarray(
                rng.uniform(1, 9, (b, k)).astype(np.float32)
            ),
            octave=jnp.zeros((b, k), jnp.int32),
            valid=jnp.ones((b, k), bool),
        )
        ext = BriskExtractor()
        pat = ext.pattern
        ref_kp, ref_desc = extract_descriptors_batch(
            pat, jnp.asarray(imgs), kps, skip_small=ext.skip_small
        )
        n_desc = int(np.asarray(ref_kp.valid).sum())
        assert 0 < n_desc < b * k // 2 + b  # border half rejected
        # Capacity = exactly the describable count: every described
        # keypoint must survive even though detect-valid count (b*k)
        # far exceeds it.
        got_kp, got_desc = extract_descriptors_compact(
            pat, jnp.asarray(imgs), kps, capacity=n_desc,
            skip_small=ext.skip_small,
        )
        np.testing.assert_array_equal(
            np.asarray(got_kp.valid), np.asarray(ref_kp.valid)
        )
        m = np.asarray(ref_kp.valid)
        np.testing.assert_array_equal(
            np.asarray(got_desc)[m], np.asarray(ref_desc)[m]
        )
