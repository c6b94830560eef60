"""BRISK v1 legacy engine (brisk-v1.cc) — structural tests.

No golden sets ship upstream for v1 (test-binary-equal.cc covers only
the v2 pipelines), so these tests validate structure and the documented
v1-vs-v2 semantic differences: no adaptive threshold map
(brisk-v1.cc:1685-1696), no scale-axis weak/edge gates (:1012-1110),
drop threshold = center (:1113+), same pyramid geometry (:577-593) and
the v1 ring pattern descriptor.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_jax.detect.ast_scale_space import (  # noqa: E402
    detect_ast_keypoints,
)
from ethzasl_brisk_jax.pipeline import BriskFeatureDetector  # noqa: E402

from .conftest import TEST_DATA  # noqa: E402


@pytest.fixture(scope="module")
def image():
    from ethzasl_brisk_jax.core.image_io import read_pgm

    p = TEST_DATA / "img1.pgm"
    if not p.exists():
        pytest.skip("reference test data unavailable")
    # Central crop keeps the per-test compile+run cost CI-affordable
    # while preserving natural-image statistics.
    return jnp.asarray(read_pgm(str(p)))[100:436, 150:598]


@pytest.fixture(scope="module")
def v1_kps(image):
    return detect_ast_keypoints(image, threshold=70, octaves=3, v1=True)


def test_v1_detect_structure(image, v1_kps):
    kps = v1_kps
    m = np.asarray(kps.valid)
    assert m.sum() > 100
    size = np.asarray(kps.size)[m]
    resp = np.asarray(kps.response)[m]
    x = np.asarray(kps.x)[m]
    y = np.asarray(kps.y)[m]
    h, w = image.shape
    assert (size >= 0.7 * 12.0).all() and (size <= 6 * 1.5 * 12.0).all()
    assert (resp > 0).all()
    assert (x >= 0).all() and (x < w).all()
    assert (y >= 0).all() and (y < h).all()


def test_v1_supersets_v2_accepts(image, v1_kps):
    """v1 drops the weak/edge discard gates and the adaptive threshold
    map raises effective thresholds on low-contrast regions — v1 finds
    strictly more keypoints at the same nominal threshold."""
    k2 = detect_ast_keypoints(image, threshold=70, octaves=3)
    assert (
        int(np.asarray(v1_kps.valid).sum())
        > int(np.asarray(k2.valid).sum())
    )


@pytest.mark.slow
def test_v1_facade_end_to_end(image):
    det = BriskFeatureDetector(threshold=70, octaves=3, version="v1")
    kps, desc = det.detect_and_compute(image)
    m = np.asarray(kps.valid)
    assert m.sum() > 100
    d = np.asarray(desc)[m].view(np.uint8)
    # v1 ring pattern produces non-degenerate descriptors.
    bits = np.unpackbits(d, axis=1)
    pop = bits.sum(axis=1)
    # Non-degenerate: most descriptors have a real mix of 0/1 bits.
    frac = pop / bits.shape[1]
    assert ((frac > 0.05) & (frac < 0.95)).mean() > 0.9
    assert np.unique(d, axis=0).shape[0] > 0.5 * m.sum()


def test_v1_determinism(image, v1_kps):
    b = detect_ast_keypoints(image, threshold=70, octaves=3, v1=True)
    for f in ("x", "y", "size", "response", "valid"):
        assert np.array_equal(np.asarray(getattr(v1_kps, f)),
                              np.asarray(getattr(b, f)))


class TestPatternGoldens:
    """Pattern tables vs the COMPILED reference's generated tables
    (tools/refbuild `v1pattern`/`v2pattern` dumps; rot slices checked in
    as tests/fixtures/{v1,v2}_pattern_slices.npz). The full 64x1024xP
    tables were verified bit-exact offline; CI pins 6 rotations.

    Note the translation-unit asymmetry these encode: brisk-v1.cc
    resolves log/atan2 to the <cmath> FLOAT overloads (logf scale list,
    atan2f angle) while brisk-descriptor-extractor.cc promotes the same
    spellings to double — each verified against its own dump."""

    @pytest.mark.parametrize("version", ["v1", "v2"])
    def test_pattern_matches_compiled_reference(self, version):
        import pathlib

        from ethzasl_brisk_jax.core.pattern import (
            brisk_v1_pattern,
            brisk_v2_pattern,
        )

        fix = np.load(
            pathlib.Path(__file__).parent / "fixtures" /
            f"{version}_pattern_slices.npz"
        )
        p = (brisk_v1_pattern if version == "v1" else brisk_v2_pattern)(1.0)
        np.testing.assert_array_equal(p.scale_list, fix["scale_list"])
        np.testing.assert_array_equal(
            p.size_list, fix["size_list"].astype(p.size_list.dtype)
        )
        rots = fix["rots"]
        pts = fix["points"]  # (64, len(rots), P, 3)
        np.testing.assert_array_equal(p.lut_x[:, rots], pts[..., 0])
        np.testing.assert_array_equal(p.lut_y[:, rots], pts[..., 1])
        np.testing.assert_array_equal(p.lut_sigma, pts[:, 0, :, 2])
        np.testing.assert_array_equal(
            p.short_pairs, fix["short_pairs"].astype(p.short_pairs.dtype)
        )
        np.testing.assert_array_equal(
            p.long_pairs, fix["long_pairs"][:, :2]
        )
        np.testing.assert_array_equal(
            p.long_weights, fix["long_pairs"][:, 2:]
        )


class TestV1Resamplers:
    """v1 legacy downsamplers vs exact scalar emulations of the SSE code
    (brisk-v1.cc:1847-2072), including the avg_epu8 double rounding, the
    byte-12 two-thirds shuffle quirk, and the truncating tails. The full
    pyramid was verified bit-exact against the compiled reference
    (tools/refbuild `v1layers`); CI pins odd-size crops."""

    @staticmethod
    def _twothirds_scalar(src):
        H, W = src.shape
        dst = np.zeros((2 * (H // 3), 2 * (W // 3)), np.uint8)
        hsize, leftover = W // 15, ((W // 3) * 3) % 15
        T2 = [0, 2, 3, 5, 6, 8, 9, 11, 12, 14]
        T1 = [1, 1, 4, 4, 7, 7, 10, 10, 12, 12]
        s = src.astype(np.int64)

        def avg(a, b):
            return (a + b + 1) >> 1

        k = 0
        while 3 * k + 2 < H:
            A, B, C = s[3 * k], s[3 * k + 1], s[3 * k + 2]
            up, lo = avg(avg(A, B), A), avg(avg(C, B), C)
            for i in range(hsize):
                for ro, v in ((2 * k, up), (2 * k + 1, lo)):
                    t2 = v[15 * i + np.array(T2)]
                    t1 = v[15 * i + np.array(T1)]
                    dst[ro, 10 * i:10 * i + 10] = avg(avg(t2, t1), t2)
            c0, d0 = 15 * hsize, 10 * hsize
            for j in range(0, leftover, 3):
                a1, a2, a3 = A[c0 + j:c0 + j + 3]
                b1, b2, b3 = B[c0 + j:c0 + j + 3]
                c1, c2, c3 = C[c0 + j:c0 + j + 3]
                dst[2 * k, d0 + 2 * (j // 3)] = (4 * a1 + 2 * (a2 + b1) + b2) // 9
                dst[2 * k, d0 + 2 * (j // 3) + 1] = (4 * a3 + 2 * (a2 + b3) + b2) // 9
                dst[2 * k + 1, d0 + 2 * (j // 3)] = (4 * c1 + 2 * (c2 + b1) + b2) // 9
                dst[2 * k + 1, d0 + 2 * (j // 3) + 1] = (4 * c3 + 2 * (c2 + b3) + b2) // 9
            k += 1
        return dst

    @staticmethod
    def _half_scalar(src):
        H, W = src.shape
        dh = H // 2
        dst = np.zeros((dh, W // 2), np.uint8)
        hsize = W // 16
        end, half_end, leftover = hsize // 2, hsize % 2 == 1, (W % 16) // 2
        s = src.astype(np.int64)
        for r in range(dh):
            a, b = s[2 * r], s[2 * r + 1]
            v = (a + b + 1) >> 1
            for i in range(end):
                blk = v[32 * i:32 * i + 32]
                dst[r, 16 * i:16 * i + 16] = (blk[0::2] + blk[1::2] + 1) >> 1
            d, c = 16 * end, 32 * end
            if half_end:
                blk = v[c:c + 16]
                dst[r, d:d + 8] = (blk[0::2] + blk[1::2]) // 2
                d, c = d + 8, c + 16
            for kk in range(leftover):
                dst[r, d + kk] = (a[c + kk] + a[c + kk + 1]
                                  + b[c + kk] + b[c + kk + 1]) // 4
        return dst

    @pytest.mark.parametrize("shape", [(96, 160), (63, 106), (70, 133)])
    def test_v1_resamplers_match_scalar(self, shape):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.kernels.downsample import (
            halfsample8_v1,
            twothirdsample8_v1,
        )

        rng = np.random.default_rng(sum(shape))
        src = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(
            np.asarray(twothirdsample8_v1(jnp.asarray(src))),
            self._twothirds_scalar(src),
        )
        np.testing.assert_array_equal(
            np.asarray(halfsample8_v1(jnp.asarray(src))),
            self._half_scalar(src),
        )
