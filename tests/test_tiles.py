"""Tile-sharded detection == dense detection, bitwise.

SURVEY.md section 5's spatial-sharding analog: one frame row-sharded
over the 8-device virtual mesh with halo exchange must reproduce the
single-device ``detect_keypoints`` output exactly (the project's
golden-file discipline applied to sharding).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from ethzasl_brisk_jax.detect.scale_space import (  # noqa: E402
    DetectorConfig,
    detect_keypoints,
)
from ethzasl_brisk_jax.parallel.tiles import detect_keypoints_tiled


def _mesh(n):
    devs = jax.devices()
    if len(devs) < n:
        pytest.skip(f"need {n} devices")
    return Mesh(np.asarray(devs[:n]), axis_names=("data",))


def _smooth_frame(h, w, seed):
    from scipy import ndimage

    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w)).astype(np.float32)
    sm = ndimage.convolve(base, np.ones((5, 5)) / 25.0, mode="nearest")
    return np.clip(sm, 0, 255).astype(np.uint8)


def _assert_kps_equal(a, b):
    av = np.asarray(a.valid)
    bv = np.asarray(b.valid)
    assert np.array_equal(av, bv)
    for f in ("x", "y", "size", "angle", "response", "octave"):
        fa = np.asarray(getattr(a, f))[av]
        fb = np.asarray(getattr(b, f))[bv]
        assert np.array_equal(fa, fb), f"field {f}"


@pytest.mark.slow
@pytest.mark.parametrize("uradius", [0.0, 30.0])
def test_tiled_equals_dense(uradius):
    mesh = _mesh(8)
    # 240x384: largest shape whose layer heights all divide 8 tiles that
    # keeps the two shard_map compiles CI-affordable (480x640 costs ~4
    # min per config on the virtual mesh).
    img = jnp.asarray(_smooth_frame(240, 384, 3))
    cfg = DetectorConfig(
        octaves=2,
        uniformity_radius=uradius,
        absolute_threshold=20.0,
        max_candidates=2048,
        max_keypoints=512,
        max_num_kpt=512,
    )
    dense = jax.jit(lambda im: detect_keypoints(im, cfg))(img)
    tiled = detect_keypoints_tiled(img, cfg, mesh, axis="data")
    _assert_kps_equal(dense, tiled)
    assert int(np.asarray(dense.valid).sum()) > 100


@pytest.mark.slow
def test_tiled_uint16_equals_dense():
    """The 16-bit pipeline (float Harris scores, the reference's
    16-bit samplers — image-down-sampling.cc:56,394) tile-sharded vs
    dense (r4 verdict: the tiled path guarded to uint8).

    DECISIONS (valid/octave/size — the detection set) must be bitwise;
    x/y/response carry f32 Harris scores whose last ULP legally
    differs between the shard_map manual region and a plain jit
    (XLA:CPU fusion-context FMA contraction — the same artifact the
    module docs record for the refine chain; the integer uint8 path is
    exempt because its scores are exact int32)."""
    mesh = _mesh(8)
    img8 = _smooth_frame(240, 384, 5)
    img = jnp.asarray(img8.astype(np.uint16) * 257)
    cfg = DetectorConfig(
        octaves=2,
        uniformity_radius=30.0,
        absolute_threshold=20.0,
        max_candidates=2048,
        max_keypoints=512,
        max_num_kpt=512,
    )
    dense = jax.jit(lambda im: detect_keypoints(im, cfg))(img)
    tiled = detect_keypoints_tiled(img, cfg, mesh, axis="data")
    av = np.asarray(dense.valid)
    bv = np.asarray(tiled.valid)
    assert np.array_equal(av, bv)
    for f in ("size", "angle", "octave"):
        np.testing.assert_array_equal(
            np.asarray(getattr(dense, f))[av],
            np.asarray(getattr(tiled, f))[bv],
        )
    for f in ("x", "y", "response"):
        a = np.asarray(getattr(dense, f))[av]
        b = np.asarray(getattr(tiled, f))[bv]
        assert float(np.mean(a == b)) > 0.5, f  # mostly bitwise
        np.testing.assert_allclose(a, b, rtol=1e-5)
    assert int(av.sum()) > 50


@pytest.mark.slow
def test_tiled_four_devices():
    mesh = _mesh(4)
    img = jnp.asarray(_smooth_frame(240, 400, 9))
    cfg = DetectorConfig(
        octaves=1,
        uniformity_radius=0.0,
        absolute_threshold=30.0,
        max_candidates=1024,
        max_keypoints=256,
        max_num_kpt=256,
    )
    dense = jax.jit(lambda im: detect_keypoints(im, cfg))(img)
    tiled = detect_keypoints_tiled(img, cfg, mesh, axis="data")
    _assert_kps_equal(dense, tiled)


def test_tiled_rejects_misaligned():
    mesh = _mesh(8)
    img = jnp.zeros((484, 640), jnp.uint8)
    with pytest.raises(ValueError):
        detect_keypoints_tiled(img, DetectorConfig(octaves=2), mesh)


def test_tiled_rejects_thin_tiles():
    """Tile heights below IMG_HALO would silently truncate the ppermute
    halo (found by review: 192x384 octaves=3 passed the divisibility
    checks but corrupted layer 5) — must refuse."""
    mesh = _mesh(8)
    img = jnp.zeros((192, 384), jnp.uint8)
    with pytest.raises(ValueError, match="IMG_HALO"):
        detect_keypoints_tiled(img, DetectorConfig(octaves=3), mesh)
