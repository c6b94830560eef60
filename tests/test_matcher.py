"""Matcher completeness tests: train-image collections with imgIdx
(commonKnnMatchImpl, brute-force-matcher.cc:95-161), per-image masks, and
radius-match overflow surfacing (commonRadiusMatchImpl, :164-214).

Scalar references emulate the C++ scan order exactly: for each of k
rounds, scan train images in add() order, rows in order, keep the first
strict minimum (minMaxLoc semantics), emit, invalidate.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.quick

RNG = np.random.default_rng(7)


def _rand_desc(n, words=12):
    return RNG.integers(0, 2**32, (n, words), dtype=np.uint32)


def _hamming(q, t):
    qb = np.unpackbits(q.view(np.uint8), axis=1)
    tb = np.unpackbits(t.view(np.uint8), axis=1)
    return (qb[:, None, :] != tb[None, :, :]).sum(-1).astype(np.int32)


def _scalar_knn_collection(query, trains, masks, k):
    """Emulates commonKnnMatchImpl: k rounds of global min over all train
    images (image-major scan, first strict min wins), invalidate, emit."""
    q_n = query.shape[0]
    dists = [_hamming(query, t).astype(np.float64) for t in trains]
    if masks is not None:
        for d, m in zip(dists, masks):
            d[~m] = np.inf
    out_img = -np.ones((q_n, k), np.int32)
    out_train = -np.ones((q_n, k), np.int32)
    out_dist = np.full((q_n, k), 385, np.int32)
    for qi in range(q_n):
        for r in range(k):
            best = (np.inf, -1, -1)
            for ii, d in enumerate(dists):
                if d.shape[1] == 0:
                    continue
                ti = int(np.argmin(d[qi]))
                if d[qi, ti] < best[0]:
                    best = (d[qi, ti], ii, ti)
            if not np.isfinite(best[0]):
                break
            out_img[qi, r] = best[1]
            out_train[qi, r] = best[2]
            out_dist[qi, r] = int(best[0])
            dists[best[1]][qi, best[2]] = np.inf
    return out_img, out_train, out_dist


class TestCollectionMatch:
    def test_knn_collection_matches_scalar(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.match.matcher import (
            DescriptorCollection,
            knn_match_collection,
        )

        query = _rand_desc(17)
        trains = [_rand_desc(9), _rand_desc(5), _rand_desc(13)]
        coll = DescriptorCollection()
        for t in trains:
            coll.add(jnp.asarray(t))
        gi, gt, gd = knn_match_collection(jnp.asarray(query), coll, k=3)
        wi, wt, wd = _scalar_knn_collection(query, trains, None, k=3)
        np.testing.assert_array_equal(np.asarray(gd), wd)
        np.testing.assert_array_equal(np.asarray(gi), wi)
        np.testing.assert_array_equal(np.asarray(gt), wt)

    def test_knn_collection_with_masks(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.match.matcher import (
            DescriptorCollection,
            knn_match_collection,
        )

        query = _rand_desc(11)
        trains = [_rand_desc(6), _rand_desc(8)]
        masks = [RNG.random((11, t.shape[0])) > 0.3 for t in trains]
        coll = DescriptorCollection(trains=[jnp.asarray(t) for t in trains])
        gi, gt, gd = knn_match_collection(
            jnp.asarray(query), coll,
            masks=[jnp.asarray(m) for m in masks], k=2,
        )
        wi, wt, wd = _scalar_knn_collection(query, trains, masks, k=2)
        np.testing.assert_array_equal(np.asarray(gd), wd)
        np.testing.assert_array_equal(np.asarray(gi), wi)
        np.testing.assert_array_equal(np.asarray(gt), wt)

    def test_radius_collection_counts_and_imgidx(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.match.matcher import (
            DescriptorCollection,
            radius_match_collection,
        )

        query = _rand_desc(7)
        trains = [_rand_desc(10), _rand_desc(4)]
        coll = DescriptorCollection(trains=[jnp.asarray(t) for t in trains])
        radius = 200
        gi, gt, gd, gc = radius_match_collection(
            jnp.asarray(query), coll, radius, max_matches=14,
        )
        d = np.concatenate([_hamming(query, t) for t in trains], axis=1)
        want_counts = (d < radius).sum(1)
        np.testing.assert_array_equal(np.asarray(gc), want_counts)
        img_of = np.repeat([0, 1], [10, 4])
        for qi in range(7):
            got = np.asarray(gd[qi])
            sel = got < 385
            want = np.sort(d[qi][d[qi] < radius])
            np.testing.assert_array_equal(np.sort(got[sel]), want)
            for s in np.flatnonzero(sel):
                ii, ti = int(gi[qi, s]), int(gt[qi, s])
                assert ii == img_of[ti + (10 if ii == 1 else 0)]
                assert int(gd[qi, s]) == d[qi, ti + (10 if ii == 1 else 0)]


class TestRadiusOverflow:
    def test_true_counts_signal_truncation(self):
        """counts must report the TRUE in-radius population even when it
        exceeds the static capacity (no silent truncation)."""
        import jax.numpy as jnp

        from ethzasl_brisk_jax.match.matcher import radius_match_all

        # All-zero descriptors: every distance is 0 -> everything matches.
        q = np.zeros((3, 12), np.uint32)
        t = np.zeros((50, 12), np.uint32)
        idx, dist, counts = radius_match_all(
            jnp.asarray(q), jnp.asarray(t),
            jnp.ones(3, bool), jnp.ones(50, bool),
            radius=10, max_matches=8,
        )
        np.testing.assert_array_equal(np.asarray(counts), [50, 50, 50])
        assert np.asarray(dist).shape == (3, 8)
        assert (np.asarray(dist) == 0).all()

    def test_counts_respect_validity(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.match.matcher import radius_match_all

        q = _rand_desc(5)
        t = _rand_desc(20)
        tv = np.zeros(20, bool)
        tv[:7] = True
        qv = np.array([True, True, False, True, True])
        idx, dist, counts = radius_match_all(
            jnp.asarray(q), jnp.asarray(t),
            jnp.asarray(qv), jnp.asarray(tv),
            radius=210, max_matches=20,
        )
        d = _hamming(q, t)
        want = ((d < 210) & tv[None, :]).sum(1)
        want[~qv] = 0
        np.testing.assert_array_equal(np.asarray(counts), want)
