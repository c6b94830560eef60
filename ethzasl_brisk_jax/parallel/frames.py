"""Multi-chip frame pipeline: data-parallel detection + sharded matching.

The reference is single-threaded per image (``brisk-feature.h:75-94``); its
unit of work is one frame. The scale-out design here treats a *batch of
frames* as the unit:

* ``data`` mesh axis — frames are sharded across chips; each chip runs the
  dense detect+describe pipeline on its local frames (``jax.vmap`` inside
  ``shard_map``). No cross-chip traffic in this phase.
* ``model`` mesh axis — the matching distance matrix (Q x T) is sharded over
  the *train* descriptor axis. Each chip computes its local distance tile
  (a matmul, see ``match/matcher.py``) and local top-k; the global
  argmin is a tree-reduction across devices via ``jax.lax`` collectives
  (``all_gather`` of the tiny per-shard candidate lists, not of the raw
  distance tiles — communication is O(Q*k), not O(Q*T)).

This mirrors how the north star scales: frames ~ data parallelism, the
match/BA problem ~ model parallelism over map blocks.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ethzasl_brisk_jax.match.matcher import hamming_distance_matrix
from ethzasl_brisk_jax.pipeline import BriskFeature


def make_mesh(
    n_data: int, n_model: int = 1, devices=None
) -> Mesh:
    """A (data, model) device mesh; data scales frames, model scales match/BA."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_data * n_model]).reshape(
        n_data, n_model
    )
    return Mesh(devices, axis_names=("data", "model"))


@partial(jax.jit, static_argnames=("mesh", "k", "n_bits"))
def sharded_knn_match(
    mesh: Mesh,
    query: jnp.ndarray,       # (Q, W) uint32, replicated
    train: jnp.ndarray,       # (T, W) uint32, sharded over 'model'
    train_valid: jnp.ndarray,  # (T,) bool
    k: int = 2,
    n_bits: int = 384,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """knn over a train set sharded across the 'model' axis.

    Each shard computes its local (Q, T/m) distance tile and local top-k;
    shards exchange only (Q, k) candidates; the global top-k is
    recomputed from the gathered candidates. Exact — Hamming distances are
    integers, ties resolve to the lowest global index like the reference's
    row-scan (brute-force-matcher.cc:138-157).
    """
    sentinel = n_bits + 1
    n_model = mesh.shape["model"]
    t_local = train.shape[0] // n_model

    def local_fn(q, t, tv):
        d = hamming_distance_matrix(q, t, n_bits)
        d = jnp.where(tv[None, :], d, sentinel)
        neg, idx = jax.lax.top_k(-d, min(k, t_local))
        shard = jax.lax.axis_index("model")
        gidx = idx + shard * t_local
        # Gather the tiny candidate lists from every shard.
        all_neg = jax.lax.all_gather(neg, "model", axis=1, tiled=True)
        all_idx = jax.lax.all_gather(gidx, "model", axis=1, tiled=True)
        # Global exact top-k; break distance ties toward the lowest index.
        order = jnp.lexsort((all_idx, -all_neg), axis=1)[:, :k]
        best_idx = jnp.take_along_axis(all_idx, order, axis=1)
        best_d = -jnp.take_along_axis(all_neg, order, axis=1)
        return best_idx.astype(jnp.int32), best_d.astype(jnp.int32)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P("model", None), P("model")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(query, train, train_valid)


@dataclasses.dataclass(frozen=True)
class FramePipeline:
    """Batched, mesh-sharded detect+describe+match step.

    ``step(frames)`` detects and describes every frame (sharded over the
    'data' axis) and matches each frame against the previous one in the
    batch — the building block of the VO front-end and of the throughput
    benchmark.
    """

    feature: BriskFeature
    mesh: Mesh

    def step(self, frames: jnp.ndarray):
        """frames: (B, H, W) uint8, B divisible by the 'data' axis size.

        Returns (keypoints (B,...), descriptors (B, K, W) uint32,
        match_idx (B-1, K) int32, match_dist (B-1, K) int32).

        The pattern tables are threaded in as runtime arguments, not
        captured as jit closure constants (DevicePattern docs).
        """
        return _pipeline_step(
            self.feature.extractor.pattern, frames, self.feature, self.mesh
        )

    def jit_step(self):
        return self.step


@dataclasses.dataclass(frozen=True)
class AstFramePipeline:
    """Batched classic-BRISK (AGAST/OAST) detect+describe+match step.

    The AST analog of :class:`FramePipeline`: data-parallel
    ``BriskFeatureDetector`` detection (brisk-scale-space.cc:92-287
    semantics, emulated lazy-score cache) + one flat batched describe +
    per-pair matching. Used by ``bench.py`` BENCH_PIPELINE=ast.
    """

    detector: "object"  # pipeline.BriskFeatureDetector (frozen, hashable)
    mesh: Mesh
    # Valid-compaction describe budget per frame (0 = describe every
    # slot): the sampler's cost is per slot, and most of the 1024
    # keypoint slots of a frame are empty.
    describe_capacity: int = 640

    def step(self, frames: jnp.ndarray):
        return _ast_pipeline_step(
            self.detector.extractor.pattern, frames, self.detector,
            self.mesh, self.describe_capacity,
        )


@partial(
    jax.jit,
    static_argnames=("detector", "mesh", "describe_capacity"),
)
def _ast_pipeline_step(
    pattern, frames, detector, mesh: Mesh, describe_capacity=0,
):
    from ethzasl_brisk_jax.describe.extractor import (
        extract_descriptors_batch,
        extract_descriptors_compact,
    )

    frames = jax.lax.with_sharding_constraint(
        frames, NamedSharding(mesh, P("data", None, None))
    )
    det = jax.vmap(detector.detect)(frames)
    kw = dict(
        rotation_invariant=detector.rotation_invariant,
        scale_invariant=detector.scale_invariant,
        skip_small=detector.extractor.skip_small,
    )
    if describe_capacity:
        kps, desc = extract_descriptors_compact(
            pattern, frames, det,
            capacity=describe_capacity * frames.shape[0], **kw
        )
    else:
        kps, desc = extract_descriptors_batch(pattern, frames, det, **kw)
    desc = jax.lax.with_sharding_constraint(
        desc, NamedSharding(mesh, P("data", None, None))
    )
    midx, mdist = _match_adjacent(kps, desc)
    return kps, desc, midx, mdist


def _match_adjacent(kps, desc):
    q, t = desc[1:], desc[:-1]
    qv, tv = kps.valid[1:], kps.valid[:-1]

    def match_pair(qd, td, qvd, tvd):
        n_bits = qd.shape[-1] * 32
        d = hamming_distance_matrix(qd, td, n_bits)
        sentinel = n_bits + 1
        d = jnp.where(tvd[None, :], d, sentinel)
        best = jnp.argmin(d, axis=1).astype(jnp.int32)
        bd = jnp.min(d, axis=1)
        bd = jnp.where(qvd, bd, sentinel)
        return best, bd

    return jax.vmap(match_pair)(q, t, qv, tv)


@partial(jax.jit, static_argnames=("feature", "mesh"))
def _pipeline_step(pattern, frames, feature: BriskFeature, mesh: Mesh):
    from ethzasl_brisk_jax.describe.extractor import (
        extract_descriptors_batch,
    )

    frames = jax.lax.with_sharding_constraint(
        frames, NamedSharding(mesh, P("data", None, None))
    )

    det = jax.vmap(feature.detect)(frames)
    # One flat describe call over all frames' keypoints
    # (extract_descriptors_batch docs).
    if feature.describe_capacity:
        from ethzasl_brisk_jax.describe.extractor import (
            extract_descriptors_compact,
        )

        kps, desc = extract_descriptors_compact(
            pattern, frames, det,
            capacity=feature.describe_capacity * frames.shape[0],
            rotation_invariant=feature.rotation_invariant,
            scale_invariant=feature.scale_invariant,
            skip_small=feature.extractor.skip_small,
        )
    else:
        kps, desc = extract_descriptors_batch(
            pattern, frames, det,
            rotation_invariant=feature.rotation_invariant,
            scale_invariant=feature.scale_invariant,
            skip_small=feature.extractor.skip_small,
        )
    desc = jax.lax.with_sharding_constraint(
        desc, NamedSharding(mesh, P("data", None, None))
    )
    q, t = desc[1:], desc[:-1]
    qv, tv = kps.valid[1:], kps.valid[:-1]

    def match_pair(qd, td, qvd, tvd):
        d = hamming_distance_matrix(qd, td)
        sentinel = 384 + 1
        d = jnp.where(tvd[None, :], d, sentinel)
        best = jnp.argmin(d, axis=1).astype(jnp.int32)
        bd = jnp.min(d, axis=1)
        bd = jnp.where(qvd, bd, sentinel)
        return best, bd

    midx, mdist = jax.vmap(match_pair)(q, t, qv, tv)
    return kps, desc, midx, mdist
