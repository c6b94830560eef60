"""Fixed-capacity keypoint struct-of-arrays.

The reference passes ``std::vector<cv::KeyPoint>`` (ragged, pointer-chasing;
accessors at ``agast/include/agast/wrap-opencv.h:63-98``). The dense
equivalent is a statically-shaped struct-of-arrays with a validity mask so
every downstream stage (description, matching, geometry) stays jit-compatible
and batchable with ``jax.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def take_packed(arrays, idx):
    """Gather the same indices from many equal-length 1-D arrays with
    ONE gather op.

    Bitcasts each f32/i32/bool array to int32 lanes, stacks them into
    a (len, N) matrix, performs a single row gather, and unpacks —
    bit-exact for every supported dtype (f32 roundtrips through int32
    bitcast; bool through widening). Kept for the single-gather
    structure, not as a perf claim.
    """
    cols = []
    kinds = []
    for a in arrays:
        if a.dtype == jnp.float32:
            cols.append(jax.lax.bitcast_convert_type(a, jnp.int32))
            kinds.append("f32")
        elif a.dtype == jnp.int32:
            cols.append(a)
            kinds.append("i32")
        elif a.dtype == jnp.bool_:
            cols.append(a.astype(jnp.int32))
            kinds.append("bool")
        else:
            raise TypeError(f"take_packed: unsupported dtype {a.dtype}")
    packed = jnp.stack(cols, axis=-1)          # (len, N)
    taken = jnp.take(packed, idx, axis=0)      # (k, N) one gather
    out = []
    for j, kind in enumerate(kinds):
        c = taken[:, j]
        if kind == "f32":
            out.append(jax.lax.bitcast_convert_type(c, jnp.float32))
        elif kind == "bool":
            out.append(c.astype(jnp.bool_))
        else:
            out.append(c)
    return tuple(out)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KeyPoints:
    """A fixed-capacity set of keypoints.

    All fields have leading shape ``(capacity,)`` (or ``(batch, capacity)``
    under vmap). Invalid slots are masked out by ``valid``.

    Fields mirror cv::KeyPoint: x, y (pixel coords), size (diameter),
    angle (degrees, -1 = unset), response (detector score), octave.
    """

    x: jax.Array         # f32
    y: jax.Array         # f32
    size: jax.Array      # f32
    angle: jax.Array     # f32, degrees, -1 == unset
    response: jax.Array  # f32
    octave: jax.Array    # i32
    valid: jax.Array     # bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    def count(self) -> jax.Array:
        return jnp.sum(self.valid.astype(jnp.int32), axis=-1)

    @staticmethod
    def empty(capacity: int) -> "KeyPoints":
        z = jnp.zeros((capacity,), jnp.float32)
        return KeyPoints(
            x=z,
            y=z,
            size=z,
            angle=jnp.full((capacity,), -1.0, jnp.float32),
            response=z,
            octave=jnp.zeros((capacity,), jnp.int32),
            valid=jnp.zeros((capacity,), bool),
        )

    @staticmethod
    def concatenate(parts: list["KeyPoints"]) -> "KeyPoints":
        return KeyPoints(
            *(
                jnp.concatenate([getattr(p, f.name) for p in parts], axis=-1)
                for f in dataclasses.fields(KeyPoints)
            )
        )

    def _take_all(self, idx) -> "KeyPoints":
        """Gather all 7 fields at ``idx`` with one packed gather op
        (1-D/unbatched only — vmap supplies the batched case)."""
        if self.x.ndim == 1:
            return KeyPoints(*take_packed(
                [getattr(self, f.name)
                 for f in dataclasses.fields(KeyPoints)], idx,
            ))
        return jax.tree.map(lambda a: jnp.take(a, idx, axis=-1), self)

    def compact(self) -> "KeyPoints":
        """Move valid keypoints to the front (stable), keeping capacity."""
        order = jnp.argsort(~self.valid, stable=True)
        return self._take_all(order)

    def top_k(self, k: int) -> "KeyPoints":
        """Keep the k highest-response valid keypoints (capacity -> k)."""
        score = jnp.where(self.valid, self.response, -jnp.inf)
        _, idx = jax.lax.top_k(score, k)
        return self._take_all(idx)

    def to_numpy(self) -> dict:
        """Host-side dict of numpy arrays with only the valid entries."""
        host = jax.tree.map(np.asarray, self)
        mask = host.valid
        return {
            f.name: getattr(host, f.name)[mask]
            for f in dataclasses.fields(KeyPoints)
            if f.name != "valid"
        }

    @staticmethod
    def from_numpy(
        x,
        y,
        size=None,
        angle=None,
        response=None,
        octave=None,
        capacity: Optional[int] = None,
    ) -> "KeyPoints":
        """Build padded KeyPoints from host arrays of n valid points."""
        x = np.asarray(x, np.float32)
        n = x.shape[0]
        cap = capacity or n

        def pad(a, fill, dtype):
            a = (
                np.full((n,), fill, dtype)
                if a is None
                else np.asarray(a, dtype)
            )
            out = np.full((cap,), fill, dtype)
            out[:n] = a[:cap]
            return jnp.asarray(out)

        return KeyPoints(
            x=pad(x, 0.0, np.float32),
            y=pad(y, 0.0, np.float32),
            size=pad(size, 12.0, np.float32),
            angle=pad(angle, -1.0, np.float32),
            response=pad(response, 0.0, np.float32),
            octave=pad(octave, 0, np.int32),
            valid=jnp.asarray(np.arange(cap) < n),
        )
