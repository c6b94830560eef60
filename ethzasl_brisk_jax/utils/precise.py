"""Full-precision f32 products for the geometry (BA, RANSAC, VO).

On a GPU, XLA may run an f32 dot in TF32, which keeps about three
decimal digits, unless the call asks for more. Every product that decides
a geometric result goes through these wrappers, so the CPU and the GPU
solve the same problem.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST


def einsum(subscripts: str, *operands) -> jax.Array:
    return jnp.einsum(subscripts, *operands, precision=HIGHEST)


def matmul(a, b) -> jax.Array:
    return jnp.matmul(a, b, precision=HIGHEST)
