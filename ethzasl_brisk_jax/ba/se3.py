"""Batched SO(3)/SE(3) Lie-group operations.

New scope beyond the reference (the BA/pose-graph layers of the north
star; SURVEY.md section 2.5). All functions are batched jnp ops over
leading axes and are jit/grad-compatible; small-angle branches use
series expansions selected with ``jnp.where`` so gradients stay finite.

Conventions: rotations as 3x3 matrices; twists xi = (omega, v) with the
rotation block first; transforms as (R, t) pairs acting as x -> R x + t.
"""
from __future__ import annotations

import jax.numpy as jnp

from ethzasl_brisk_jax.utils.precise import einsum, matmul

_EPS = 1e-8


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric."""
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -w[..., 2], w[..., 1]], -1),
            jnp.stack([w[..., 2], zeros, -w[..., 0]], -1),
            jnp.stack([-w[..., 1], w[..., 0], zeros], -1),
        ],
        -2,
    )


def so3_exp(w):
    """Rodrigues: (..., 3) -> (..., 3, 3)."""
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2
    )
    wx = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), wx.shape)
    return eye + a[..., None, None] * wx + b[..., None, None] * matmul(wx, wx)


def so3_log(r):
    """(..., 3, 3) -> (..., 3)."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos_t)
    sin_t = jnp.sin(theta)
    small = jnp.abs(sin_t) < _EPS
    scale = jnp.where(
        small, 0.5 + theta * theta / 12.0, theta / (2.0 * jnp.maximum(sin_t, _EPS))
    )
    w = jnp.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        -1,
    )
    return w * scale[..., None]


def _so3_left_jacobian(w):
    theta2 = jnp.sum(w * w, -1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    small = theta2 < _EPS
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2
    )
    c = jnp.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta2 * theta),
    )
    wx = hat(w)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), wx.shape)
    return eye + b[..., None, None] * wx + c[..., None, None] * matmul(wx, wx)


def se3_exp(xi):
    """(..., 6) twist (omega, v) -> (R (..., 3, 3), t (..., 3))."""
    w = xi[..., :3]
    v = xi[..., 3:]
    r = so3_exp(w)
    jl = _so3_left_jacobian(w)
    t = einsum("...ij,...j->...i", jl, v)
    return r, t


def se3_log(r, t):
    """Inverse of se3_exp: -> (..., 6)."""
    w = so3_log(r)
    jl = _so3_left_jacobian(w)
    v = jnp.linalg.solve(jl, t[..., None])[..., 0]
    return jnp.concatenate([w, v], -1)


def se3_compose(r1, t1, r2, t2):
    """(R1, t1) o (R2, t2): x -> R1 (R2 x + t2) + t1."""
    return matmul(r1, r2), einsum("...ij,...j->...i", r1, t2) + t1


def se3_inverse(r, t):
    rt = jnp.swapaxes(r, -1, -2)
    return rt, -einsum("...ij,...j->...i", rt, t)
