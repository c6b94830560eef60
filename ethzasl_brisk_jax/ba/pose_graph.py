"""Pose-graph optimization over SE(3) relative constraints.

North-star component (no reference counterpart). Nodes are
camera-from-world poses; edges are measured relative transforms
T_ij ~ T_i o T_j^-1 with residual log(T_ij^-1 T_i T_j^-1) in se(3).
Batched Gauss-Newton: all edge residuals/Jacobians at once, dense
(6N x 6N) normal equations (pose graphs after keyframing are small),
fixed iteration count, node 0 gauge-fixed.

Jacobians use the small-increment approximation J_i = I, J_j = -Ad
(standard for PGO at convergence); a fixed damping keeps early
iterations stable.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.ba.se3 import (
    hat,
    se3_compose,
    se3_exp,
    se3_inverse,
    se3_log,
)
from ethzasl_brisk_jax.utils.precise import einsum, matmul


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseGraph:
    r: jax.Array        # (N, 3, 3)
    t: jax.Array        # (N, 3)
    edge_i: jax.Array   # (E,) int32
    edge_j: jax.Array   # (E,) int32
    rel_r: jax.Array    # (E, 3, 3) measured T_ij = T_i o T_j^-1
    rel_t: jax.Array    # (E, 3)
    weight: jax.Array   # (E,)


def _adjoint(r, t):
    """SE(3) adjoint (..., 6, 6) for twist order (omega, v)."""
    z = jnp.zeros_like(r)
    top = jnp.concatenate([r, z], -1)
    bottom = jnp.concatenate([matmul(hat(t), r), r], -1)
    return jnp.concatenate([top, bottom], -2)


def _edge_residuals(g: PoseGraph):
    ri, ti = g.r[g.edge_i], g.t[g.edge_i]
    rj, tj = g.r[g.edge_j], g.t[g.edge_j]
    rj_inv, tj_inv = se3_inverse(rj, tj)
    r_est, t_est = se3_compose(ri, ti, rj_inv, tj_inv)
    rm_inv, tm_inv = se3_inverse(g.rel_r, g.rel_t)
    r_err, t_err = se3_compose(rm_inv, tm_inv, r_est, t_est)
    return se3_log(r_err, t_err)  # (E, 6)


def assemble_normal_equations(g: PoseGraph, n: int):
    """Edge-parallel GN assembly: returns (H (N,6,N,6), b (N,6), cost).

    Pure sum over edges — shardable: a partition of the edge set yields
    partial (H, b, cost) whose psum equals the full assembly (the
    distributed pose-graph path, parallel/dist_pg.py, relies on this).
    Zero-weight edges contribute nothing (used for padding).
    """
    res = _edge_residuals(g)  # (E, 6)
    w = g.weight

    # J wrt left-increments: d res / d xi_i ~ Ad(Tm^-1), d/d xi_j ~ -Ad(Tm^-1 Ti Tj^-1).
    rm_inv, tm_inv = se3_inverse(g.rel_r, g.rel_t)
    ad_i = _adjoint(rm_inv, tm_inv)
    ri, ti = g.r[g.edge_i], g.t[g.edge_i]
    rj, tj = g.r[g.edge_j], g.t[g.edge_j]
    rj_inv, tj_inv = se3_inverse(rj, tj)
    r_est, t_est = se3_compose(ri, ti, rj_inv, tj_inv)
    r_c, t_c = se3_compose(rm_inv, tm_inv, r_est, t_est)
    ad_j = -_adjoint(r_c, t_c)

    h = jnp.zeros((n, 6, n, 6), res.dtype)
    b = jnp.zeros((n, 6), res.dtype)

    def blocks(ja, jb, ia, ib, h):
        hij = einsum("eai,eab->eib", ja * w[:, None, None], jb)
        return h.at[ia, :, ib, :].add(hij)

    h = blocks(ad_i, ad_i, g.edge_i, g.edge_i, h)
    h = blocks(ad_i, ad_j, g.edge_i, g.edge_j, h)
    h = blocks(ad_j, ad_i, g.edge_j, g.edge_i, h)
    h = blocks(ad_j, ad_j, g.edge_j, g.edge_j, h)
    b = b.at[g.edge_i].add(
        einsum("eai,ea->ei", ad_i * w[:, None, None], res)
    )
    b = b.at[g.edge_j].add(
        einsum("eai,ea->ei", ad_j * w[:, None, None], res)
    )
    cost = jnp.sum(res * res * w[:, None])
    return h, b, cost


def solve_and_update(g: PoseGraph, h, b, damping):
    """Gauge-fixed damped solve + left-increment pose update."""
    n = g.r.shape[0]
    hm = h.reshape(6 * n, 6 * n) + damping * jnp.eye(6 * n, dtype=h.dtype)
    bv = b.reshape(6 * n)
    fix = jnp.arange(6 * n) < 6
    hm = jnp.where(fix[:, None] | fix[None, :], 0.0, hm)
    hm = hm + jnp.diag(fix.astype(h.dtype))
    bv = jnp.where(fix, 0.0, bv)

    delta = -jnp.linalg.solve(hm, bv).reshape(n, 6)
    dr, dt = se3_exp(delta)
    r_new = matmul(dr, g.r)
    t_new = einsum("nij,nj->ni", dr, g.t) + dt
    return dataclasses.replace(g, r=r_new, t=t_new)


def _step(g: PoseGraph, damping):
    h, b, cost = assemble_normal_equations(g, g.r.shape[0])
    return solve_and_update(g, h, b, damping), cost


@partial(jax.jit, static_argnames=("iterations",))
def optimize_pose_graph(
    graph: PoseGraph, iterations: int = 10, damping: float = 1e-6
):
    """Fixed-iteration GN. Returns (graph, costs (iterations,))."""

    def body(i, state):
        g, costs = state
        g2, cost = _step(g, jnp.asarray(damping, g.r.dtype))
        return g2, costs.at[i].set(cost)

    costs0 = jnp.zeros((iterations,), graph.r.dtype)
    return jax.lax.fori_loop(0, iterations, body, (graph, costs0))
