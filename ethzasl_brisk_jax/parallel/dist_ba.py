"""Distributed windowed BA: landmark/map-block sharding over the mesh.

The north-star distributed-BA design (SURVEY.md section 2.5): landmarks
and their observations are partitioned across the 'model' mesh axis (map
blocks); poses are replicated. Each shard assembles its landmarks'
contribution to the reduced (Schur) pose system; the (6K x 6K) reduced
Hessian and rhs are summed across devices with ``jax.lax.psum`` (the only
cross-chip traffic — O(K^2), independent of landmark count); every shard
solves the small pose system redundantly (cheaper than broadcasting) and
back-substitutes its local landmarks fully in parallel.

Observations must be pre-partitioned so a landmark's observations live on
its own shard (the natural layout when tracks are created shard-local).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ethzasl_brisk_jax.ba.se3 import se3_exp
from ethzasl_brisk_jax.ba.window import BaProblem, _residual_and_jacobians
from ethzasl_brisk_jax.utils.precise import einsum, matmul


def _local_schur(p: BaProblem, damping):
    """One shard's contribution: reduced system pieces + local landmark
    solve terms. Identical math to ba.window._gauss_newton_step, but the
    pose-space reduction is returned for a cross-shard psum."""
    res, j_po, j_pt, w = _residual_and_jacobians(p)
    k = p.r.shape[0]
    n_lm = p.points.shape[0]
    dt = res.dtype
    eye3 = jnp.eye(3, dtype=dt)
    eye6 = jnp.eye(6, dtype=dt)

    wres = res * w[:, None]
    b_blocks = jax.ops.segment_sum(
        einsum("oai,oab->oib", j_po * w[:, None, None], j_po),
        p.kf_idx, num_segments=k,
    )
    c_blocks = jax.ops.segment_sum(
        einsum("oai,oab->oib", j_pt * w[:, None, None], j_pt),
        p.lm_idx, num_segments=n_lm,
    )
    g_pose = jax.ops.segment_sum(
        einsum("oai,oa->oi", j_po, wres), p.kf_idx, num_segments=k
    )
    g_pt = jax.ops.segment_sum(
        einsum("oai,oa->oi", j_pt, wres), p.lm_idx, num_segments=n_lm
    )
    e_obs = einsum("oai,oab->oib", j_po * w[:, None, None], j_pt)
    e_dense = jnp.zeros((n_lm, k, 6, 3), dt).at[p.lm_idx, p.kf_idx].add(
        e_obs
    )
    c_inv = jnp.linalg.inv(c_blocks + damping * eye3[None] + 1e-9 * eye3)
    ec = einsum("lkis,lst->lkit", e_dense, c_inv)
    s_red = einsum("lkit,lmjt->kimj", ec, e_dense)
    b_diag = jnp.zeros((k, 6, k, 6), dt).at[
        jnp.arange(k), :, jnp.arange(k), :
    ].set(b_blocks + damping * eye6[None])
    s_local = b_diag - s_red
    rhs_local = g_pose - einsum("lkit,lt->ki", ec, g_pt)
    cost_local = jnp.sum(wres * res)
    return s_local, rhs_local, (c_inv, e_dense, g_pt), cost_local


def _dist_step(p: BaProblem, damping, axis: str):
    k = p.r.shape[0]
    s_local, rhs_local, (c_inv, e_dense, g_pt), cost_l = _local_schur(
        p, damping
    )
    # The only cross-device communication.
    s = jax.lax.psum(s_local, axis).reshape(6 * k, 6 * k)
    rhs = jax.lax.psum(rhs_local, axis).reshape(6 * k)
    cost = jax.lax.psum(cost_l, axis)

    dt = s.dtype
    fix = jnp.arange(6 * k) < 6
    s = jnp.where(fix[:, None] | fix[None, :], 0.0, s)
    s = s + jnp.diag(fix.astype(dt))
    rhs = jnp.where(fix, 0.0, rhs)
    delta_pose = -jnp.linalg.solve(s, rhs).reshape(k, 6)

    et_dx = einsum("lkis,ki->ls", e_dense, delta_pose)
    delta_pt = -einsum("lst,lt->ls", c_inv, g_pt + et_dx)

    dr, dtr = se3_exp(delta_pose)
    r_new = matmul(dr, p.r)
    t_new = einsum("kij,kj->ki", dr, p.t) + dtr
    return dataclasses.replace(
        p, r=r_new, t=t_new, points=p.points + delta_pt
    ), cost


@partial(jax.jit, static_argnames=("mesh", "iterations", "axis"))
def solve_window_ba_sharded(
    mesh: Mesh,
    problem: BaProblem,
    iterations: int = 10,
    damping: float = 1e-4,
    axis: str = "model",
):
    """Landmark-sharded BA over `axis`. The problem's landmark-indexed
    arrays (points) and observation arrays (kf_idx/lm_idx/uv/valid) must
    be shardable over `axis` with lm_idx LOCAL to each shard (use
    partition_problem to build such a layout). Poses replicate."""

    def run(r, t, points, kf_idx, lm_idx, uv, valid, fu, fv, cu, cv):
        # lm_idx arrives GLOBAL; localize to this shard's landmark block.
        lm_local = lm_idx - jax.lax.axis_index(axis) * points.shape[0]
        p = BaProblem(
            r=r, t=t, points=points, kf_idx=kf_idx, lm_idx=lm_local, uv=uv,
            valid=valid, fu=fu, fv=fv, cu=cu, cv=cv,
        )

        def body(i, state):
            prob, costs = state
            # Per-shard damping is psum-ed: pre-divide by the axis
            # size so the reduced system carries the exact damping.
            eff = damping / jax.lax.psum(1, axis)
            prob2, cost = _dist_step(
                prob, jnp.asarray(eff, r.dtype), axis
            )
            return prob2, costs.at[i].set(cost)

        costs0 = jnp.zeros((iterations,), r.dtype)
        p_out, costs = jax.lax.fori_loop(0, iterations, body, (p, costs0))
        return p_out.r, p_out.t, p_out.points, costs

    fn = shard_map(
        run,
        mesh=mesh,
        in_specs=(
            P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis),
            P(), P(), P(), P(),
        ),
        out_specs=(P(), P(), P(axis), P()),
        check_vma=False,
    )
    r, t, points, costs = fn(
        problem.r, problem.t, problem.points, problem.kf_idx,
        problem.lm_idx, problem.uv, problem.valid,
        problem.fu, problem.fv, problem.cu, problem.cv,
    )
    return dataclasses.replace(
        problem, r=r, t=t, points=points
    ), costs


def partition_problem(problem: BaProblem, n_shards: int) -> BaProblem:
    """Host-side re-layout: round-robin landmarks to shards, re-indexing
    lm_idx to shard-local and padding observations per shard equally.

    Returns a BaProblem whose landmark/observation arrays concatenate the
    per-shard blocks (so P('model') sharding gives each chip exactly its
    block).
    """
    import numpy as np

    pts = np.asarray(problem.points)
    kf = np.asarray(problem.kf_idx)
    lm = np.asarray(problem.lm_idx)
    uv = np.asarray(problem.uv)
    valid = np.asarray(problem.valid)
    n_lm = pts.shape[0]

    lm_pad = -(-n_lm // n_shards) * n_shards
    per_shard_lm = lm_pad // n_shards
    shard_of = np.arange(lm_pad) % n_shards
    local_of = np.arange(lm_pad) // n_shards

    obs_shard = shard_of[lm]
    counts = np.bincount(obs_shard, minlength=n_shards)
    per_shard_obs = int(counts.max())

    # Landmark g goes to shard g%S at local slot g//S (vectorized scatter).
    new_slot_of_lm = shard_of * per_shard_lm + local_of  # (lm_pad,)
    new_pts = np.zeros((lm_pad, 3), pts.dtype)
    new_pts[new_slot_of_lm[:n_lm]] = pts

    # Observation o of shard s lands at slot s*per_shard_obs + rank, where
    # rank is o's position among its shard's observations in input order:
    # stable-sort by shard, then rank = position within the sorted run.
    order = np.argsort(obs_shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts[:-1])])
    rank_sorted = np.arange(len(kf)) - np.repeat(starts, counts)
    slots = obs_shard[order] * per_shard_obs + rank_sorted

    new_kf = np.zeros((n_shards * per_shard_obs,), kf.dtype)
    new_lm = np.zeros((n_shards * per_shard_obs,), lm.dtype)
    new_uv = np.zeros((n_shards * per_shard_obs, 2), uv.dtype)
    new_valid = np.zeros((n_shards * per_shard_obs,), bool)
    new_kf[slots] = kf[order]
    # Global index in the re-laid-out points array.
    new_lm[slots] = new_slot_of_lm[lm[order]]
    new_uv[slots] = uv[order]
    new_valid[slots] = valid[order]

    import jax.numpy as jnp

    return dataclasses.replace(
        problem,
        points=jnp.asarray(new_pts),
        kf_idx=jnp.asarray(new_kf),
        lm_idx=jnp.asarray(new_lm),
        uv=jnp.asarray(new_uv),
        valid=jnp.asarray(new_valid),
    )
