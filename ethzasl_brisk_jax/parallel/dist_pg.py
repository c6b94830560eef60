"""Distributed pose-graph optimization: edges partitioned over the mesh.

Config-5 analog (map-scale back-end): the pose graph's EDGE set is
partitioned across the 'model' mesh axis (each shard owns E/m edges —
including cross-partition edges, which need no special handling because
Gauss-Newton assembly is a pure sum over edges). Per iteration each
shard assembles its partial normal equations locally; ONE psum across
devices (or across hosts — the same collective) reduces (H, b, cost); the
gauge-fixed damped solve and pose update run replicated (N poses after
keyframing are small; the O((6N)^2) H matrix is the communication
payload, the O(E) residual/Jacobian work is what scales out).

This mirrors ``parallel/dist_ba.py``'s landmark-sharded Schur reduction
one level up the back-end stack. Works on a single-process multi-device
mesh and across processes via ``jax.distributed.initialize``
(tools/multihost_worker.py runs it in two processes).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ethzasl_brisk_jax.ba.pose_graph import (
    PoseGraph,
    assemble_normal_equations,
    solve_and_update,
)


def partition_edges(graph: PoseGraph, n_shards: int) -> PoseGraph:
    """Pad the edge set to a multiple of n_shards (zero-weight padding
    edges reference node 0 and contribute nothing to the assembly)."""
    e = graph.edge_i.shape[0]
    pad = (-e) % n_shards
    if pad == 0:
        return graph
    eye = jnp.broadcast_to(
        jnp.eye(3, dtype=graph.rel_r.dtype), (pad, 3, 3)
    )
    return dataclasses.replace(
        graph,
        edge_i=jnp.pad(graph.edge_i, (0, pad)),
        edge_j=jnp.pad(graph.edge_j, (0, pad)),
        rel_r=jnp.concatenate([graph.rel_r, eye]),
        rel_t=jnp.pad(graph.rel_t, ((0, pad), (0, 0))),
        weight=jnp.pad(graph.weight, (0, pad)),  # zero weight
    )


@partial(jax.jit, static_argnames=("mesh", "iterations"))
def optimize_pose_graph_sharded(
    mesh: Mesh,
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
):
    """Edge-sharded GN over the 'model' axis. Returns (graph, costs).

    ``graph`` must have edges padded to a multiple of the axis size
    (partition_edges). Bitwise-equal results require the same reduction
    order; costs/H/b are psum-reduced, so expect float-level agreement
    with the single-device path (exact when m == 1).
    """
    n = graph.r.shape[0]
    dampv = jnp.asarray(damping, graph.r.dtype)

    def local_fn(r, t, ei, ej, rr, rt, w):
        def body(i, state):
            g_rt, costs = state
            g = PoseGraph(
                r=g_rt[0], t=g_rt[1], edge_i=ei, edge_j=ej,
                rel_r=rr, rel_t=rt, weight=w,
            )
            h, b, cost = assemble_normal_equations(g, n)
            h = jax.lax.psum(h, "model")
            b = jax.lax.psum(b, "model")
            cost = jax.lax.psum(cost, "model")
            g2 = solve_and_update(g, h, b, dampv)
            return (g2.r, g2.t), costs.at[i].set(cost)

        costs0 = jnp.zeros((iterations,), r.dtype)
        (r_out, t_out), costs = jax.lax.fori_loop(
            0, iterations, body, ((r, t), costs0)
        )
        return r_out, t_out, costs

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(), P(),                      # poses replicated
            P("model"), P("model"),        # edges sharded
            P("model"), P("model"), P("model"),
        ),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    r, t, costs = fn(
        graph.r, graph.t, graph.edge_i, graph.edge_j,
        graph.rel_r, graph.rel_t, graph.weight,
    )
    return dataclasses.replace(graph, r=r, t=t), costs
