"""Worker for the two-process multi-host test (tools/test via pytest).

Each process owns 4 virtual CPU devices; jax.distributed.initialize forms
an 8-device global mesh across the process boundary (the multi-host case).
Runs the landmark-sharded distributed BA (parallel/dist_ba.py) on a
deterministic synthetic problem and process 0 writes the final cost for
the parent to check.

Usage: python tools/multihost_worker.py <process_id> <num_processes> <out>
"""
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
out_path = sys.argv[3]

os.environ["XLA_FLAGS"] = (
    "--xla_force_host_platform_device_count=4"
)
import jax

jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(
    coordinator_address="127.0.0.1:9873",
    num_processes=nproc,
    process_id=pid,
)

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ethzasl_brisk_jax.ba import BaProblem
from ethzasl_brisk_jax.parallel import make_mesh
from ethzasl_brisk_jax.parallel.dist_ba import (
    partition_problem,
    solve_window_ba_sharded,
)

devices = jax.devices()
assert len(devices) == 4 * nproc, devices
mesh = make_mesh(1, len(devices))

# Deterministic synthetic problem (same on every process).
rng = np.random.default_rng(11)
k_pose, n_lm = 5, 64
pts = rng.uniform([-2, -2, 4], [2, 2, 9], (n_lm, 3))
t_cam = np.stack([np.linspace(0, 0.8, k_pose), np.zeros(k_pose),
                  np.zeros(k_pose)], 1)
kf = np.repeat(np.arange(k_pose), n_lm)
lm = np.tile(np.arange(n_lm), k_pose)
x_c = pts[lm] - t_cam[kf]
uv = np.stack([300.0 * x_c[:, 0] / x_c[:, 2] + 160,
               300.0 * x_c[:, 1] / x_c[:, 2] + 120], 1)
f32 = jnp.float32
prob = BaProblem(
    r=jnp.broadcast_to(jnp.eye(3, dtype=f32), (k_pose, 3, 3)),
    t=jnp.asarray(-t_cam + rng.normal(0, 0.01, t_cam.shape)
                  * (np.arange(k_pose) > 0)[:, None], f32),
    points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape), f32),
    kf_idx=jnp.asarray(kf, jnp.int32),
    lm_idx=jnp.asarray(lm, jnp.int32),
    uv=jnp.asarray(uv, f32),
    valid=jnp.ones((len(kf),), bool),
    fu=f32(300.0), fv=f32(300.0), cu=f32(160.0), cv=f32(120.0),
)
sharded = partition_problem(prob, len(devices))

# Shard global arrays across the multi-process mesh.
from jax.sharding import NamedSharding, PartitionSpec as P

def put(x, spec):
    return jax.make_array_from_callback(
        x.shape,
        NamedSharding(mesh, spec),
        lambda idx: np.asarray(x)[idx],
    )

import dataclasses
sharded = dataclasses.replace(
    sharded,
    points=put(sharded.points, P("model", None)),
    kf_idx=put(sharded.kf_idx, P("model")),
    lm_idx=put(sharded.lm_idx, P("model")),
    uv=put(sharded.uv, P("model", None)),
    valid=put(sharded.valid, P("model")),
)

with mesh:
    solved, costs = solve_window_ba_sharded(
        mesh, sharded, iterations=8, damping=1e-3
    )
    costs = np.asarray(jax.device_get(costs))

# ---- Partitioned pose graph across the same multi-process mesh ----
# (config 5: edges sharded over 'model', cross-process psum per GN step).
from ethzasl_brisk_jax.ba.pose_graph import PoseGraph
from ethzasl_brisk_jax.ba.se3 import so3_exp
from ethzasl_brisk_jax.parallel.dist_pg import (
    optimize_pose_graph_sharded,
    partition_edges,
)

n_nodes = 12
angles = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
r_gt = np.stack([
    np.array([[np.cos(a), -np.sin(a), 0],
              [np.sin(a), np.cos(a), 0],
              [0, 0, 1]]) for a in angles
])
c_gt = np.stack([5 * np.cos(angles), 5 * np.sin(angles),
                 np.zeros(n_nodes)], 1)
t_gt = -np.einsum("nij,nj->ni", r_gt, c_gt)
ei = np.append(np.arange(n_nodes - 1), n_nodes - 1)
ej = np.append(np.arange(1, n_nodes), 0)
rel_r = np.einsum("nij,nkj->nik", r_gt[ei], r_gt[ej])
rel_t = t_gt[ei] - np.einsum("nij,nj->ni", rel_r, t_gt[ej])
w_noise = rng.normal(0, 0.03, (n_nodes, 3))
w_noise[0] = 0
r0 = np.asarray(so3_exp(jnp.asarray(w_noise, f32))) @ r_gt
t0 = t_gt + rng.normal(0, 0.2, (n_nodes, 3)) * (np.arange(n_nodes) > 0)[:, None]

graph = partition_edges(
    PoseGraph(
        r=jnp.asarray(r0, f32), t=jnp.asarray(t0, f32),
        edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
        rel_r=jnp.asarray(rel_r, f32), rel_t=jnp.asarray(rel_t, f32),
        weight=jnp.ones((len(ei),), f32),
    ),
    len(devices),
)
graph = dataclasses.replace(
    graph,
    edge_i=put(graph.edge_i, P("model")),
    edge_j=put(graph.edge_j, P("model")),
    rel_r=put(graph.rel_r, P("model", None, None)),
    rel_t=put(graph.rel_t, P("model", None)),
    weight=put(graph.weight, P("model")),
)
with mesh:
    pg_out, pg_costs = optimize_pose_graph_sharded(
        mesh, graph, iterations=12, damping=1e-5
    )
    pg_costs = np.asarray(jax.device_get(pg_costs))
pg_t_err = float(
    np.abs(np.asarray(jax.device_get(pg_out.t)) - t_gt).max()
)

if pid == 0:
    with open(out_path, "w") as f:
        f.write(f"{costs[0]:.6e} {costs[-1]:.6e} "
                f"{pg_costs[-1]:.6e} {pg_t_err:.6e}\n")
print(f"proc {pid}: cost {costs[0]:.3e} -> {costs[-1]:.3e}; "
      f"pg {pg_costs[0]:.3e} -> {pg_costs[-1]:.3e} terr {pg_t_err:.3e}",
      flush=True)
