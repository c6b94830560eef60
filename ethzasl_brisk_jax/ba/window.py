"""Windowed bundle adjustment with Schur-complement reduction.

The north-star BA layer (no reference counterpart — SURVEY.md section
2.5): keyframe-window Gauss-Newton over poses and landmarks with the
classic sparsity exploit, recast dense-batched for an accelerator:

* observations are a static-capacity structure-of-arrays
  (kf_idx, lm_idx, uv, valid) — ragged windows are padded and masked;
* reprojection Jacobians are computed batched over all observations at
  once (closed-form chain through SE(3) retraction and the pinhole
  projection);
* the normal equations' blocks are assembled with ``segment_sum``
  scatters: B (K, 6, 6) pose blocks, C (L, 3, 3) landmark blocks,
  E (O, 6, 3) coupling terms;
* the Schur complement S = B - E C^-1 E^T is built from per-landmark
  outer products (batched 6x3 @ 3x3 @ 3x6 matmuls + scatter-add into
  (K, K, 6, 6)), solved densely (6K x 6K — small for a window), and
  landmarks back-substituted in parallel;
* Levenberg damping with a fixed iteration count under ``lax.fori_loop``
  (static control flow).

Gauge: pose 0 is held fixed (its update rows are masked).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.ba.se3 import hat, se3_exp
from ethzasl_brisk_jax.utils.precise import einsum, matmul


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BaProblem:
    """Static-capacity BA window.

    poses: world-from-camera inverse? Convention: camera-from-world
      (R, t): x_cam = R x_world + t.
    """

    r: jax.Array          # (K, 3, 3) camera-from-world rotations
    t: jax.Array          # (K, 3)
    points: jax.Array     # (L, 3) world landmarks
    kf_idx: jax.Array     # (O,) int32
    lm_idx: jax.Array     # (O,) int32
    uv: jax.Array         # (O, 2) observed pixels
    valid: jax.Array      # (O,) bool
    fu: jax.Array
    fv: jax.Array
    cu: jax.Array
    cv: jax.Array


def _residual_and_jacobians(p: BaProblem):
    """Batched residuals + closed-form Jacobians.

    Returns (res (O, 2), J_pose (O, 2, 6), J_point (O, 2, 3), w (O,)).
    Pose Jacobian is wrt a LEFT-multiplied se(3) increment on
    camera-from-world: T <- exp(xi) o T.
    """
    rk = p.r[p.kf_idx]          # (O, 3, 3)
    tk = p.t[p.kf_idx]          # (O, 3)
    x_w = p.points[p.lm_idx]    # (O, 3)
    x_c = einsum("oij,oj->oi", rk, x_w) + tk
    z = x_c[:, 2]
    z_safe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    iz = 1.0 / z_safe
    u = p.fu * x_c[:, 0] * iz + p.cu
    v = p.fv * x_c[:, 1] * iz + p.cv
    res = jnp.stack([u, v], -1) - p.uv

    # d(pixel)/d(x_c).
    iz2 = iz * iz
    j_proj = jnp.stack(
        [
            jnp.stack(
                [p.fu * iz, jnp.zeros_like(iz), -p.fu * x_c[:, 0] * iz2], -1
            ),
            jnp.stack(
                [jnp.zeros_like(iz), p.fv * iz, -p.fv * x_c[:, 1] * iz2], -1
            ),
        ],
        -2,
    )  # (O, 2, 3)

    # d(x_c)/d(xi): left increment => dx_c = dtheta x x_c + dv.
    j_xc_pose = jnp.concatenate(
        [-hat(x_c), jnp.broadcast_to(jnp.eye(3, dtype=x_c.dtype),
                                     (*x_c.shape[:-1], 3, 3))],
        axis=-1,
    )  # (O, 3, 6)
    j_pose = matmul(j_proj, j_xc_pose)      # (O, 2, 6)
    j_point = matmul(j_proj, rk)           # (O, 2, 3)

    w = p.valid.astype(res.dtype) * (z > 0.1).astype(res.dtype)
    return res, j_pose, j_point, w


def _gauss_newton_step(
    p: BaProblem, damping, fix_poses: int = 1, huber_delta: float = 0.0
):
    res, j_po, j_pt, w = _residual_and_jacobians(p)
    if huber_delta > 0.0:
        # IRLS Huber: downweight observations with ||res|| > delta.
        rnorm = jnp.sqrt(jnp.sum(res * res, -1) + 1e-12)
        w = w * jnp.minimum(1.0, huber_delta / rnorm)
    k = p.r.shape[0]
    n_lm = p.points.shape[0]

    wres = res * w[:, None]
    # Block assembly (segment sums over observations).
    b_blocks = jax.ops.segment_sum(
        einsum("oai,oab->oib", j_po * w[:, None, None], j_po), p.kf_idx,
        num_segments=k,
    )  # (K, 6, 6)   == J_po^T J_po per pose
    c_blocks = jax.ops.segment_sum(
        einsum("oai,oab->oib", j_pt * w[:, None, None], j_pt), p.lm_idx,
        num_segments=n_lm,
    )  # (L, 3, 3)
    g_pose = jax.ops.segment_sum(
        einsum("oai,oa->oi", j_po, wres), p.kf_idx, num_segments=k
    )  # (K, 6)
    g_pt = jax.ops.segment_sum(
        einsum("oai,oa->oi", j_pt, wres), p.lm_idx, num_segments=n_lm
    )  # (L, 3)
    e_obs = einsum("oai,oab->oib", j_po * w[:, None, None], j_pt)
    # E blocks per (pose, landmark) pair appear once per obs; keep per-obs.

    # Damp.
    eye6 = jnp.eye(6, dtype=res.dtype)
    eye3 = jnp.eye(3, dtype=res.dtype)
    c_damped = c_blocks + damping * eye3[None]
    c_inv = jnp.linalg.inv(
        c_damped
        + 1e-9 * eye3[None]
    )

    # Schur: S = B - sum_obs-pairs E C^-1 E^T. Because each landmark can be
    # seen by several poses, build per-landmark pose-coupling by grouping
    # observations of the same landmark: S_{k1,k2} -= E_{k1,l} Cinv_l
    # E_{k2,l}^T. Assemble with a dense (L, K, 6, 3) coupling tensor
    # (windows are small: K ~ 10, L ~ thousands).
    e_dense = jnp.zeros((n_lm, k, 6, 3), res.dtype)
    e_dense = e_dense.at[p.lm_idx, p.kf_idx].add(e_obs)
    ec = einsum("lkis,lst->lkit", e_dense, c_inv)     # (L, K, 6, 3)
    s_red = einsum("lkit,lmjt->kimj", ec, e_dense)    # (K, 6, K, 6)

    b_dense = jnp.zeros((k, 6, k, 6), res.dtype)
    b_dense = b_dense.at[jnp.arange(k), :, jnp.arange(k), :].set(
        b_blocks + damping * eye6[None]
    )
    s = (b_dense - s_red).reshape(6 * k, 6 * k)

    rhs_pose = g_pose - einsum(
        "lkit,lt->ki", ec, g_pt
    )  # (K, 6)
    rhs = rhs_pose.reshape(6 * k)

    # Gauge fixing: freeze the first fix_poses poses (replace their
    # rows/cols with identity). Monocular windows pass fix_poses=2 to
    # anchor the scale gauge as well as the SE(3) gauge.
    fix = jnp.arange(6 * k) < 6 * fix_poses
    s = jnp.where(fix[:, None] | fix[None, :], 0.0, s)
    s = s + jnp.diag(fix.astype(res.dtype))
    rhs = jnp.where(fix, 0.0, rhs)

    delta_pose = -jnp.linalg.solve(s, rhs).reshape(k, 6)

    # Back-substitute landmarks: C dx_l = -g_l - E^T dx_pose.
    et_dx = einsum("lkis,ki->ls", e_dense, delta_pose)
    delta_pt = -einsum(
        "lst,lt->ls", c_inv, g_pt + et_dx
    )

    # Retract.
    dr, dt = se3_exp(delta_pose)
    r_new = matmul(dr, p.r)
    t_new = einsum("kij,kj->ki", dr, p.t) + dt
    pts_new = p.points + delta_pt
    cost = jnp.sum(wres * res)
    return dataclasses.replace(
        p, r=r_new, t=t_new, points=pts_new
    ), cost


@partial(
    jax.jit, static_argnames=("iterations", "fix_poses", "huber_delta")
)
def solve_window_ba(
    problem: BaProblem, iterations: int = 10, damping: float = 1e-4,
    fix_poses: int = 1, huber_delta: float = 0.0,
):
    """Run fixed-iteration damped Gauss-Newton. Returns (problem, costs)."""

    def body(i, state):
        prob, costs = state
        prob2, cost = _gauss_newton_step(
            prob, jnp.asarray(damping, prob.r.dtype), fix_poses,
            huber_delta,
        )
        return prob2, costs.at[i].set(cost)

    costs0 = jnp.zeros((iterations,), problem.r.dtype)
    return jax.lax.fori_loop(0, iterations, body, (problem, costs0))


def robust_cost(p: BaProblem, huber_delta: float = 0.0) -> jax.Array:
    """True robust objective: sum over valid observations of the Huber
    rho of the residual norm (plain squared norm when huber_delta == 0).
    This is what LM accept/reject compares — NOT the IRLS surrogate
    sum(w * r^2), whose weights change with the iterate."""
    res, _, _, w = _residual_and_jacobians(p)
    s2 = jnp.sum(res * res, -1)
    if huber_delta > 0.0:
        s = jnp.sqrt(s2 + 1e-12)
        rho = jnp.where(
            s <= huber_delta, s2, huber_delta * (2.0 * s - huber_delta)
        )
    else:
        rho = s2
    return jnp.sum(w * rho)


@partial(
    jax.jit, static_argnames=("iterations", "fix_poses", "huber_delta")
)
def solve_window_ba_lm(
    problem: BaProblem, iterations: int = 10, damping: float = 1e-3,
    fix_poses: int = 1, huber_delta: float = 0.0,
    lambda_down: float = 1.0 / 3.0, lambda_up: float = 4.0,
):
    """Levenberg-Marquardt with step accept/reject.

    Each iteration solves the damped system, RE-EVALUATES the true
    robust cost at the candidate, and only accepts steps that decrease
    it (shrinking lambda); rejected steps keep the iterate and grow
    lambda. The objective is therefore monotonically non-increasing —
    on degenerate geometry (planar scenes, low parallax) the solver
    stalls at the incumbent instead of diverging, which replaces the
    post-hoc --ba-max-shift divergence gate.

    Returns (problem, costs, lambdas); costs[i] is the accepted
    objective after iteration i.
    """
    dt = problem.r.dtype

    def body(i, state):
        prob, lam, cost0, costs, lams = state
        cand, _ = _gauss_newton_step(prob, lam, fix_poses, huber_delta)
        cost1 = robust_cost(cand, huber_delta)
        # Reject non-finite candidates outright (singular Schur solve).
        accept = jnp.isfinite(cost1) & (cost1 < cost0)
        prob = jax.tree_util.tree_map(
            lambda new, old: jnp.where(accept, new, old), cand, prob
        )
        cost = jnp.where(accept, cost1, cost0)
        lam = jnp.where(accept, lam * lambda_down, lam * lambda_up)
        lam = jnp.clip(lam, 1e-10, 1e8)
        return (
            prob, lam, cost,
            costs.at[i].set(cost), lams.at[i].set(lam),
        )

    cost_init = robust_cost(problem, huber_delta)
    state0 = (
        problem, jnp.asarray(damping, dt), cost_init,
        jnp.zeros((iterations,), dt), jnp.zeros((iterations,), dt),
    )
    prob, _, _, costs, lams = jax.lax.fori_loop(
        0, iterations, body, state0
    )
    return prob, costs, lams


@partial(
    jax.jit,
    static_argnames=(
        "iterations", "fix_poses", "huber_delta", "trim_sigma"
    ),
)
def solve_window_ba_trimmed(
    problem: BaProblem, iterations: int = 12, damping: float = 1e-3,
    fix_poses: int = 1, huber_delta: float = 0.0,
    trim_sigma: float = 3.0,
):
    """Two-stage trimmed LM: solve, reject gross outlier observations,
    re-solve from the ORIGINAL iterate on the trimmed set.

    Huber bounds an outlier's gradient but never zeroes it — a
    coherent set of wrong observations (e.g. tracks on a moving
    occluder) still biases the optimum. After a first LM pass, any
    observation whose residual norm exceeds
    ``trim_sigma * max(median residual, 1px)`` at the stage-1 solution
    is invalidated, and LM restarts from the original poses/points on
    the surviving set. Returns (problem, costs, n_trimmed).
    """
    half = max(iterations // 2, 1)
    stage1, _, _ = solve_window_ba_lm(
        problem, iterations=half, damping=damping,
        fix_poses=fix_poses, huber_delta=huber_delta,
    )
    res, _, _, w = _residual_and_jacobians(stage1)
    rnorm = jnp.sqrt(jnp.sum(res * res, -1) + 1e-12)
    big = jnp.float32(1e30)

    # TRACK-level statistic: a landmark on a moving object becomes a
    # phantom point — stage 1 absorbs the mean motion into its
    # position, leaving each of its observations a moderate residual
    # (the per-pose deviation). Per-observation trimming misses most
    # of them; the landmark's MEAN residual separates cleanly.
    n_lm = problem.points.shape[0]
    lm_sum = jax.ops.segment_sum(rnorm * w, problem.lm_idx, n_lm)
    lm_cnt = jax.ops.segment_sum(w, problem.lm_idx, n_lm)
    lm_mean = lm_sum / jnp.maximum(lm_cnt, 1.0)
    observed = lm_cnt > 0

    def med_of(vals, mask):
        v = jnp.where(mask, vals, big)
        n = jnp.sum(mask).astype(jnp.int32)
        return jnp.sort(v)[jnp.clip(n // 2, 0, v.shape[0] - 1)]

    def mad_thr(vals, mask, floor):
        """median + trim_sigma * 1.4826 * MAD (floored) — a robust
        z-score cut; a multiplicative cut (sigma * median) fails when
        the inlier distribution is narrow relative to its median."""
        med = med_of(vals, mask)
        mad = med_of(jnp.abs(vals - med), mask)
        return med + jnp.maximum(trim_sigma * 1.4826 * mad, floor)

    lm_keep = lm_mean <= mad_thr(lm_mean, observed, 0.5)

    # Plus a per-observation guard for isolated gross outliers.
    obs_keep = rnorm <= mad_thr(rnorm, w > 0, 1.0)

    keep = problem.valid & lm_keep[problem.lm_idx] & obs_keep
    n_trimmed = jnp.sum(problem.valid) - jnp.sum(keep)
    # Re-solve from the ORIGINAL iterate (the stage-1 solution is
    # biased by the very observations just removed) with the full
    # iteration budget — LM iterations are cheap next to the bias.
    trimmed = dataclasses.replace(problem, valid=keep)
    solved, costs, _ = solve_window_ba_lm(
        trimmed, iterations=iterations, damping=damping,
        fix_poses=fix_poses, huber_delta=huber_delta,
    )
    return solved, costs, n_trimmed
