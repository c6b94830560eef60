"""Batched RANSAC for homography and essential-matrix estimation.

New scope relative to the reference (SURVEY.md section 2.5): the reference
stops at descriptor matching; the north star layers pose estimation on
top. Batched design: instead of the classic sequential
hypothesize-and-verify loop, ALL hypotheses are generated and scored in
one batched pass — minimal samples are drawn with a counter-based PRNG,
model fits are batched linear algebra (SVD over a leading hypothesis
axis), and inlier counting is one (H, N) matrix op. This maps the whole
solver onto dense array ops with no data-dependent control flow.

All math in float32 unless x64 is enabled.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ethzasl_brisk_jax.utils.precise import einsum, matmul


def _dtype():
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _sample_indices(key, n_hyp: int, k: int, n_points: int, weights):
    """(n_hyp, k) random indices into the valid points (with replacement
    across hypotheses, distinct-ish within a sample via categorical)."""
    keys = jax.random.split(key, k)
    logits = jnp.where(weights, 0.0, -1e30)
    cols = [
        jax.random.categorical(kk, logits, shape=(n_hyp,)) for kk in keys
    ]
    return jnp.stack(cols, axis=1)


def _normalize_points(pts):
    """Hartley normalization: zero-mean, sqrt(2) RMS. Returns (pts_n, T)."""
    mean = pts.mean(axis=-2, keepdims=True)
    d = jnp.sqrt(((pts - mean) ** 2).sum(-1)).mean(-1)
    s = jnp.sqrt(2.0) / jnp.where(d == 0, 1.0, d)
    t = jnp.zeros((*pts.shape[:-2], 3, 3), pts.dtype)
    t = t.at[..., 0, 0].set(s)
    t = t.at[..., 1, 1].set(s)
    t = t.at[..., 2, 2].set(1.0)
    t = t.at[..., 0, 2].set(-s * mean[..., 0, 0])
    t = t.at[..., 1, 2].set(-s * mean[..., 0, 1])
    pts_n = pts * s[..., None, None] - jnp.stack(
        [s * mean[..., 0, 0], s * mean[..., 0, 1]], -1
    )[..., None, :]
    return pts_n, t


def fit_homography_dlt(p1, p2):
    """Batched DLT: p1, p2 (..., K>=4, 2) -> (..., 3, 3) with H p1 ~ p2."""
    dt = p1.dtype
    p1n, t1 = _normalize_points(p1)
    p2n, t2 = _normalize_points(p2)
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    row1 = jnp.stack(
        [-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], -1
    )
    row2 = jnp.stack(
        [zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], -1
    )
    a = jnp.concatenate([row1, row2], axis=-2)  # (..., 2K, 9)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    h = vt[..., -1, :].reshape(*a.shape[:-2], 3, 3)
    h = jnp.linalg.solve(t2, matmul(h, t1))
    return h / jnp.where(
        jnp.abs(h[..., 2:3, 2:3]) < 1e-12, 1.0, h[..., 2:3, 2:3]
    )


def homography_reproj_error(h, p1, p2):
    """Squared reprojection error |H p1 - p2|^2, (..., N)."""
    x = p1[..., 0]
    y = p1[..., 1]
    w = h[..., 2, 0, None] * x + h[..., 2, 1, None] * y + h[..., 2, 2, None]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    u = (
        h[..., 0, 0, None] * x + h[..., 0, 1, None] * y + h[..., 0, 2, None]
    ) / w
    v = (
        h[..., 1, 0, None] * x + h[..., 1, 1, None] * y + h[..., 1, 2, None]
    ) / w
    return (u - p2[..., 0]) ** 2 + (v - p2[..., 1]) ** 2


@partial(jax.jit, static_argnames=("n_hypotheses",))
def ransac_homography(
    key,
    p1: jnp.ndarray,       # (N, 2)
    p2: jnp.ndarray,       # (N, 2)
    valid: jnp.ndarray,    # (N,) bool
    threshold: float = 3.0,
    n_hypotheses: int = 256,
):
    """Batched-hypothesis RANSAC homography.

    Returns (H (3,3), inlier_mask (N,), n_inliers). Refits on the best
    hypothesis's inliers with weighted DLT (invalid rows zero-weighted).
    """
    dt = _dtype()
    p1 = p1.astype(dt)
    p2 = p2.astype(dt)
    idx = _sample_indices(key, n_hypotheses, 4, p1.shape[0], valid)
    h = fit_homography_dlt(p1[idx], p2[idx])  # (H, 3, 3)
    err = homography_reproj_error(h, p1[None], p2[None])  # (H, N)
    inl = (err < threshold * threshold) & valid[None]
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)
    h_best = h[best]
    inlier_mask = inl[best]

    # Refit with inliers via zero-weighting (static shapes).
    w = inlier_mask.astype(dt)
    h_refit = _weighted_dlt(p1, p2, w)
    err_r = homography_reproj_error(h_refit[None], p1[None], p2[None])[0]
    inl_r = (err_r < threshold * threshold) & valid
    better = inl_r.sum() >= inlier_mask.sum()
    h_out = jnp.where(better, h_refit, h_best)
    mask_out = jnp.where(better, inl_r, inlier_mask)
    return h_out, mask_out, mask_out.sum()


def _weighted_dlt(p1, p2, w):
    p1n, t1 = _normalize_points(p1)
    p2n, t2 = _normalize_points(p2)
    x, y = p1n[..., 0], p1n[..., 1]
    u, v = p2n[..., 0], p2n[..., 1]
    zeros = jnp.zeros_like(x)
    ones = jnp.ones_like(x)
    row1 = jnp.stack(
        [-x, -y, -ones, zeros, zeros, zeros, u * x, u * y, u], -1
    )
    row2 = jnp.stack(
        [zeros, zeros, zeros, -x, -y, -ones, v * x, v * y, v], -1
    )
    a = jnp.concatenate([row1 * w[:, None], row2 * w[:, None]], axis=0)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    h = vt[-1].reshape(3, 3)
    h = jnp.linalg.solve(t2, matmul(h, t1))
    return h / jnp.where(jnp.abs(h[2, 2]) < 1e-12, 1.0, h[2, 2])


def fit_essential_8pt(r1, r2):
    """Batched 8-point: r1, r2 (..., K>=8, 2) normalized image coords.

    Returns (..., 3, 3) essential matrices with the rank-2, equal-singular
    -value constraint projected.
    """
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    ones = jnp.ones_like(x1)
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], -1
    )  # (..., K, 9)
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    e = vt[..., -1, :].reshape(*a.shape[:-2], 3, 3)
    # Project to the essential manifold: singular values (s, s, 0).
    u, s, vh = jnp.linalg.svd(e)
    s_mean = (s[..., 0] + s[..., 1]) * 0.5
    s_new = jnp.stack(
        [s_mean, s_mean, jnp.zeros_like(s_mean)], -1
    )
    return matmul(u, s_new[..., None] * vh)


def sampson_error(e, r1, r2):
    """Squared Sampson distance, (..., N)."""
    x1 = jnp.concatenate([r1, jnp.ones_like(r1[..., :1])], -1)
    x2 = jnp.concatenate([r2, jnp.ones_like(r2[..., :1])], -1)
    ex1 = einsum("...ij,...nj->...ni", e, x1)
    etx2 = einsum("...ji,...nj->...ni", e, x2)
    num = einsum("...ni,...ni->...n", x2, ex1) ** 2
    den = (
        ex1[..., 0] ** 2 + ex1[..., 1] ** 2
        + etx2[..., 0] ** 2 + etx2[..., 1] ** 2
    )
    return num / jnp.where(den < 1e-12, 1e-12, den)


def fit_essential_weighted(r1, r2, weights):
    """8-point fit over every row of (N, 2) normalized coords, row i
    scaled by ``weights[i]`` (0 drops it), projected to the essential
    manifold: the refit on a known inlier set."""
    dt = r1.dtype
    w = weights.astype(dt)[:, None]
    x1, y1 = r1[..., 0], r1[..., 1]
    x2, y2 = r2[..., 0], r2[..., 1]
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
         jnp.ones_like(x1)], -1
    ) * w
    _, _, vt = jnp.linalg.svd(a, full_matrices=True)
    e = vt[-1].reshape(3, 3)
    u, s, vh = jnp.linalg.svd(e)
    sm = (s[0] + s[1]) * 0.5
    return matmul(u, jnp.asarray([sm, sm, 0.0], dt)[:, None] * vh)


@partial(jax.jit, static_argnames=("n_hypotheses",))
def ransac_essential(
    key,
    r1: jnp.ndarray,       # (N, 2) normalized image coords, frame 1
    r2: jnp.ndarray,       # (N, 2) frame 2
    valid: jnp.ndarray,    # (N,)
    threshold: float = 1e-3,
    n_hypotheses: int = 512,
):
    """Batched 8-point RANSAC. Returns (E, inlier_mask, n_inliers)."""
    dt = _dtype()
    r1 = r1.astype(dt)
    r2 = r2.astype(dt)
    idx = _sample_indices(key, n_hypotheses, 8, r1.shape[0], valid)
    e = fit_essential_8pt(r1[idx], r2[idx])
    err = sampson_error(e, r1[None], r2[None])
    inl = (err < threshold) & valid[None]
    scores = inl.sum(axis=1)
    best = jnp.argmax(scores)
    e_best = e[best]
    mask = inl[best]

    # Refit on the best inlier set (zero-weighted rows).
    e_r = fit_essential_weighted(r1, r2, mask)
    err_r = sampson_error(e_r[None], r1[None], r2[None])[0]
    inl_r = (err_r < threshold) & valid
    better = inl_r.sum() >= mask.sum()
    e_out = jnp.where(better, e_r, e_best)
    mask_out = jnp.where(better, inl_r, mask)
    return e_out, mask_out, mask_out.sum()


def decompose_essential(e, r1, r2, valid):
    """E -> (R, t) with cheirality voting over the 4 candidates.

    Returns (R (3,3), t (3,) unit, n_in_front).
    """
    u, _, vh = jnp.linalg.svd(e)
    # Ensure proper rotations.
    u = u * jnp.sign(jnp.linalg.det(u))
    vh = vh * jnp.sign(jnp.linalg.det(vh))[..., None]
    w = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    e.dtype)
    r_a = matmul(matmul(u, w), vh)
    r_b = matmul(matmul(u, w.T), vh)
    t_u = u[..., :, 2]

    def count_front(r, t):
        # Triangulate (midpoint-free: depth signs from two-view geometry).
        x1 = jnp.concatenate([r1, jnp.ones_like(r1[..., :1])], -1)
        x2 = jnp.concatenate([r2, jnp.ones_like(r2[..., :1])], -1)
        rx1 = einsum("ij,nj->ni", r, x1)
        # Solve for depths: z2 * x2 = z1 * R x1 + t (least squares 2x2).
        a11 = jnp.sum(rx1 * rx1, -1)
        a12 = -jnp.sum(rx1 * x2, -1)
        a22 = jnp.sum(x2 * x2, -1)
        b1 = -jnp.sum(rx1 * t, -1)
        b2 = jnp.sum(x2 * t, -1)
        det = a11 * a22 - a12 * a12
        det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
        z1 = (a22 * b1 - a12 * b2) / det
        z2 = (a11 * b2 - a12 * b1) / det
        return jnp.sum((z1 > 0) & (z2 > 0) & valid)

    cands = [(r_a, t_u), (r_a, -t_u), (r_b, t_u), (r_b, -t_u)]
    counts = jnp.stack([count_front(r, t) for r, t in cands])
    best = jnp.argmax(counts)
    rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    return rs[best], ts[best], counts[best]


@partial(jax.jit, static_argnames=("iterations",))
def refine_relative_pose(
    r0: jnp.ndarray,        # (3, 3) initial rotation (p2 = R p1 + t)
    t0: jnp.ndarray,        # (3,) initial unit translation
    r1_pts: jnp.ndarray,    # (N, 2) normalized coords frame 1
    r2_pts: jnp.ndarray,    # (N, 2) frame 2
    weights: jnp.ndarray,   # (N,) 0/1 inlier weights
    iterations: int = 10,
    damping: float = 1e-6,
):
    """Gauss-Newton refinement of (R, t) on the Sampson error.

    Tightens the f32 8-point estimate by 1-2 orders of magnitude (the
    monocular scale stays fixed by renormalizing t each step). Returns
    (R, t_unit, final_cost).
    """
    from ethzasl_brisk_jax.ba.se3 import hat, so3_exp

    dt = r1_pts.dtype
    x1 = jnp.concatenate([r1_pts, jnp.ones_like(r1_pts[:, :1])], -1)
    x2 = jnp.concatenate([r2_pts, jnp.ones_like(r2_pts[:, :1])], -1)

    def residuals(params, r_base, t_base):
        dr = so3_exp(params[:3][None])[0]
        r = matmul(dr, r_base)
        t = t_base + params[3:]
        t = t / jnp.maximum(jnp.linalg.norm(t), 1e-9)
        e = matmul(hat(t[None])[0], r)
        ex1 = matmul(x1, e.T)
        etx2 = matmul(x2, e)
        num = jnp.sum(x2 * ex1, -1)
        den = (
            ex1[:, 0] ** 2 + ex1[:, 1] ** 2
            + etx2[:, 0] ** 2 + etx2[:, 1] ** 2
        )
        return num / jnp.sqrt(jnp.maximum(den, 1e-12)) * weights

    def step(_, state):
        r_base, t_base, cost = state
        zero = jnp.zeros((6,), dt)
        res = residuals(zero, r_base, t_base)
        jac = jax.jacfwd(residuals)(zero, r_base, t_base)  # (N, 6)
        h = matmul(jac.T, jac) + damping * jnp.eye(6, dtype=dt)
        g = matmul(jac.T, res)
        delta = -jnp.linalg.solve(h, g)
        dr = so3_exp(delta[:3][None])[0]
        r_new = matmul(dr, r_base)
        t_new = t_base + delta[3:]
        t_new = t_new / jnp.maximum(jnp.linalg.norm(t_new), 1e-9)
        new_cost = jnp.sum(residuals(zero, r_new, t_new) ** 2)
        better = new_cost < cost
        return (
            jnp.where(better, r_new, r_base),
            jnp.where(better, t_new, t_base),
            jnp.where(better, new_cost, cost),
        )

    cost0 = jnp.sum(residuals(jnp.zeros((6,), dt), r0, t0) ** 2)
    r, t, cost = jax.lax.fori_loop(0, iterations, step, (r0, t0, cost0))
    return r, t, cost


@partial(jax.jit, static_argnames=("iterations",))
def pose_from_inliers(r1, r2, inliers, iterations: int = 10):
    """Relative pose (R, t_unit) with p2 = R p1 + t from a known inlier
    set: weighted 8-point refit, cheirality decomposition, then
    ``iterations`` Gauss-Newton Sampson steps — the deterministic tail
    of the VO's relative pose once RANSAC has voted."""
    e = fit_essential_weighted(r1, r2, inliers)
    r, t, _ = decompose_essential(e, r1, r2, inliers)
    if iterations:
        r, t, _ = refine_relative_pose(
            r, t, r1, r2, inliers.astype(r1.dtype), iterations=iterations
        )
    return r, t
