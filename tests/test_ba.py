"""Bundle-adjustment tests: SE(3) round-trips and synthetic window BA."""
import pathlib

import numpy as np
import pytest

pytestmark = pytest.mark.quick


class TestSe3:
    def test_exp_log_roundtrip(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.ba import se3_exp, se3_log

        rng = np.random.default_rng(0)
        xi = jnp.asarray(rng.uniform(-1, 1, (64, 6)), jnp.float32)
        r, t = se3_exp(xi)
        xi2 = se3_log(r, t)
        np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi),
                                   atol=2e-5)

    def test_rotation_proper(self):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.ba import so3_exp

        rng = np.random.default_rng(1)
        w = jnp.asarray(rng.uniform(-2, 2, (32, 3)), jnp.float32)
        r = np.asarray(so3_exp(w))
        np.testing.assert_allclose(
            r @ r.transpose(0, 2, 1), np.broadcast_to(np.eye(3), r.shape),
            atol=1e-5,
        )
        np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)


class TestWindowBa:
    def _make_problem(self, noise_pose, noise_pt, rng):
        import jax.numpy as jnp

        from ethzasl_brisk_jax.ba import BaProblem, so3_exp

        k, n_lm = 6, 200
        fu = fv = 400.0
        cu, cv = 320.0, 240.0
        # Ground truth: poses along x, points in front.
        t_gt = np.stack(
            [np.linspace(0, 1.0, k), np.zeros(k), np.zeros(k)], 1
        )
        r_gt = np.broadcast_to(np.eye(3), (k, 3, 3)).copy()
        pts_gt = rng.uniform([-3, -2, 4], [3, 2, 10], (n_lm, 3))

        # Observations: every point seen by every pose (dense window).
        kf = np.repeat(np.arange(k), n_lm)
        lm = np.tile(np.arange(n_lm), k)
        x_c = pts_gt[lm] @ r_gt[kf].transpose(0, 2, 1).reshape(-1, 3, 3)[0].T
        # camera-from-world: x_c = R (x_w) + t with R=I here -> x_w - (-t)?
        # Convention: x_c = R x_w + t, t = -R c. Use c = t_gt (camera
        # centers), so t = -c.
        t_cam = -t_gt
        x_c = pts_gt[lm] + t_cam[kf]
        u = fu * x_c[:, 0] / x_c[:, 2] + cu
        v = fv * x_c[:, 1] / x_c[:, 2] + cv
        uv = np.stack([u, v], 1)

        # Noisy initialization.
        w_noise = rng.normal(0, noise_pose, (k, 3)).astype(np.float32)
        w_noise[0] = 0
        r0 = np.asarray(so3_exp(jnp.asarray(w_noise))) @ r_gt
        t0 = t_cam + rng.normal(0, noise_pose, (k, 3))
        t0[0] = t_cam[0]
        pts0 = pts_gt + rng.normal(0, noise_pt, (n_lm, 3))

        f32 = jnp.float32
        return BaProblem(
            r=jnp.asarray(r0, f32),
            t=jnp.asarray(t0, f32),
            points=jnp.asarray(pts0, f32),
            kf_idx=jnp.asarray(kf, jnp.int32),
            lm_idx=jnp.asarray(lm, jnp.int32),
            uv=jnp.asarray(uv, f32),
            valid=jnp.ones((len(kf),), bool),
            fu=f32(fu), fv=f32(fv), cu=f32(cu), cv=f32(cv),
        ), (r_gt, t_cam, pts_gt)

    def test_converges(self):
        from ethzasl_brisk_jax.ba import solve_window_ba
        from ethzasl_brisk_jax.ba.window import _residual_and_jacobians

        rng = np.random.default_rng(2)
        prob, gt = self._make_problem(0.02, 0.10, rng)

        res0, _, _, w0 = _residual_and_jacobians(prob)
        rms0 = float(
            np.sqrt(
                (np.asarray(res0) ** 2).sum(1)[np.asarray(w0) > 0].mean()
            )
        )
        solved, costs = solve_window_ba(prob, iterations=12, damping=1e-3)
        res1, _, _, w1 = _residual_and_jacobians(solved)
        rms1 = float(
            np.sqrt(
                (np.asarray(res1) ** 2).sum(1)[np.asarray(w1) > 0].mean()
            )
        )
        assert rms0 > 1.0      # the start really is perturbed
        assert rms1 < 0.02, (rms0, rms1)
        costs = np.asarray(costs)
        assert costs[-1] < costs[0] * 1e-4

    def test_lm_converges_and_is_monotone(self):
        from ethzasl_brisk_jax.ba import (
            robust_cost,
            solve_window_ba_lm,
        )
        from ethzasl_brisk_jax.ba.window import _residual_and_jacobians

        rng = np.random.default_rng(3)
        prob, _ = self._make_problem(0.02, 0.10, rng)
        cost0 = float(robust_cost(prob))
        solved, costs, lams = solve_window_ba_lm(
            prob, iterations=14, damping=1e-3
        )
        costs = np.asarray(costs)
        # Monotone non-increasing accepted cost, large total decrease.
        assert (np.diff(np.concatenate([[cost0], costs])) <= 0).all()
        assert costs[-1] < cost0 * 1e-4
        res1, _, _, w1 = _residual_and_jacobians(solved)
        rms1 = float(
            np.sqrt(
                (np.asarray(res1) ** 2).sum(1)[np.asarray(w1) > 0].mean()
            )
        )
        assert rms1 < 0.02, rms1

    def test_lm_cannot_diverge_on_degenerate_geometry(self):
        """Planar scene, near-zero parallax: fixed-damping GN can run
        away along the unconstrained direction; LM must reject those
        steps and keep the objective non-increasing (replaces the
        post-hoc --ba-max-shift gate)."""
        import jax.numpy as jnp

        from ethzasl_brisk_jax.ba import (
            BaProblem,
            robust_cost,
            solve_window_ba_lm,
        )

        rng = np.random.default_rng(7)
        k, n_lm = 6, 120
        fu = fv = 400.0
        cu, cv = 320.0, 240.0
        # All landmarks on one plane z=6, camera centers almost
        # coincident (baseline ~1e-4: no parallax).
        pts_gt = np.concatenate(
            [rng.uniform(-3, 3, (n_lm, 2)), np.full((n_lm, 1), 6.0)], 1
        )
        t_cam = np.zeros((k, 3))
        t_cam[:, 0] = -np.linspace(0, 1e-4, k)
        kf = np.repeat(np.arange(k), n_lm)
        lm = np.tile(np.arange(n_lm), k)
        x_c = pts_gt[lm] + t_cam[kf]
        uv = np.stack(
            [fu * x_c[:, 0] / x_c[:, 2] + cu,
             fv * x_c[:, 1] / x_c[:, 2] + cv], 1
        ) + rng.normal(0, 0.3, (len(kf), 2))
        f32 = jnp.float32
        prob = BaProblem(
            r=jnp.asarray(np.broadcast_to(np.eye(3), (k, 3, 3)), f32),
            t=jnp.asarray(t_cam + rng.normal(0, 0.02, (k, 3)), f32),
            points=jnp.asarray(
                pts_gt + rng.normal(0, 0.2, (n_lm, 3)), f32
            ),
            kf_idx=jnp.asarray(kf, jnp.int32),
            lm_idx=jnp.asarray(lm, jnp.int32),
            uv=jnp.asarray(uv, f32),
            valid=jnp.ones((len(kf),), bool),
            fu=f32(fu), fv=f32(fv), cu=f32(cu), cv=f32(cv),
        )
        cost0 = float(robust_cost(prob, 3.0))
        solved, costs, _ = solve_window_ba_lm(
            prob, iterations=12, damping=1e-2, fix_poses=2,
            huber_delta=3.0,
        )
        costs = np.asarray(costs)
        assert np.isfinite(costs).all()
        assert (np.diff(np.concatenate([[cost0], costs])) <= 1e-3).all()
        # No runaway: camera centers stay bounded (the gate this
        # replaces fired on 10^6x explosions).
        c_new = np.einsum(
            "kij,kj->ki",
            -np.asarray(solved.r).transpose(0, 2, 1),
            np.asarray(solved.t),
        )
        assert np.abs(c_new).max() < 1.0, np.abs(c_new).max()

    def test_trimmed_rejects_coherent_outliers(self):
        """A coherent outlier population (tracks on a moving object)
        biases Huber-only LM — the bounded influence never reaches
        zero. The trimmed solver drops them after stage 1 and recovers
        poses closer to ground truth."""
        import jax.numpy as jnp

        from ethzasl_brisk_jax.ba import (
            solve_window_ba_lm,
            solve_window_ba_trimmed,
        )

        import dataclasses as dc

        import jax.numpy as jnp

        rng = np.random.default_rng(9)
        prob, (r_gt, t_gt, _) = self._make_problem(0.01, 0.05, rng)
        # fix_poses=2 anchors the gauge on poses 0 and 1 — give the
        # anchor its TRUE value so the ground-truth comparison below
        # is not polluted by frozen init noise.
        r0 = np.array(prob.r)
        t0 = np.array(prob.t)
        r0[1] = r_gt[1]
        t0[1] = t_gt[1]
        prob = dc.replace(
            prob, r=jnp.asarray(r0, jnp.float32),
            t=jnp.asarray(t0, jnp.float32),
        )
        # 12% of landmarks sit on a MOVING object: their observations
        # shift by a per-pose amount (no single 3D point explains them
        # — a constant shift would just relocate the landmark and be
        # absorbed residual-free).
        n_lm = 200
        bad_lm = rng.choice(n_lm, 24, replace=False)
        bad_obs = np.isin(np.asarray(prob.lm_idx), bad_lm)
        uv = np.array(prob.uv)
        kf_np = np.asarray(prob.kf_idx)
        uv[bad_obs] += np.stack(
            [8.0 * kf_np[bad_obs], 3.0 * kf_np[bad_obs]], 1
        )
        import dataclasses as dc

        prob = dc.replace(prob, uv=jnp.asarray(uv, jnp.float32))

        # fix_poses=2 anchors the monocular scale gauge (as the
        # kitti_eval harness does) — absolute t errors are otherwise
        # not gauge-invariant.
        lm_sol, _, _ = solve_window_ba_lm(
            prob, iterations=12, damping=1e-3, huber_delta=3.0,
            fix_poses=2,
        )
        tr_sol, _, n_trim = solve_window_ba_trimmed(
            prob, iterations=12, damping=1e-3, huber_delta=3.0,
            fix_poses=2,
        )
        # Stage-1 absorbs the mean object motion into the phantom
        # landmark; the trim catches the per-pose deviations around it.
        assert int(n_trim) >= 20, int(n_trim)

        def pose_err(sol):
            return float(
                np.linalg.norm(np.asarray(sol.t) - t_gt, axis=1).max()
            )

        # Trimmed recovers a clearly better solution (0.076 vs 0.142
        # at pin time); some bias remains — the trim re-solve still
        # sees a few absorbed observations — so the bounds are loose.
        assert pose_err(tr_sol) < 0.75 * pose_err(lm_sol), (
            pose_err(tr_sol), pose_err(lm_sol)
        )
        assert pose_err(tr_sol) < 0.1, pose_err(tr_sol)


class TestDistributedBa:
    def test_sharded_matches_single(self):
        """Landmark-sharded BA over an 8-device mesh converges like the
        single-device solver (same problem, same final reprojection)."""
        import jax
        import jax.numpy as jnp

        if len(jax.devices()) < 8:
            import pytest as _pytest

            _pytest.skip("needs 8 virtual devices")

        from ethzasl_brisk_jax.ba import solve_window_ba
        from ethzasl_brisk_jax.ba.window import _residual_and_jacobians
        from ethzasl_brisk_jax.parallel import make_mesh
        from ethzasl_brisk_jax.parallel.dist_ba import (
            partition_problem,
            solve_window_ba_sharded,
        )

        rng = np.random.default_rng(5)
        prob, _ = TestWindowBa()._make_problem(0.02, 0.10, rng)

        single, _ = solve_window_ba(prob, iterations=10, damping=1e-3)
        res_s, _, _, w_s = _residual_and_jacobians(single)
        rms_single = float(
            np.sqrt((np.asarray(res_s) ** 2).sum(1)[np.asarray(w_s) > 0]
                    .mean())
        )

        mesh = make_mesh(1, 8)
        sharded_prob = partition_problem(prob, 8)
        with mesh:
            solved, costs = solve_window_ba_sharded(
                mesh, sharded_prob, iterations=10, damping=1e-3
            )
        res_d, _, _, w_d = _residual_and_jacobians(solved)
        rms_dist = float(
            np.sqrt((np.asarray(res_d) ** 2).sum(1)[np.asarray(w_d) > 0]
                    .mean())
        )
        assert rms_dist < 0.05, (rms_single, rms_dist)
        # Poses agree between single and distributed solves up to the
        # monocular gauge scale (only pose 0 is pinned).
        ts, td = np.asarray(single.t), np.asarray(solved.t)
        scale = np.linalg.norm(ts[1:]) / np.linalg.norm(td[1:])
        np.testing.assert_allclose(td * scale, ts, rtol=5e-3, atol=5e-3)


class TestPoseGraph:
    def test_loop_closure(self):
        """Odometry chain with drift + loop closure: PGO distributes the
        error and closes the loop."""
        import jax.numpy as jnp

        from ethzasl_brisk_jax.ba.pose_graph import (
            PoseGraph,
            optimize_pose_graph,
        )
        from ethzasl_brisk_jax.ba.se3 import so3_exp

        n = 12
        rng = np.random.default_rng(7)
        # Ground truth: poses around a circle.
        angles = np.linspace(0, 2 * np.pi, n, endpoint=False)
        r_gt = np.stack(
            [
                np.array(
                    [
                        [np.cos(a), -np.sin(a), 0],
                        [np.sin(a), np.cos(a), 0],
                        [0, 0, 1],
                    ]
                )
                for a in angles
            ]
        )
        c_gt = np.stack(
            [5 * np.cos(angles), 5 * np.sin(angles), np.zeros(n)], 1
        )
        t_gt = -np.einsum("nij,nj->ni", r_gt, c_gt)

        # Odometry edges (i, i+1) from ground truth; noisy initialization.
        edges_i = np.arange(n - 1)
        edges_j = np.arange(1, n)
        # loop closure n-1 -> 0
        edges_i = np.append(edges_i, n - 1)
        edges_j = np.append(edges_j, 0)
        # rel T_ij = T_i T_j^-1 from GT (note pose_graph convention).
        rel_r = np.einsum(
            "nij,nkj->nik", r_gt[edges_i], r_gt[edges_j]
        )
        rel_t = t_gt[edges_i] - np.einsum(
            "nij,nj->ni", rel_r, t_gt[edges_j]
        )

        w_noise = rng.normal(0, 0.03, (n, 3))
        w_noise[0] = 0
        r0 = np.asarray(so3_exp(jnp.asarray(w_noise, jnp.float32))) @ r_gt
        t0 = t_gt + rng.normal(0, 0.2, (n, 3))
        t0[0] = t_gt[0]

        g = PoseGraph(
            r=jnp.asarray(r0, jnp.float32),
            t=jnp.asarray(t0, jnp.float32),
            edge_i=jnp.asarray(edges_i, jnp.int32),
            edge_j=jnp.asarray(edges_j, jnp.int32),
            rel_r=jnp.asarray(rel_r, jnp.float32),
            rel_t=jnp.asarray(rel_t, jnp.float32),
            weight=jnp.ones((len(edges_i),), jnp.float32),
        )
        out, costs = optimize_pose_graph(g, iterations=15, damping=1e-5)
        costs = np.asarray(costs)
        assert costs[-1] < 1e-6, costs
        np.testing.assert_allclose(
            np.asarray(out.t), t_gt, atol=1e-2
        )

        # Edge-partitioned solve over the virtual 8-device mesh (config-5
        # slice): same solution, psum-reduced assembly.
        from ethzasl_brisk_jax.parallel import make_mesh
        from ethzasl_brisk_jax.parallel.dist_pg import (
            optimize_pose_graph_sharded,
            partition_edges,
        )

        mesh = make_mesh(1, 4)
        with mesh:
            out_s, costs_s = optimize_pose_graph_sharded(
                mesh, partition_edges(g, 4), iterations=15, damping=1e-5
            )
        assert float(costs_s[-1]) < 1e-6, np.asarray(costs_s)
        np.testing.assert_allclose(
            np.asarray(out_s.t), np.asarray(out.t), atol=1e-4
        )
        np.testing.assert_allclose(
            np.asarray(out_s.r), np.asarray(out.r), atol=1e-4
        )


class TestMultiHost:
    def test_two_process_distributed_ba(self, tmp_path):
        """Config-5 slice: jax.distributed across two OS processes (the
        multi-host case), landmark-sharded BA with cross-process psum."""
        import subprocess
        import sys

        out = tmp_path / "mh.txt"
        procs = [
            subprocess.Popen(
                [sys.executable, "tools/multihost_worker.py", str(i), "2",
                 str(out)],
                cwd=pathlib.Path(__file__).resolve().parents[1],
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
            )
            for i in range(2)
        ]
        codes = [p.wait(timeout=420) for p in procs]
        logs = b"\n".join(p.stdout.read() for p in procs)
        assert codes == [0, 0], logs.decode()[-2000:]
        c0, c1, pg_cost, pg_terr = (
            float(v) for v in out.read_text().split()
        )
        assert c0 > 100.0 and c1 < 1e-4, (c0, c1)
        # Partitioned pose graph (cross-process edges psum-reduced):
        # converged and recovered the ground-truth trajectory.
        assert pg_cost < 1e-6 and pg_terr < 1e-2, (pg_cost, pg_terr)
