"""Checkpoint/resume of BA map state (orbax): SURVEY.md section 5's
failure-recovery equivalent. The reference has no counterpart; the test
models a preempted sequence run resuming from the latest step."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from ethzasl_brisk_jax.utils.checkpoint import (  # noqa: E402
    CheckpointManager,
    MapState,
    state_from_ba_problem,
    trajectory_to_state,
)


def test_mapstate_roundtrip(tmp_path):
    state = MapState.empty(n_kf=4, n_lm=16, n_obs=32)
    state = MapState(
        r=state.r,
        t=state.t.at[1].set(jnp.asarray([1.0, 2.0, 3.0])),
        kf_frame=state.kf_frame.at[0].set(7),
        points=state.points.at[3].set(jnp.asarray([0.1, 0.2, 0.3])),
        kf_idx=state.kf_idx,
        lm_idx=state.lm_idx.at[5].set(3),
        uv=state.uv.at[5].set(jnp.asarray([100.0, 50.0])),
        valid=state.valid.at[5].set(True),
        frame_idx=jnp.asarray(42, jnp.int32),
    )

    with CheckpointManager(tmp_path / "ckpt") as mgr:
        mgr.save(3, state)
        mgr.wait()
        assert mgr.latest_step() == 3
        template = MapState.empty(n_kf=4, n_lm=16, n_obs=32)
        restored, next_step = mgr.restore_or_init(template)

    assert next_step == 4
    for f in state.__dataclass_fields__:
        a = np.asarray(getattr(state, f))
        b = np.asarray(getattr(restored, f))
        assert np.array_equal(a, b), f"field {f} mismatch"


def test_restore_or_init_fresh(tmp_path):
    template = MapState.empty(2, 4, 8)
    with CheckpointManager(tmp_path / "fresh") as mgr:
        state, step = mgr.restore_or_init(template)
    assert step == 0
    assert state is template


def test_resume_continues_ba(tmp_path):
    """Preemption model: solve 2 GN iterations, checkpoint, 'crash',
    restore, run 2 more — final state identical to 4 straight."""
    from ethzasl_brisk_jax.ba.window import BaProblem, solve_window_ba

    rng = np.random.default_rng(3)
    n_kf, n_lm = 3, 12
    pts = rng.uniform([-2, -2, 4], [2, 2, 8], (n_lm, 3)).astype(np.float32)
    r = np.tile(np.eye(3, dtype=np.float32), (n_kf, 1, 1))
    t = np.stack(
        [np.array([0.3 * k, 0, 0], np.float32) for k in range(n_kf)]
    )
    kf_idx = np.repeat(np.arange(n_kf, dtype=np.int32), n_lm)
    lm_idx = np.tile(np.arange(n_lm, dtype=np.int32), n_kf)
    cam = pts[lm_idx] @ np.transpose(r[kf_idx], (0, 2, 1)) + t[kf_idx]
    # camera-from-world: x_cam = R x + t (R=I here)
    cam = pts[lm_idx] + t[kf_idx]
    uv = 500.0 * cam[:, :2] / cam[:, 2:3] + np.array([320.0, 240.0])
    uv += rng.normal(0, 0.5, uv.shape)

    def mk(points):
        return BaProblem(
            r=jnp.asarray(r), t=jnp.asarray(t),
            points=jnp.asarray(points),
            kf_idx=jnp.asarray(kf_idx), lm_idx=jnp.asarray(lm_idx),
            uv=jnp.asarray(uv.astype(np.float32)),
            valid=jnp.ones((len(kf_idx),), bool),
            fu=jnp.float32(500.0), fv=jnp.float32(500.0),
            cu=jnp.float32(320.0), cv=jnp.float32(240.0),
        )

    noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)

    # Straight-through 4 iterations.
    ref, _ = solve_window_ba(mk(noisy), iterations=4)

    # 2 iterations, checkpoint, restore, 2 more.
    half, _ = solve_window_ba(mk(noisy), iterations=2)
    state = state_from_ba_problem(
        half, kf_frame=np.arange(n_kf), frame_idx=100
    )
    with CheckpointManager(tmp_path / "ba") as mgr:
        mgr.save(0, state)
        mgr.wait()
        template = MapState.empty(n_kf, n_lm, len(kf_idx))
        template = state_from_ba_problem(
            mk(noisy), kf_frame=np.zeros(n_kf), frame_idx=0
        )
        restored, _ = mgr.restore_or_init(template)

    import dataclasses

    prob2 = dataclasses.replace(
        mk(np.asarray(restored.points)), r=restored.r, t=restored.t
    )
    resumed, _ = solve_window_ba(prob2, iterations=2)
    assert int(np.asarray(restored.frame_idx)) == 100
    np.testing.assert_allclose(
        np.asarray(resumed.points), np.asarray(ref.points),
        rtol=0, atol=5e-4,
    )


def test_trajectory_state_pack():
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[2, 0, 3] = 1.5
    st = trajectory_to_state(poses, frame_idx=5, capacity=8)
    assert st["poses"].shape == (8, 4, 4)
    assert float(st["poses"][2, 0, 3]) == 1.5
    assert int(st["n"]) == 5
