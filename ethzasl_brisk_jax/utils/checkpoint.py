"""Orbax checkpoint/resume for BA / map state (failure recovery).

The reference has no failure-detection or elastic layer (it is a
single-process library; SURVEY.md section 5). The equivalent named
there is orbax-style checkpoints of the mapping state — keyframe poses,
landmarks and the observation structure — so a long sequence run
(config 3-5) survives worker preemption: restore the latest step and
continue from the next frame.

Design notes:
* The map state is one registered-dataclass pytree (``MapState``) of
  fixed-capacity arrays — the same static-shape discipline as the BA
  solver, so a restored state feeds straight back into jitted code with
  no recompilation.
* ``CheckpointManager`` wraps ``orbax.checkpoint.CheckpointManager``
  with the standard pytree handler; saves are async-capable but we
  ``wait_until_finished`` on close for determinism in tests/harnesses.
* ``restore_or_init`` is the resume entry: returns (state, next_step).
"""
from __future__ import annotations

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MapState:
    """Fixed-capacity sliding map: keyframe poses + landmarks + tracks.

    Mirrors what the kitti_eval/sequence harness accumulates between
    window-BA solves; everything a resume needs to continue the frame
    loop at ``frame_idx``.
    """

    r: jax.Array          # (K, 3, 3) keyframe camera-from-world rotations
    t: jax.Array          # (K, 3)
    kf_frame: jax.Array   # (K,) int32 source frame index, -1 = empty
    points: jax.Array     # (L, 3) world landmarks
    kf_idx: jax.Array     # (O,) int32 observation -> keyframe slot
    lm_idx: jax.Array     # (O,) int32 observation -> landmark slot
    uv: jax.Array         # (O, 2) f32 observed pixels
    valid: jax.Array      # (O,) bool
    frame_idx: jax.Array  # () int32 next frame to process

    @staticmethod
    def empty(n_kf: int, n_lm: int, n_obs: int) -> "MapState":
        return MapState(
            r=jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                               (n_kf, 3, 3)),
            t=jnp.zeros((n_kf, 3), jnp.float32),
            kf_frame=jnp.full((n_kf,), -1, jnp.int32),
            points=jnp.zeros((n_lm, 3), jnp.float32),
            kf_idx=jnp.zeros((n_obs,), jnp.int32),
            lm_idx=jnp.zeros((n_obs,), jnp.int32),
            uv=jnp.zeros((n_obs, 2), jnp.float32),
            valid=jnp.zeros((n_obs,), bool),
            frame_idx=jnp.zeros((), jnp.int32),
        )


class CheckpointManager:
    """Thin orbax wrapper: save/restore any pytree of arrays by step."""

    def __init__(self, directory, max_to_keep: int = 3):
        import orbax.checkpoint as ocp

        self._ocp = ocp
        path = pathlib.Path(directory).resolve()
        path.mkdir(parents=True, exist_ok=True)
        self._mgr = ocp.CheckpointManager(
            path,
            options=ocp.CheckpointManagerOptions(
                max_to_keep=max_to_keep, create=True
            ),
        )

    def save(self, step: int, state) -> None:
        self._mgr.save(
            step, args=self._ocp.args.StandardSave(state)
        )

    def latest_step(self):
        return self._mgr.latest_step()

    def restore(self, step: int, template):
        """Restore into the shape/dtype structure of ``template``."""
        return self._mgr.restore(
            step, args=self._ocp.args.StandardRestore(template)
        )

    def restore_latest(self):
        """Restore the latest step WITHOUT a template: (state, step) or
        (None, None). Custom pytree nodes come back as plain dicts."""
        step = self.latest_step()
        if step is None:
            return None, None
        return (
            self._mgr.restore(
                step, args=self._ocp.args.StandardRestore()
            ),
            int(step),
        )

    def restore_or_init(self, template):
        """Resume entry: (state, next_step). Fresh start -> (template, 0)."""
        step = self.latest_step()
        if step is None:
            return template, 0
        return self.restore(step, template), int(step) + 1

    def wait(self) -> None:
        self._mgr.wait_until_finished()

    def close(self) -> None:
        self._mgr.wait_until_finished()
        self._mgr.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def state_from_ba_problem(problem, kf_frame, frame_idx) -> MapState:
    """Pack a ba.window.BaProblem + bookkeeping into a MapState."""
    return MapState(
        r=problem.r, t=problem.t,
        kf_frame=jnp.asarray(kf_frame, jnp.int32),
        points=problem.points,
        kf_idx=problem.kf_idx, lm_idx=problem.lm_idx,
        uv=problem.uv, valid=problem.valid,
        frame_idx=jnp.asarray(frame_idx, jnp.int32),
    )


def pack_vo_loop_state(
    *, poses, frame_idx, key, prev, kf, window: int, n_frames: int,
    n_ba_runs: int,
) -> dict:
    """Snapshot the kitti_eval/sequence frame-loop state as one pytree.

    ``kf`` is the harness's keyframe list (dicts with frame/kp/desc/
    match_to_prev); only the trailing ``window`` entries matter for
    future window-BA solves, so only those are saved (stacked).
    """
    import jax.numpy as jnp

    traj = trajectory_to_state(poses, frame_idx, capacity=n_frames)
    tail = kf[-window:]
    n_tail = len(tail)
    kp_cap = int(np.asarray(prev[0].x).shape[-1]) if prev else 0

    def stack_field(get, fill, dtype):
        rows = [np.asarray(get(e)) for e in tail]
        out = np.full((window, kp_cap), fill, dtype)
        for i, row in enumerate(rows):
            out[i, : row.shape[-1]] = row
        return jnp.asarray(out)

    state = dict(
        **traj,
        key=key,
        n_ba_runs=jnp.asarray(n_ba_runs, jnp.int32),
        n_kf_tail=jnp.asarray(n_tail, jnp.int32),
        kf_frame=jnp.asarray(
            np.array(
                [e["frame"] for e in tail] + [-1] * (window - n_tail),
                np.int32,
            )
        ),
    )
    if prev is not None:
        # Plain dict (not the KeyPoints node) so a template-free restore
        # round-trips the structure.
        state["prev_kp"] = {
            f: getattr(prev[0], f)
            for f in prev[0].__dataclass_fields__
        }
        state["prev_desc"] = prev[1]
    if tail:
        for f in ("x", "y", "size", "angle", "response"):
            state[f"kf_{f}"] = stack_field(
                lambda e, f=f: getattr(e["kp"], f), 0.0, np.float32
            )
        state["kf_octave"] = stack_field(
            lambda e: e["kp"].octave, 0, np.int32
        )
        state["kf_valid"] = stack_field(
            lambda e: e["kp"].valid, False, bool
        )
        dw = np.asarray(tail[0]["desc"]).shape[-1]
        descs = np.zeros((window, kp_cap, dw), np.uint32)
        match_b = np.zeros((window, kp_cap), np.int32)
        match_m = np.zeros((window, kp_cap), bool)
        has_match = np.zeros((window,), bool)
        for i, e in enumerate(tail):
            descs[i] = np.asarray(e["desc"])
            if e["match_to_prev"] is not None:
                b, m = e["match_to_prev"]
                match_b[i] = np.asarray(b)
                match_m[i] = np.asarray(m)
                has_match[i] = True
        state["kf_desc"] = jnp.asarray(descs)
        state["kf_match_b"] = jnp.asarray(match_b)
        state["kf_match_m"] = jnp.asarray(match_m)
        state["kf_has_match"] = jnp.asarray(has_match)
    return state


def unpack_vo_loop_state(state: dict):
    """Inverse of pack_vo_loop_state.

    Returns (poses list, frame_idx, key, prev, kf list, n_ba_runs).
    """
    from ethzasl_brisk_jax.core.keypoints import KeyPoints

    n = int(np.asarray(state["n"]))
    poses = [np.asarray(p) for p in np.asarray(state["poses"])[:n]]
    frame_idx = int(np.asarray(state["frame_idx"]))
    n_ba_runs = int(np.asarray(state["n_ba_runs"]))
    prev = None
    if "prev_kp" in state:
        pk = state["prev_kp"]
        prev = (KeyPoints(**pk), state["prev_desc"])
    kf = []
    if "kf_desc" in state:
        n_tail = int(np.asarray(state["n_kf_tail"]))
        for i in range(n_tail):
            kp = KeyPoints(
                x=state["kf_x"][i], y=state["kf_y"][i],
                size=state["kf_size"][i], angle=state["kf_angle"][i],
                response=state["kf_response"][i],
                octave=state["kf_octave"][i],
                valid=state["kf_valid"][i],
            )
            match = None
            if bool(np.asarray(state["kf_has_match"][i])):
                match = (
                    np.asarray(state["kf_match_b"][i]),
                    np.asarray(state["kf_match_m"][i]),
                )
            kf.append(
                dict(
                    frame=int(np.asarray(state["kf_frame"][i])),
                    kp=kp,
                    desc=state["kf_desc"][i],
                    match_to_prev=match,
                )
            )
    return poses, frame_idx, state["key"], prev, kf, n_ba_runs


def trajectory_to_state(poses_wfc, frame_idx, capacity=None) -> dict:
    """Checkpointable dict for a plain trajectory run (sequence_eval):
    (N, 4, 4) world-from-camera poses padded to ``capacity``."""
    poses = np.asarray(poses_wfc, np.float32)
    n = poses.shape[0]
    cap = capacity or n
    out = np.tile(np.eye(4, dtype=np.float32), (cap, 1, 1))
    out[:n] = poses
    return {
        "poses": jnp.asarray(out),
        "n": jnp.asarray(n, jnp.int32),
        "frame_idx": jnp.asarray(frame_idx, jnp.int32),
    }
