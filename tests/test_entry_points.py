"""Entry-point plumbing that runs on the CPU: the compile-cache helper,
the refusal of chip_smoke.py and bench.py without a GPU, and the
GPU-vs-CPU parity comparator's bounds."""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


class TestCompileCache:
    @pytest.fixture
    def restore_cache_dir(self):
        import jax

        before = jax.config.jax_compilation_cache_dir
        yield
        jax.config.update("jax_compilation_cache_dir", before)

    def test_env_set_is_used_and_nothing_is_set(
        self, monkeypatch, restore_cache_dir, tmp_path
    ):
        import jax

        from ethzasl_brisk_jax.utils.compile_cache import use_compile_cache

        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        jax.config.update("jax_compilation_cache_dir", "sentinel")
        assert use_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "sentinel"

    def test_env_unset_uses_checkout_dir(self, monkeypatch, restore_cache_dir):
        import jax

        from ethzasl_brisk_jax.utils.compile_cache import use_compile_cache

        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = str(ROOT / ".jax_cache")
        assert use_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _assert_refused(proc):
    assert proc.returncode != 0, proc.stdout[-2000:]
    lines = proc.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_without_gpu(script):
    proc = _run([script], ROOT)
    _assert_refused(proc)
    assert "GPU" in proc.stderr, proc.stderr[-2000:]


def test_chip_smoke_alone_refuses(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    _assert_refused(_run(["chip_smoke.py"], tmp_path))


def _outputs(n=200, seed=0):
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < 0.8
    return dict(
        x=rng.uniform(0, 640, n).astype(np.float32),
        y=rng.uniform(0, 480, n).astype(np.float32),
        size=np.full(n, 12.0, np.float32),
        angle=rng.uniform(-180, 180, n).astype(np.float32),
        response=rng.uniform(0, 1e4, n).astype(np.float32),
        octave=np.zeros(n, np.int32),
        valid=valid,
        desc=rng.integers(0, 2**32, (n, 12), dtype=np.uint32),
        match_idx=rng.integers(0, n, n).astype(np.int32),
        match_dist=rng.integers(0, 385, n).astype(np.int32),
    )


def _nudge_ulp(a, idx, ulps):
    bits = a.view(np.int32).copy()
    bits[idx] += ulps
    return bits.view(np.float32)


def _first_valid(ref, k):
    return np.flatnonzero(ref["valid"])[:k]


@pytest.mark.parametrize(
    "case, ok",
    [
        ("identical", True),
        ("x_1ulp_within_share", True),
        ("x_2ulp", False),
        ("y_1ulp_past_share", False),
        ("angle_at_bound", True),
        ("angle_past_bound", False),
        ("desc_one_bit", False),
        ("valid_flip", False),
        ("response_1ulp", False),
        ("match_idx_diff", False),
        ("invalid_slot_x_ignored", True),
        ("ast_size_within_rel", True),
        ("ast_response_past_rel", False),
        ("ast_octave_diff", False),
    ],
)
def test_parity_comparator_bounds(case, ok):
    from ethzasl_brisk_jax.utils import backend_parity as bp

    ref = _outputs()
    got = {k: v.copy() for k, v in ref.items()}
    n_valid = int(ref["valid"].sum())
    if case == "x_1ulp_within_share":
        k = int(bp.XY_MAX_SHARE * n_valid)  # at the share bound
        got["x"] = _nudge_ulp(got["x"], _first_valid(ref, k), 1)
        assert k >= 1
    elif case == "x_2ulp":
        got["x"] = _nudge_ulp(got["x"], _first_valid(ref, 1), 2)
    elif case == "y_1ulp_past_share":
        k = int(bp.XY_MAX_SHARE * n_valid) + 1
        got["y"] = _nudge_ulp(got["y"], _first_valid(ref, k), 1)
    elif case == "angle_at_bound":
        i = _first_valid(ref, 1)
        ref["angle"][i] = 10.0
        got["angle"][i] = 10.0 + bp.ANGLE_MAX_DEG * 0.999
    elif case == "angle_past_bound":
        i = _first_valid(ref, 1)
        ref["angle"][i] = 10.0
        got["angle"][i] = 10.0 + bp.ANGLE_MAX_DEG * 1.01
    elif case == "desc_one_bit":
        got["desc"][3, 5] ^= 1
    elif case == "valid_flip":
        got["valid"][0] = ~got["valid"][0]
    elif case == "response_1ulp":
        got["response"] = _nudge_ulp(got["response"], [0], 1)
    elif case == "match_idx_diff":
        got["match_idx"][7] += 1
    elif case == "invalid_slot_x_ignored":
        i = np.flatnonzero(~ref["valid"])[:1]
        got["x"] = _nudge_ulp(got["x"], i, 1000)
    elif case == "ast_size_within_rel":
        got["size"] = got["size"] * np.float32(1 + 0.5 * bp.AST_REFINED_REL)
        got["x"] = _nudge_ulp(got["x"], _first_valid(ref, 50), 3)
    elif case == "ast_response_past_rel":
        i = _first_valid(ref, 1)
        got["response"][i] = ref["response"][i] * (1 + 2 * bp.AST_REFINED_REL)
    elif case == "ast_octave_diff":
        got["octave"][_first_valid(ref, 1)] += 1
    rel = bp.AST_REFINED_REL if case.startswith("ast_") else None
    fails, seen = bp.compare(ref, got, rel)
    assert (not fails) == ok, (fails, seen)


@pytest.mark.parametrize("n_valid, ok", [(11, True), (12, False)])
def test_describe_budget_certificate(n_valid, ok):
    """A compacting step whose budget is full may have dropped
    keypoints: the certificate refuses it."""
    import jax.numpy as jnp

    from ethzasl_brisk_jax.core.keypoints import KeyPoints
    from ethzasl_brisk_jax.workloads import (
        CapacityError,
        certify_describe_budget,
    )

    b, k, cap = 3, 10, 4  # budget: 12 described slots
    valid = np.zeros(b * k, bool)
    valid[:n_valid] = True
    z = jnp.zeros((b, k), jnp.float32)
    kps = KeyPoints(x=z, y=z, size=z, angle=z, response=z,
                    octave=jnp.zeros((b, k), jnp.int32),
                    valid=jnp.asarray(valid.reshape(b, k)))
    if ok:
        assert certify_describe_budget(kps, cap) == n_valid
    else:
        with pytest.raises(CapacityError):
            certify_describe_budget(kps, cap)
