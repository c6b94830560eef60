"""GPU-only checks: the jitted steps on the card against the same steps on
the CPU. They skip without a GPU; ``python chip_smoke.py`` runs them on
the card (or, there: ``python -m pytest -m gpu tests/test_gpu.py``).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu_cpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; run on the card via chip_smoke.py")
    return dev, jax.devices("cpu")[0]


def test_harris_step_gpu_matches_cpu(gpu_cpu):
    import jax

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.parallel import FramePipeline, make_mesh
    from ethzasl_brisk_jax.utils.backend_parity import compare, step_outputs

    # The bench configuration on a 4-frame batch of its seeded frames.
    feature = workloads.harris_feature()
    frames = workloads.seeded_frames(4)
    outs = []
    for dev in gpu_cpu:
        mesh = make_mesh(1, 1, devices=[dev])
        with mesh:
            out = FramePipeline(feature=feature, mesh=mesh).step(
                jax.device_put(frames, dev)
            )
        outs.append(step_outputs(*jax.device_get(out)))
    fails, seen = compare(outs[1], outs[0])
    assert not fails, (fails, seen)
    assert seen["n_valid"] > 100


def test_window_ba_gpu_matches_cpu(gpu_cpu):
    import jax

    from ethzasl_brisk_jax import workloads
    from ethzasl_brisk_jax.ba import solve_window_ba

    problem = workloads.synthetic_ba_problem(seed=3)
    outs = [
        jax.device_get(solve_window_ba(
            jax.device_put(problem, dev), iterations=10,
            fix_poses=workloads.BA_FIXED_POSES,
        ))
        for dev in gpu_cpu
    ]
    (pg, cg), (pc, cc) = outs
    # Bounds and their reasons: chip_smoke.py, BA_MAX_*.
    for f, atol in (("r", 1e-4), ("t", 1e-4), ("points", 1e-3)):
        np.testing.assert_allclose(
            np.asarray(getattr(pg, f)), np.asarray(getattr(pc, f)),
            atol=atol, err_msg=f,
        )
    assert max(float(cg[-1]), float(cc[-1])) < 1e-3
