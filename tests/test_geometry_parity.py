"""The geometry bounds of GPU-vs-CPU parity (utils/backend_parity.py)
sit between last-bit noise and TF32 products: shown here on the CPU,
where TF32 is emulated by rounding every operand of the geometry's
products (utils/precise.py) to 11 significant bits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ethzasl_brisk_jax.geometry.ransac import pose_from_inliers
from ethzasl_brisk_jax.utils import backend_parity as bp
from ethzasl_brisk_jax.utils import precise


def _tf32(x):
    x = jnp.asarray(x)
    if x.dtype != jnp.float32:
        return x
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    bits = (bits + jnp.uint32(0x1000)) & jnp.uint32(0xFFFFE000)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)


class _Tf32Jnp:
    """``jax.numpy`` whose einsum/matmul round their operands to TF32."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, subscripts, *operands, precision=None):
        return jnp.einsum(
            subscripts, *map(_tf32, operands), precision=precision
        )

    def matmul(self, a, b, precision=None):
        return jnp.matmul(_tf32(a), _tf32(b), precision=precision)


def _two_views(seed=0, n=400):
    """Normalized image coords of n points of the synthetic VO scene (far
    plane and near slab) in two cameras one VO step apart, with 0.3 px
    noise at f = 400."""
    from ethzasl_brisk_jax import workloads

    rng = np.random.default_rng(seed)
    (_, _), (r, t) = workloads.vo_trajectory(2)
    z = np.where(rng.random(n) < 0.5, 3.0, 6.0) + rng.uniform(0, 0.5, n)
    pts = np.stack([rng.uniform(-1, 1, n) * z * 0.7,
                    rng.uniform(-1, 1, n) * z * 0.5, z], 1)
    cam2 = pts @ r.T + t

    def proj(p):
        return p[:, :2] / p[:, 2:] + rng.normal(0, 0.3 / 400.0, (n, 2))

    inl = rng.random(n) < 0.9
    return (proj(pts).astype(np.float32), proj(cam2).astype(np.float32),
            inl)


def _refit(r1, r2, inl, tf32=False):
    """pose_from_inliers on the CPU, its products exact or TF32."""
    saved = precise.jnp
    precise.jnp = _Tf32Jnp() if tf32 else jnp
    jax.clear_caches()  # retrace with the chosen products
    try:
        return jax.device_get(pose_from_inliers(r1, r2, jnp.asarray(inl)))
    finally:
        precise.jnp = saved
        jax.clear_caches()


def _diff(a, b):
    return bp.rotation_deg(a[0], b[0]), float(np.linalg.norm(a[1] - b[1]))


@pytest.mark.parametrize("seed", [0, 1])
def test_refit_bounds_hold_under_last_bit_noise(seed):
    r1, r2, inl = _two_views(seed)
    ref = _refit(r1, r2, inl)
    rng = np.random.default_rng(100 + seed)
    for _ in range(3):
        def nudge(x):
            return (x * (1 + rng.uniform(-1, 1, x.shape) * 2.0**-23)
                    ).astype(np.float32)

        rot, t = _diff(_refit(nudge(r1), nudge(r2), inl), ref)
        assert rot < bp.REFIT_MAX_ROT_DEG / 10, rot
        assert t < bp.REFIT_MAX_T, t


@pytest.mark.parametrize("seed", [0, 1])
def test_refit_bounds_catch_tf32_products(seed):
    r1, r2, inl = _two_views(seed)
    rot, t = _diff(_refit(r1, r2, inl, tf32=True), _refit(r1, r2, inl))
    assert rot > bp.REFIT_MAX_ROT_DEG or t > bp.REFIT_MAX_T, (rot, t)


def _rot_z(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]])


def test_rotation_deg_is_stable_near_identity():
    # An f32 rotation against its f64 original: only rounding apart.
    a = _rot_z(0.3).astype(np.float32)
    assert bp.rotation_deg(a, _rot_z(0.3)) < 1e-5
    assert abs(bp.rotation_deg(_rot_z(0.3 + 1e-3), _rot_z(0.3))
               - np.degrees(1e-3)) < 1e-9
