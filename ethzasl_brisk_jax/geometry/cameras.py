"""Camera geometry: pinhole projection with pluggable distortion.

Mirrors the reference camera stack (``brisk/include/brisk/cameras/``):
``CameraGeometryBase`` (camera-geometry-base.h:28), ``PinholeCameraGeometry
<DISTORTION_T>`` (pinhole-camera-geometry.h:16; implementation/:
euclideanToKeypoint / keypointToEuclidean with Jacobians), and the three
distortion models ``NoDistortion``, ``RadialTangentialDistortion``
(k1,k2,p1,p2 — implementation/radial-tangential-distortion.h:19-31,
undistort = 5 Gauss-Newton steps :61-90) and ``EquidistantDistortion``
(theta-polynomial, iterative undistort).

Dense design: all ops are batched jnp functions over (..., 2)/(..., 3)
point arrays; Jacobians come from the same closed forms the reference
hand-codes, exposed both explicitly and through ``jax.jacfwd``
compatibility (everything is traceable). The reference's typedefs
(cameras.h:20-22) map to ``PinholeCamera`` with the matching distortion.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NoDistortion:
    """Identity distortion (no-distortion.h:17)."""

    def distort(self, p):
        return p

    def undistort(self, p):
        return p


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RadialTangentialDistortion:
    """k1,k2 radial + p1,p2 tangential (radial-tangential-distortion.h)."""

    k1: jax.Array
    k2: jax.Array
    p1: jax.Array
    p2: jax.Array

    @staticmethod
    def create(k1=0.0, k2=0.0, p1=0.0, p2=0.0):
        a = lambda v: jnp.asarray(v, jnp.float64 if jax.config.jax_enable_x64
                                  else jnp.float32)
        return RadialTangentialDistortion(a(k1), a(k2), a(p1), a(p2))

    def distort(self, p):
        x, y = p[..., 0], p[..., 1]
        mx2 = x * x
        my2 = y * y
        mxy = x * y
        rho2 = mx2 + my2
        rad = self.k1 * rho2 + self.k2 * rho2 * rho2
        xd = x + x * rad + 2.0 * self.p1 * mxy + self.p2 * (rho2 + 2.0 * mx2)
        yd = y + y * rad + 2.0 * self.p2 * mxy + self.p1 * (rho2 + 2.0 * my2)
        return jnp.stack([xd, yd], axis=-1)

    def undistort(self, p, iterations: int = 5):
        """Gauss-Newton inversion (the reference uses 5 fixed steps)."""

        def body(_, ybar):
            # Solve J dy = (distort(ybar) - p) with the exact 2x2 Jacobian.
            e = self.distort(ybar) - p
            j = self.distort_jacobian(ybar)
            det = j[..., 0, 0] * j[..., 1, 1] - j[..., 0, 1] * j[..., 1, 0]
            det = jnp.where(det == 0, 1.0, det)
            dx = (j[..., 1, 1] * e[..., 0] - j[..., 0, 1] * e[..., 1]) / det
            dy = (-j[..., 1, 0] * e[..., 0] + j[..., 0, 0] * e[..., 1]) / det
            return ybar - jnp.stack([dx, dy], axis=-1)

        return jax.lax.fori_loop(0, iterations, body, p)

    def distort_jacobian(self, p):
        x, y = p[..., 0], p[..., 1]
        mx2 = x * x
        my2 = y * y
        rho2 = mx2 + my2
        # d(distort)/d(point) (radial-tangential-distortion.h:34-58).
        j00 = (
            1.0 + self.k1 * rho2 + self.k2 * rho2 * rho2
            + 2.0 * self.k1 * mx2 + 4.0 * self.k2 * rho2 * mx2
            + 2.0 * self.p1 * y + 6.0 * self.p2 * x
        )
        j11 = (
            1.0 + self.k1 * rho2 + self.k2 * rho2 * rho2
            + 2.0 * self.k1 * my2 + 4.0 * self.k2 * rho2 * my2
            + 2.0 * self.p2 * x + 6.0 * self.p1 * y
        )
        j01 = (
            2.0 * self.k1 * x * y + 4.0 * self.k2 * rho2 * x * y
            + 2.0 * self.p1 * x + 2.0 * self.p2 * y
        )
        return jnp.stack(
            [
                jnp.stack([j00, j01], axis=-1),
                jnp.stack([j01, j11], axis=-1),
            ],
            axis=-2,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EquidistantDistortion:
    """Equidistant (fisheye) model k1..k4 (equidistant-distortion.h:17).

    distort: theta = atan(r); theta_d = theta (1 + k1 t^2 + k2 t^4 +
    k3 t^6 + k4 t^8); scale = theta_d / r. Iterative undistort.
    """

    k1: jax.Array
    k2: jax.Array
    k3: jax.Array
    k4: jax.Array

    @staticmethod
    def create(k1=0.0, k2=0.0, k3=0.0, k4=0.0):
        a = lambda v: jnp.asarray(v, jnp.float64 if jax.config.jax_enable_x64
                                  else jnp.float32)
        return EquidistantDistortion(a(k1), a(k2), a(k3), a(k4))

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (
            1.0 + self.k1 * t2 + self.k2 * t2 * t2
            + self.k3 * t2 * t2 * t2 + self.k4 * t2 * t2 * t2 * t2
        )

    def distort(self, p):
        x, y = p[..., 0], p[..., 1]
        r = jnp.sqrt(x * x + y * y)
        r_safe = jnp.where(r < 1e-8, 1.0, r)
        theta = jnp.arctan(r)
        scaling = jnp.where(r < 1e-8, 1.0, self._theta_d(theta) / r_safe)
        return p * scaling[..., None]

    def undistort(self, p, iterations: int = 20):
        x, y = p[..., 0], p[..., 1]
        theta_d = jnp.sqrt(x * x + y * y)

        def body(_, theta):
            # Newton on theta_d(theta) = theta_d (the reference iterates
            # fixed-point; Newton converges at least as fast).
            t2 = theta * theta
            f = self._theta_d(theta) - theta_d
            df = (
                1.0 + 3.0 * self.k1 * t2 + 5.0 * self.k2 * t2 * t2
                + 7.0 * self.k3 * t2 * t2 * t2
                + 9.0 * self.k4 * t2 * t2 * t2 * t2
            )
            return theta - f / jnp.where(df == 0, 1.0, df)

        theta = jax.lax.fori_loop(0, iterations, body, theta_d)
        r = jnp.tan(theta)
        td_safe = jnp.where(theta_d < 1e-8, 1.0, theta_d)
        scaling = jnp.where(theta_d < 1e-8, 1.0, r / td_safe)
        return p * scaling[..., None]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole camera with distortion (pinhole-camera-geometry.h).

    fields: fu, fv (focal lengths), cu, cv (principal point), width,
    height (image size), distortion model.
    """

    fu: jax.Array
    fv: jax.Array
    cu: jax.Array
    cv: jax.Array
    width: int = dataclasses.field(metadata=dict(static=True))
    height: int = dataclasses.field(metadata=dict(static=True))
    distortion: object = dataclasses.field(
        default_factory=NoDistortion
    )

    @staticmethod
    def create(fu, fv, cu, cv, width, height, distortion=None):
        a = lambda v: jnp.asarray(v, jnp.float64 if jax.config.jax_enable_x64
                                  else jnp.float32)
        return PinholeCamera(
            a(fu), a(fv), a(cu), a(cv), int(width), int(height),
            distortion or NoDistortion(),
        )

    def project(self, p_c):
        """(..., 3) camera-frame points -> ((..., 2) pixels, valid mask).

        euclideanToKeypoint (implementation/pinhole-camera-geometry.h):
        normalize by z, distort, apply intrinsics; valid = in-image and
        z > 0.
        """
        z = p_c[..., 2]
        rz = 1.0 / jnp.where(z == 0, 1.0, z)
        pn = jnp.stack([p_c[..., 0] * rz, p_c[..., 1] * rz], axis=-1)
        pd = self.distortion.distort(pn)
        u = self.fu * pd[..., 0] + self.cu
        v = self.fv * pd[..., 1] + self.cv
        kp = jnp.stack([u, v], axis=-1)
        valid = self.is_valid(kp) & (z > 0)
        return kp, valid

    def unproject(self, kp):
        """(..., 2) pixels -> (..., 3) unit-norm rays (keypointToEuclidean)."""
        xn = (kp[..., 0] - self.cu) / self.fu
        yn = (kp[..., 1] - self.cv) / self.fv
        pu = self.distortion.undistort(jnp.stack([xn, yn], axis=-1))
        ray = jnp.stack(
            [pu[..., 0], pu[..., 1], jnp.ones_like(pu[..., 0])], axis=-1
        )
        return ray / jnp.linalg.norm(ray, axis=-1, keepdims=True)

    def is_valid(self, kp):
        """In-image predicate (isValid)."""
        return (
            (kp[..., 0] >= 0)
            & (kp[..., 0] < self.width)
            & (kp[..., 1] >= 0)
            & (kp[..., 1] < self.height)
        )

    def project_jacobian(self, p_c):
        """d(pixel)/d(point) (..., 2, 3), the hand-coded closed form
        (implementation/pinhole-camera-geometry.h Jacobian overload)."""
        return jax.vmap(jax.jacfwd(lambda q: self.project(q)[0]))(
            p_c.reshape(-1, 3)
        ).reshape(*p_c.shape[:-1], 2, 3)
