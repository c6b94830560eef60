"""Camera-aware feature extraction via virtual undistorted views.

Mirrors ``brisk::CameraAwareFeature`` (``brisk/include/brisk/
camera-aware-feature.h:50-116``, ``brisk/src/camera-aware-feature.cc``):
for a distorted camera, build an N_x x N_y grid of virtual undistorted
pinhole views (grid size from the corner-ray angles and a distortion
tolerance, camera-aware-feature.cc:98-114), DETECT on the original
distorted image, assign each keypoint to a view via a precomputed
model-selection map (:567-583), DESCRIBE in the per-view undistorted
warps, and map angles back through the distort maps (:660-672).

Dense design: all warp/undistort maps are dense precomputed gather grids
stacked over views (padded to a common static shape); remapping is one
batched bilinear gather (vmap over views); description of every view's
keypoints happens in ONE flat call via the stacked-frame row_base layout
(``describe.extractor.extract_descriptors_views``) instead of the
reference's per-view compute loop.

``CameraAwareFeature`` (below) keeps the earlier single-virtual-view
variant — cheaper and adequate for mild distortion;
``CameraAwareFeatureGrid`` is the full reference capability for
wide-angle/fisheye lenses.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ethzasl_brisk_jax.geometry.cameras import PinholeCamera
from ethzasl_brisk_jax.utils.precise import einsum


def bilinear_remap(img: jnp.ndarray, src_x: jnp.ndarray,
                   src_y: jnp.ndarray) -> jnp.ndarray:
    """uint8 (H, W) image sampled at float maps (h, w) -> uint8 (h, w)."""
    h, w = img.shape
    x0 = jnp.clip(jnp.floor(src_x).astype(jnp.int32), 0, w - 2)
    y0 = jnp.clip(jnp.floor(src_y).astype(jnp.int32), 0, h - 2)
    fx = jnp.clip(src_x - x0, 0.0, 1.0)
    fy = jnp.clip(src_y - y0, 0.0, 1.0)
    im = img.astype(jnp.float32)
    v00 = im[y0, x0]
    v01 = im[y0, x0 + 1]
    v10 = im[y0 + 1, x0]
    v11 = im[y0 + 1, x0 + 1]
    out = (
        (1 - fy) * ((1 - fx) * v00 + fx * v01)
        + fy * ((1 - fx) * v10 + fx * v11)
    )
    inside = (
        (src_x >= 0) & (src_x <= w - 1) & (src_y >= 0) & (src_y <= h - 1)
    )
    return jnp.where(inside, out + 0.5, 0.0).astype(jnp.uint8)


@dataclasses.dataclass(frozen=True)
class CameraAwareFeature:
    """Detect+describe through virtual undistorted pinhole views."""

    camera: PinholeCamera          # the real (distorted) camera
    feature: object                # BriskFeature-like detect_and_compute
    virtual_fov_scale: float = 1.0

    def _virtual_camera(self) -> PinholeCamera:
        c = self.camera
        return PinholeCamera.create(
            float(c.fu) * self.virtual_fov_scale,
            float(c.fv) * self.virtual_fov_scale,
            float(c.cu),
            float(c.cv),
            c.width,
            c.height,
        )

    def warp_maps(self):
        """(src_x, src_y) maps: virtual pixel -> real (distorted) pixel."""
        vcam = self._virtual_camera()
        c = self.camera
        ys, xs = jnp.mgrid[0 : c.height, 0 : c.width]
        xn = (xs.astype(jnp.float32) - vcam.cu) / vcam.fu
        yn = (ys.astype(jnp.float32) - vcam.cv) / vcam.fv
        pd = c.distortion.distort(jnp.stack([xn, yn], -1))
        src_x = c.fu * pd[..., 0] + c.cu
        src_y = c.fv * pd[..., 1] + c.cv
        return src_x, src_y

    def detect_and_compute(self, img: jnp.ndarray):
        """Detect in the undistorted view; return keypoints mapped back to
        the distorted image plus the undistorted-view descriptors."""
        src_x, src_y = self.warp_maps()
        warped = bilinear_remap(img, src_x, src_y)
        kps, desc = self.feature.detect_and_compute(warped)

        # Map keypoints back: virtual pixel -> normalized ray -> distort
        # -> real pixel (distortKeypoints, camera-aware-feature.cc:768).
        vcam = self._virtual_camera()
        c = self.camera
        xn = (kps.x - vcam.cu) / vcam.fu
        yn = (kps.y - vcam.cv) / vcam.fv
        pd = c.distortion.distort(jnp.stack([xn, yn], -1))
        x_real = c.fu * pd[..., 0] + c.cu
        y_real = c.fv * pd[..., 1] + c.cv
        inside = (
            (x_real >= 0) & (x_real < c.width)
            & (y_real >= 0) & (y_real < c.height)
        )
        out = dataclasses.replace(
            kps, x=x_real, y=y_real, valid=kps.valid & inside
        )
        return out, desc, warped


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    """Rotation matrix from a rotation vector (cv::Rodrigues semantics:
    angle = |rvec|, axis = rvec/|rvec|)."""
    theta = float(np.linalg.norm(rvec))
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    kk = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * kk + (1 - np.cos(theta)) * (kk @ kk)


def _three_plane_intersection(n1, n2, n3, d=-1.0):
    """Intersection of planes n_i . x + d = 0 (threePlaneIntersection,
    camera-aware-feature.cc:390-404)."""
    denom = float(np.dot(n1, np.cross(n2, n3)))
    if abs(denom) < 1e-12:
        return None
    return (
        np.cross(n2, n3) * d + np.cross(n3, n1) * d + np.cross(n1, n2) * d
    ) / (-denom)


@dataclasses.dataclass(frozen=True)
class _ViewGeometry:
    """Host-side per-view constants (one virtual pinhole per grid cell)."""

    r_ci_c: np.ndarray   # (3, 3) rays C -> Ci
    center_u: float
    center_v: float
    pixels_u: int
    pixels_v: int
    lo_u: float          # model-selection valid region (margins excluded)
    hi_u: float
    lo_v: float
    hi_v: float


@dataclasses.dataclass(frozen=True)
class CameraAwareFeatureGrid:
    """Grid-of-virtual-views camera-aware detect+describe.

    Mirrors the reference pipeline end to end
    (camera-aware-feature.cc:44-341 setup, :430-700 detectAndCompute):
    detection on the distorted image, per-view undistorted description,
    angle mapped back through the distort maps. ``extraction_direction``
    (setExtractionDirection, camera-aware-feature.h:36) overrides BRISK's
    gradient orientation with a fixed 3D direction projected per
    keypoint.
    """

    camera: PinholeCamera
    feature: object                      # BriskFeature
    distortion_tolerance: float = 2e-1   # radians (ctor default, .h:23)
    margin: int = 100                    # view overlap margin px (.cc:295)
    extraction_direction: tuple | None = None  # e_C in camera frame

    def __post_init__(self):
        (views, n_x, n_y, focal, dist_maps, undist_maps, sel) = (
            self._build_views()
        )
        object.__setattr__(self, "_views", views)
        object.__setattr__(self, "n_x", n_x)
        object.__setattr__(self, "n_y", n_y)
        object.__setattr__(self, "focal", focal)
        # Stacked device tables: distort maps (V, maxPV, maxPU, 2) view
        # pixel -> real pixel; undistort maps (V, H, W, 2) real pixel ->
        # view pixel; selection map (H, W) int32 (0 = unassigned, else
        # view index + 1).
        object.__setattr__(self, "_dist_maps", jnp.asarray(dist_maps))
        object.__setattr__(self, "_undist_maps", jnp.asarray(undist_maps))
        object.__setattr__(self, "_sel_map", jnp.asarray(sel))
        object.__setattr__(
            self,
            "_r_ci_c",
            jnp.asarray(np.stack([v.r_ci_c for v in views])),
        )
        object.__setattr__(
            self,
            "_view_cols",
            jnp.asarray([v.pixels_u for v in views], jnp.int32),
        )
        object.__setattr__(
            self,
            "_view_rows",
            jnp.asarray([v.pixels_v for v in views], jnp.int32),
        )

    # ---- host-side setup (numpy; mirrors setCameraGeometry) ----

    def _unproject_np(self, pts: np.ndarray) -> np.ndarray:
        return np.asarray(
            self.camera.unproject(jnp.asarray(pts, jnp.float32)),
            np.float64,
        )

    def _build_views(self):
        cam = self.camera
        w, h = cam.width, cam.height
        corners = self._unproject_np(
            [[0.0, 0.0], [w, 0.0], [0.0, h], [float(w), float(h)]]
        )
        p00, pw0, p0h, pwh = corners
        ang = lambda a, b: float(np.arccos(np.clip(np.dot(a, b), -1, 1)))
        angle_x = max(ang(p00, pw0), ang(p0h, pwh))
        angle_y = max(ang(p00, p0h), ang(pw0, pwh))
        n_x = int(angle_x / 2.0 / self.distortion_tolerance + 1.0)
        n_y = int(angle_y / 2.0 / self.distortion_tolerance + 1.0)

        pmc, ppc = self._unproject_np(
            [[w / 2.0 - 1.0, h / 2.0], [w / 2.0 + 1.0, h / 2.0]]
        )
        focal = 1.0 / ((ppc[0] / ppc[2] - pmc[0] / pmc[2]) / 2.0)

        # Cell-center normals (camera-aware-feature.cc:131-149).
        centers = [
            [w / (2.0 * n_x) + m * w / n_x, h / (2.0 * n_y) + n * h / n_y]
            for n in range(n_y)
            for m in range(n_x)
        ]
        normals = self._unproject_np(centers)  # (V, 3), i = m + n*n_x

        # Border rays for boundary tracing (normalized by unproject).
        left_rays = self._unproject_np(
            np.stack([np.zeros(h), np.arange(h, dtype=np.float64)], 1)
        )
        right_rays = self._unproject_np(
            np.stack([np.full(h, float(w)), np.arange(h) * 1.0], 1)
        )
        top_rays = self._unproject_np(
            np.stack([np.arange(w, dtype=np.float64), np.zeros(w)], 1)
        )
        bottom_rays = self._unproject_np(
            np.stack([np.arange(w) * 1.0, np.full(w, float(h))], 1)
        )

        views: list[_ViewGeometry] = []
        for n in range(n_y):
            for m in range(n_x):
                i = m + n * n_x
                r_ci_c = _rodrigues(np.cross(normals[i], [0.0, 0.0, 1.0]))
                left, right = m == 0, m == n_x - 1
                top, bottom = n == 0, n == n_y - 1

                # Interior corners: three-plane intersections of unit
                # planes n.x = 1 with the neighbors (cc:180-215), rotated
                # into the view and normalized to z=1.
                p = {
                    k: np.zeros(3)
                    for k in ("00", "10", "01", "11")
                }

                def corner(key, na, nb):
                    q = _three_plane_intersection(normals[i], na, nb)
                    if q is None:
                        return
                    q = r_ci_c @ q
                    p[key] = np.array([q[0] / q[2], q[1] / q[2], 1.0])

                if not left and not top:
                    corner("00", normals[i - 1], normals[i - n_x])
                if not top and not right:
                    corner("10", normals[i - n_x], normals[i + 1])
                if not left and not bottom:
                    corner("01", normals[i - 1], normals[i + n_x])
                if not right and not bottom:
                    corner("11", normals[i + 1], normals[i + n_x])

                # Boundary traces (cc:221-290): extend the open sides to
                # cover the traced image border, filtering candidates by
                # the extents fixed so far. x-updates first (left/right),
                # then y (top/bottom), matching the reference's order.
                def trace(rays, axis, cmp, keys, guard_axis, guards):
                    pts = (r_ci_c @ rays.T).T
                    pts = pts[:, :2] / pts[:, 2:3]
                    sel = np.ones(len(pts), bool)
                    for g_keys, g_cmp in guards:
                        bound = (min if g_cmp == "<" else max)(
                            p[g_keys[0]][guard_axis], p[g_keys[1]][guard_axis]
                        )
                        if g_cmp == "<":
                            sel &= pts[:, guard_axis] >= bound
                        else:
                            sel &= pts[:, guard_axis] <= bound
                    if not sel.any():
                        return
                    ext = (min if cmp == "<" else max)(pts[sel, axis])
                    for key in keys:
                        if (cmp == "<" and ext < p[key][axis]) or (
                            cmp == ">" and ext > p[key][axis]
                        ):
                            p[key][axis] = ext

                if left:
                    guards = []
                    if not top:
                        guards.append((("00", "10"), "<"))
                    if not bottom:
                        guards.append((("01", "11"), ">"))
                    trace(left_rays, 0, "<", ("00", "01"), 1, guards)
                if right:
                    guards = []
                    if not top:
                        guards.append((("00", "10"), "<"))
                    if not bottom:
                        guards.append((("01", "11"), ">"))
                    trace(right_rays, 0, ">", ("10", "11"), 1, guards)
                if top:
                    guards = []
                    if not left:
                        guards.append((("00", "01"), "<"))
                    if not right:
                        guards.append((("10", "11"), ">"))
                    trace(top_rays, 1, "<", ("00", "10"), 0, guards)
                if bottom:
                    guards = []
                    if not left:
                        guards.append((("00", "01"), "<"))
                    if not right:
                        guards.append((("10", "11"), ">"))
                    trace(bottom_rays, 1, ">", ("01", "11"), 0, guards)

                # View size + principal point (cc:293-311).
                mg = self.margin
                center_u = -min(p["00"][0], p["01"][0]) * focal
                if not left:
                    center_u += mg
                center_v = -min(p["00"][1], p["10"][1]) * focal
                if not top:
                    center_v += mg
                pixels_u = int(
                    center_u + max(p["10"][0], p["11"][0]) * focal
                )
                if not right:
                    pixels_u += mg
                pixels_v = int(
                    center_v + max(p["01"][1], p["11"][1]) * focal
                )
                if not bottom:
                    pixels_v += mg

                views.append(
                    _ViewGeometry(
                        r_ci_c=r_ci_c,
                        center_u=center_u,
                        center_v=center_v,
                        pixels_u=max(pixels_u, 2),
                        pixels_v=max(pixels_v, 2),
                        lo_u=0.0 if left else float(mg),
                        hi_u=float(pixels_u if right else pixels_u - mg),
                        lo_v=0.0 if top else float(mg),
                        hi_v=float(pixels_v if bottom else pixels_v - mg),
                    )
                )

        # ---- dense maps, padded to a common static shape ----
        max_pu = max(v.pixels_u for v in views)
        max_pv = max(v.pixels_v for v in views)
        n_views = len(views)

        dist_maps = np.zeros((n_views, max_pv, max_pu, 2), np.float32)
        undist_maps = np.zeros((n_views, h, w, 2), np.float32)
        sel = np.zeros((h, w), np.int32)

        ys, xs = np.mgrid[0:max_pv, 0:max_pu].astype(np.float64)
        real_rays = self._unproject_np(
            np.stack(np.mgrid[0:w, 0:h], -1).reshape(-1, 2).astype(
                np.float64
            )
        ).reshape(w, h, 3).transpose(1, 0, 2)  # (H, W, 3)

        for i, v in enumerate(views):
            # Distort map: view pixel -> ray in C -> real pixel
            # (cc:330-344). Computed with the camera's own project (the
            # reference calls euclideanToKeypoint).
            rays_ci = np.stack(
                [
                    (xs - v.center_u) / focal,
                    (ys - v.center_v) / focal,
                    np.ones_like(xs),
                ],
                -1,
            )
            rays_c = rays_ci @ v.r_ci_c  # == (R_C_Ci @ ray) rowwise
            kp, _ = self.camera.project(jnp.asarray(rays_c, jnp.float32))
            dist_maps[i] = np.asarray(kp)

            # Undistort map: real pixel ray -> view pinhole (cc:350-363).
            p_ci = real_rays @ v.r_ci_c.T
            undist_maps[i, ..., 0] = (
                p_ci[..., 0] / p_ci[..., 2] * focal + v.center_u
            )
            undist_maps[i, ..., 1] = (
                p_ci[..., 1] / p_ci[..., 2] * focal + v.center_v
            )

            # Model selection (cc:370-384): highest view index whose
            # non-margin region covers the real pixel.
            u, vv = undist_maps[i, ..., 0], undist_maps[i, ..., 1]
            inside = (
                (u >= v.lo_u)
                & (u <= v.hi_u - 1.0)
                & (vv >= v.lo_v)
                & (vv <= v.hi_v - 1.0)
                & (p_ci[..., 2] > 0)
            )
            sel = np.where(inside, i + 1, sel)

        return views, n_x, n_y, focal, dist_maps, undist_maps, sel

    # ---- runtime path (jit-compatible) ----

    @property
    def n_views(self) -> int:
        return len(self._views)

    def warp_views(self, img: jnp.ndarray) -> jnp.ndarray:
        """All undistorted view images, (V, maxPV, maxPU) uint8.

        Map coords are quantized to 1/32 px first, mirroring the
        reference's fixed-point remap maps (cv::convertMaps CV_16SC2 with
        5 fractional bits, camera-aware-feature.cc:346-348) — this also
        snaps float-epsilon border coordinates onto the image.
        """
        q = jnp.round(self._dist_maps * 32.0) / 32.0
        return jax.vmap(
            lambda m: bilinear_remap(img, m[..., 0], m[..., 1])
        )(q)

    def _bilerp_maps(self, maps, vidx, x, y):
        """Bilinear map lookup per keypoint: maps (V, H, W, 2) at float
        (x, y) in view ``vidx`` (distortPoint/undistortPoint,
        camera-aware-feature.cc:713-760: truncation floor, no clamping in
        the reference — we clamp to stay in-bounds; out-of-map keypoints
        are invalid anyway)."""
        hh, ww = maps.shape[1], maps.shape[2]
        xi = jnp.clip(x.astype(jnp.int32), 0, ww - 2)
        yi = jnp.clip(y.astype(jnp.int32), 0, hh - 2)
        rx = (x - xi)[..., None]
        ry = (y - yi)[..., None]
        p00 = maps[vidx, yi, xi]
        p10 = maps[vidx, yi, xi + 1]
        p01 = maps[vidx, yi + 1, xi]
        p11 = maps[vidx, yi + 1, xi + 1]
        px0 = p00 + rx * (p10 - p00)
        px1 = p01 + rx * (p11 - p01)
        return px0 + ry * (px1 - px0)

    def detect_and_compute(self, img: jnp.ndarray):
        """Detect on the distorted image; describe in the views; map
        angles back. Returns (keypoints in ORIGINAL image coords, desc).
        """
        feature = self.feature
        # The jitted detect entry: identical compiled program (and thus
        # bit-identical float subpixel refinement) to detect_and_compute.
        kps = feature._detect_jit(img)
        cam = self.camera

        # removeBorderKeypoints(2.0) (cc:514, :800-813).
        s2 = 2.0 * kps.size
        ok_border = (
            (kps.x - s2 >= 0.0)
            & (kps.y - s2 >= 0.0)
            & (kps.x + s2 <= float(cam.width))
            & (kps.y + s2 <= float(cam.height))
        )

        # View assignment from the selection map at rint(x), rint(y)
        # (cc:567-575).
        xi = jnp.clip(
            jnp.round(kps.x).astype(jnp.int32), 0, cam.width - 1
        )
        yi = jnp.clip(
            jnp.round(kps.y).astype(jnp.int32), 0, cam.height - 1
        )
        sel = self._sel_map[yi, xi]
        assigned = sel > 0
        vidx = jnp.maximum(sel - 1, 0)

        # Undistort keypoints into their views (cc:599 undistortKeypoints).
        uv = self._bilerp_maps(self._undist_maps, vidx, kps.x, kps.y)
        ux, uy = uv[..., 0], uv[..., 1]

        valid = kps.valid & ok_border & assigned

        if self.extraction_direction is not None:
            angle0 = self._extraction_angles(kps, vidx, ux, uy)
        else:
            angle0 = kps.angle

        view_kps = dataclasses.replace(
            kps, x=ux, y=uy, angle=angle0, valid=valid
        )
        from ethzasl_brisk_jax.describe.extractor import (
            extract_descriptors_views,
        )

        warped = self.warp_views(img)
        out_kp, desc = extract_descriptors_views(
            feature.extractor.pattern, warped, view_kps, vidx,
            rotation_invariant=feature.rotation_invariant,
            scale_invariant=feature.scale_invariant,
            skip_small=feature.extractor.skip_small,
            view_cols=self._view_cols,
            view_rows=self._view_rows,
        )

        # Angle back-transform (cc:660-672): walk size along the view
        # angle, distort both points, take the atan2 in the real image.
        a_rad = out_kp.angle * (jnp.pi / 180.0)
        p2x = ux + kps.size * jnp.cos(a_rad)
        p2y = uy + kps.size * jnp.sin(a_rad)
        real2 = self._bilerp_maps(self._dist_maps, vidx, p2x, p2y)
        angle_real = (
            jnp.arctan2(real2[..., 1] - kps.y, real2[..., 0] - kps.x)
            * (180.0 / jnp.pi)
        )

        final = dataclasses.replace(
            kps, angle=angle_real, valid=out_kp.valid
        )
        return final, desc

    def _extraction_angles(self, kps, vidx, ux, uy):
        """Fixed extraction direction e_C -> per-keypoint view angle
        (cc:607-632): project e_C through the real camera's point
        Jacobian at the keypoint, walk size along it, undistort into the
        view, take the atan2 there."""
        e_c = jnp.asarray(self.extraction_direction, jnp.float32)
        rays = self.camera.unproject(jnp.stack([kps.x, kps.y], -1))
        # Scale rays to z=1 like keypointToEuclidean's consumers expect;
        # the Jacobian is evaluated at the back-projected point.
        jac = self.camera.project_jacobian(rays)  # (K, 2, 3)
        e_img = einsum("kij,j->ki", jac, e_c)  # (K, 2)
        length = jnp.linalg.norm(e_img, axis=-1)
        ok = length >= 0.1
        e_img = e_img / jnp.maximum(length, 0.1)[..., None]
        p2 = jnp.stack(
            [kps.x + kps.size * e_img[..., 0],
             kps.y + kps.size * e_img[..., 1]], -1
        )
        uv2 = self._bilerp_maps(
            self._undist_maps, vidx, p2[..., 0], p2[..., 1]
        )
        ang = jnp.arctan2(uv2[..., 1] - uy, uv2[..., 0] - ux) * (
            180.0 / jnp.pi
        )
        # length < 0.1: leave -1 so BRISK computes its own orientation
        # (cc:620-621 'leave original angle').
        return jnp.where(ok, ang, kps.angle)
