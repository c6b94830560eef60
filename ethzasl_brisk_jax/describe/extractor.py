"""BRISK descriptor extraction, dense and batched.

Mirrors ``BriskDescriptorExtractor``
(``brisk/src/brisk-descriptor-extractor.cc``):

* per-keypoint scale index from size (doDescriptorComputation:629-658);
* border filtering against sizeList (RoiPredicate, :532-536);
* smoothed-intensity sampling with the reference's exact integer
  fixed-point math (SmoothedIntensity, :370-530) — the branchy pointer
  walk becomes 4 image gathers + 12 integral-image gathers per
  (keypoint, pattern point), evaluated densely for all K x 66 samples;
* orientation from long pairs with C-truncating division (:714-740);
* 384 short-pair comparisons packed LSB-first into 12 uint32 words
  (setDescriptorBits, :538-564).

The pattern LUT lives as device constants; rotation is a dynamic gather on
the rotation axis. Everything is fixed-capacity and jit/vmap-compatible.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ethzasl_brisk_jax.core.keypoints import KeyPoints
from ethzasl_brisk_jax.core.pattern import (
    BASIC_SIZE,
    N_ROT,
    SCALERANGE,
    SCALES,
    BriskPattern,
    brisk_v1_pattern,
    brisk_v2_pattern,
)
from ethzasl_brisk_jax.kernels.integral import integral_image_i32


def _trunc_div(val: jnp.ndarray, d: int) -> jnp.ndarray:
    return jnp.where(val >= 0, val // d, -((-val) // d))


# Optional probe sink: when a list, the exact-angle host callback appends
# (d0, d1) integer direction sums (used to discriminate candidate C++
# float-promotion chains against the goldens).
# NOTE: the append happens inside jax.pure_callback, which JAX may cache,
# elide, or replay — the sink is only meaningful when the describe call
# runs EAGERLY (jax.disable_jit); never
# rely on it under jit.
_ANGLE_DEBUG_SINK: list | None = None


def _exact_angle_host(
    d0: np.ndarray, d1: np.ndarray, given_angle: np.ndarray,
    need: np.ndarray,
):
    """Reference-exact orientation angle + rotation index, on host libm.

    Mirrors brisk-descriptor-extractor.cc:732-739 exactly:

    * ``atan2(static_cast<float>(direction1), static_cast<float>(direction0))``
      resolves to the C ``atan2(double, double)`` (float args promoted —
      verified against the goldens: the double chain matches 454/454 + 443/443 angles bit-for-bit, the libm
      ``atan2f`` float-overload chain only ~55%);
    * ``/ M_PI * 180.0`` stays in double; the result rounds ONCE on
      assignment to the float ``kp.angle``;
    * ``theta = int((n_rot_ * angle) / 360.0 + 0.5)`` — the product is
      float32 (int x float), the division/add run in double, the int cast
      truncates toward zero; negative thetas wrap by +n_rot_.

    XLA's f32 arctan2 approximation differs from libm in the last ULP and
    the jit path divides by pi in f32, so bit-exact angles require this
    host path (CPU parity harnesses only; the default keeps the
    on-device f32 chain, whose descriptors are identical because the
    1024-bin rotation quantization absorbs the ULP).
    """
    if _ANGLE_DEBUG_SINK is not None:
        _ANGLE_DEBUG_SINK.append(
            (np.asarray(d0).copy(), np.asarray(d1).copy())
        )
    # The same DOUBLE chain holds for both engines: v2 verified
    # against the goldens (454/454 + 443/443) and v1 against the
    # compiled-reference goldens (1066/1066 with the exact v1 pattern)
    # — brisk-v1.cc:472 resolves atan2 to double despite its logf
    # scale-list chain.
    a = np.arctan2(
        np.asarray(d1).astype(np.float32).astype(np.float64),
        np.asarray(d0).astype(np.float32).astype(np.float64),
    )  # libm atan2 in double of the float-cast sums
    computed = (a / np.pi * 180.0).astype(np.float32)
    ang = np.where(
        np.asarray(need), computed, np.asarray(given_angle)
    ).astype(np.float32)
    theta = np.trunc(
        (np.float32(N_ROT) * ang).astype(np.float64) / 360.0 + 0.5
    ).astype(np.int32)
    theta = np.where(theta < 0, theta + N_ROT, theta)
    theta = np.where(theta >= N_ROT, theta - N_ROT, theta)
    return ang, theta.astype(np.int32)


def _trunc_i32(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.trunc(x).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DevicePattern:
    """Pattern tables as device arrays.

    Registered as a pytree so the tables travel through jit boundaries as
    runtime ARGUMENTS, not embedded as jit closure constants (17 MB of
    rotation LUTs baked into every executable): every entry point must
    thread this pytree in from outside the outermost jit.
    """

    lut_x: jax.Array       # (S, R, P) f32
    lut_y: jax.Array       # (S, R, P) f32
    lut_sigma: jax.Array   # (S, P) f32
    lut_scaling: jax.Array   # (S, P) i32 box-weight scale
    lut_scaling2: jax.Array  # (S, P) i32 output divisor
    scale_list: jax.Array  # (S,) f32
    size_list: jax.Array   # (S,) i32
    short_i: jax.Array     # (Sh,) i32
    short_j: jax.Array
    long_i: jax.Array      # (L,) i32
    long_j: jax.Array
    long_wdx: jax.Array    # (L,) i32
    long_wdy: jax.Array
    n_points: int = dataclasses.field(metadata=dict(static=True))
    descriptor_words: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_host(p: BriskPattern) -> "DevicePattern":
        return DevicePattern(
            lut_x=jnp.asarray(p.lut_x),
            lut_y=jnp.asarray(p.lut_y),
            lut_sigma=jnp.asarray(p.lut_sigma),
            lut_scaling=jnp.asarray(p.lut_scaling),
            lut_scaling2=jnp.asarray(p.lut_scaling2),
            scale_list=jnp.asarray(p.scale_list),
            size_list=jnp.asarray(p.size_list),
            short_i=jnp.asarray(p.short_pairs[:, 0]),
            short_j=jnp.asarray(p.short_pairs[:, 1]),
            long_i=jnp.asarray(p.long_pairs[:, 0]),
            long_j=jnp.asarray(p.long_pairs[:, 1]),
            long_wdx=jnp.asarray(p.long_weights[:, 0]),
            long_wdy=jnp.asarray(p.long_weights[:, 1]),
            n_points=p.n_points,
            descriptor_words=p.descriptor_words,
        )


def smoothed_intensity_u8(
    img: jnp.ndarray,
    integral: jnp.ndarray,
    key_x: jnp.ndarray,   # (K,) f32
    key_y: jnp.ndarray,   # (K,) f32
    pat_x: jnp.ndarray,   # (K, P) f32 pattern offsets
    pat_y: jnp.ndarray,   # (K, P) f32
    pat_sigma: jnp.ndarray,  # (K, P) f32
    pat_scaling: jnp.ndarray,   # (K, P) i32 (host-exact int(4194304/area))
    pat_scaling2: jnp.ndarray,  # (K, P) i32
    *,
    skip_small: bool = False,
    row_base: jnp.ndarray | None = None,  # (K,) i32 stacked-frame row shift
    frame_rows: int | None = None,        # frame-local image height
    v1_rounding: bool = False,
) -> jnp.ndarray:
    """Reference-exact smoothed intensity for all (keypoint, point) pairs.

    ``v1_rounding=True`` selects the legacy brisk_v1 sampler rounding:
    every division adds half the divisor first (``(ret_val+512)/1024``
    bilinear, ``(... + scaling2/2)/scaling2`` box — brisk-v1.cc:246,
    :331, :366) where the v2 extractor truncates.

    Returns int32 (K, P) — value scale is pixel * 1024
    (SmoothedIntensity, brisk-descriptor-extractor.cc:370-530).

    ``skip_small=True`` statically removes the bilinear small-sigma branch
    (:391-408). It is dead for the default v2/v1 patterns at
    pattern_scale >= 0.65: min lut_sigma = 1.3 * 1.0 * 0.6 * ps >= 0.5, so
    the ``sigma_half < 0.5`` test never fires — skipping saves 4 of the 20
    gathers per (keypoint, point) tap. The caller checks the host pattern
    tables and only enables this when provably dead.

    ``row_base`` (stacked-frame batch layout) shifts the INTEGER gather
    rows only; key_y and all fixed-point math stay frame-local so results
    are bit-identical to the per-frame path. Rows are clipped to the
    frame-local bounds (``frame_rows``) before the shift.
    """
    cols = img.shape[1]
    rows = img.shape[0] if frame_rows is None else frame_rows
    imgi = img.astype(jnp.int32)
    inti = integral  # (rows+1, cols+1) int32

    xf = pat_x + key_x[:, None]
    yf = pat_y + key_y[:, None]
    sigma_half = pat_sigma

    def shift(y):
        return y if row_base is None else y + row_base[:, None]

    # Flat 1-D takes instead of 2-D advanced indexing (one simple
    # gather per tap group).
    img_flat = imgi.reshape(-1)
    int_flat = inti.reshape(-1)
    img_w = imgi.shape[1]
    int_w = inti.shape[1]

    def at_img(y, x):
        y = shift(jnp.clip(y, 0, rows - 1))
        x = jnp.clip(x, 0, cols - 1)
        return jnp.take(img_flat, y * img_w + x)

    def at_int(y, x):
        y = shift(jnp.clip(y, 0, rows))
        x = jnp.clip(x, 0, cols)
        return jnp.take(int_flat, y * int_w + x)

    if not skip_small:
        # ---- Small-sigma path: integer bilinear (:391-408).
        x_i, y_i = jax.lax.optimization_barrier(
            (_trunc_i32(xf), _trunc_i32(yf))
        )
        r_x = _trunc_i32((xf - x_i.astype(jnp.float32)) * 1024)
        r_y = _trunc_i32((yf - y_i.astype(jnp.float32)) * 1024)
        r_x_1 = 1024 - r_x
        r_y_1 = 1024 - r_y
        small = (
            r_x_1 * r_y_1 * at_img(y_i, x_i)
            + r_x * r_y_1 * at_img(y_i, x_i + 1)
            + r_x * r_y * at_img(y_i + 1, x_i + 1)
            + r_x_1 * r_y * at_img(y_i + 1, x_i)
            + (512 if v1_rounding else 0)
        ) // 1024

    # ---- Box path (:410-495): exact integral-image decomposition.
    # scaling/scaling2 are precomputed on host with exact C++ cast
    # semantics (pattern.lut_scaling / lut_scaling2).
    scaling = pat_scaling
    scaling2 = jnp.maximum(pat_scaling2, 1)  # guard degenerate lanes only

    x_1 = xf - sigma_half
    x1 = xf + sigma_half
    y_1 = yf - sigma_half
    y1 = yf + sigma_half
    x_left = _trunc_i32(x_1 + 0.5)
    y_top = _trunc_i32(y_1 + 0.5)
    x_right = _trunc_i32(x1 + 0.5)
    y_bottom = _trunc_i32(y1 + 0.5)
    # Materialize the tap indices: keeps XLA from fusing the index
    # arithmetic into every gather that reads them.
    x_left, y_top, x_right, y_bottom = jax.lax.optimization_barrier(
        (x_left, y_top, x_right, y_bottom)
    )

    r_x_1f = x_left.astype(jnp.float32) - x_1 + 0.5
    r_y_1f = y_top.astype(jnp.float32) - y_1 + 0.5
    r_x1f = x1 - x_right.astype(jnp.float32) + 0.5
    r_y1f = y1 - y_bottom.astype(jnp.float32) + 0.5
    scf = scaling.astype(jnp.float32)
    # Corner/edge weights truncate float products to int (:436-443).
    w_a = _trunc_i32(r_x_1f * r_y_1f * scf)
    w_b = _trunc_i32(r_x1f * r_y_1f * scf)
    w_c = _trunc_i32(r_x1f * r_y1f * scf)
    w_d = _trunc_i32(r_x_1f * r_y1f * scf)
    r_x_1_i = _trunc_i32(r_x_1f * scf)
    r_y_1_i = _trunc_i32(r_y_1f * scf)
    r_x1_i = _trunc_i32(r_x1f * scf)
    r_y1_i = _trunc_i32(r_y1f * scf)

    # Corner taps: the reference's dx+dy>2 integral branch walks
    # `ptr += dy*imagecols + 1` then `ptr -= dx + 1`
    # (brisk-descriptor-extractor.cc:451-457), so its C/D "corners" actually
    # land on (y_bottom-1, x_right+1) and (y_bottom-1, x_left+1); the small
    # dx+dy<=2 pixel-walk branch (:497-530) hits the true corners. Both the
    # edge and middle terms are identical region sums in the two branches,
    # so only the corner taps need the branch split — reproduced exactly.
    dx_i = x_right - x_left - 1
    dy_i = y_bottom - y_top - 1
    big = dx_i + dy_i > 2
    cd_y = jnp.where(big, y_bottom - 1, y_bottom)
    c_x = jnp.where(big, x_right + 1, x_right)
    d_x = jnp.where(big, x_left + 1, x_left)
    corners = (
        w_a * at_img(y_top, x_left)
        + w_b * at_img(y_top, x_right)
        + w_c * at_img(cd_y, c_x)
        + w_d * at_img(cd_y, d_x)
    )

    t1 = at_int(y_top, x_left + 1)
    t2 = at_int(y_top, x_right)
    t3 = at_int(y_top + 1, x_right)
    t4 = at_int(y_top + 1, x_right + 1)
    t5 = at_int(y_bottom, x_right + 1)
    t6 = at_int(y_bottom, x_right)
    t7 = at_int(y_bottom + 1, x_right)
    t8 = at_int(y_bottom + 1, x_left + 1)
    t9 = at_int(y_bottom, x_left + 1)
    t10 = at_int(y_bottom, x_left)
    t11 = at_int(y_top + 1, x_left)
    t12 = at_int(y_top + 1, x_left + 1)

    upper = (t3 - t2 + t1 - t12) * r_y_1_i
    middle = (t6 - t3 + t12 - t9) * scaling
    left = (t9 - t12 + t11 - t10) * r_x_1_i
    right = (t5 - t4 + t3 - t6) * r_x1_i
    bottom = (t7 - t6 + t9 - t8) * r_y1_i

    total = corners + upper + middle + left + right + bottom
    if v1_rounding:
        total = total + scaling2 // 2
    box = total // scaling2

    if skip_small:
        return box
    return jnp.where(sigma_half < 0.5, small, box)


def smoothed_intensity_f32(
    img: jnp.ndarray,       # (H, W) f32 scaled image (uint16/65536)
    integral: jnp.ndarray,  # (H+1, W+1) f32 integral of the scaled image
    key_x: jnp.ndarray,
    key_y: jnp.ndarray,
    pat_x: jnp.ndarray,
    pat_y: jnp.ndarray,
    pat_sigma: jnp.ndarray,
    pat_area: jnp.ndarray,   # (K, P) f32 = 4*sigma_half^2
    *,
    row_base: jnp.ndarray | None = None,
    frame_rows: int | None = None,
) -> jnp.ndarray:
    """16-bit-image smoothed intensity: SmoothedIntensity<float, float>
    semantics (brisk-descriptor-extractor.cc:368-530, call sites
    :707-711, :767-771). All weights stay float (no truncation), the
    result truncates to int32.

    NOTE the upstream 16-bit path is latently broken: ``imageScaled`` is
    never assigned from the input (brisk-descriptor-extractor.cc:672-674)
    and the int32 integral is bit-reinterpreted as float (:461). This
    implements the evident INTENT: image scaled to [0, 1] (/65536) with
    a float integral (kernels/integral.integral_image_16_f32). One
    deliberate deviation: the output scale is x256, not the reference's
    x65536 — x65536 values overflow int32 in the long-pair orientation
    sums (delta * weight), another latent upstream bug; x256 lands the
    float path exactly in the 8-bit path's value range (pixel8 * 1024),
    and descriptor bits / orientation are invariant to the positive
    common scale.
    """
    cols = img.shape[1]
    rows = img.shape[0] if frame_rows is None else frame_rows
    imgf = img
    intf = integral

    xf = pat_x + key_x[:, None]
    yf = pat_y + key_y[:, None]
    sigma_half = pat_sigma

    def shift(y):
        return y if row_base is None else y + row_base[:, None]

    def at_img(y, x):
        y = shift(jnp.clip(y, 0, rows - 1))
        x = jnp.clip(x, 0, cols - 1)
        return imgf[y, x]

    def at_int(y, x):
        y = shift(jnp.clip(y, 0, rows))
        x = jnp.clip(x, 0, cols)
        return intf[y, x]

    # ---- Small-sigma bilinear (:390-408): int ratios, float pixels.
    x_i, y_i = _trunc_i32(xf), _trunc_i32(yf)
    r_x = _trunc_i32((xf - x_i.astype(jnp.float32)) * 1024).astype(
        jnp.float32
    )
    r_y = _trunc_i32((yf - y_i.astype(jnp.float32)) * 1024).astype(
        jnp.float32
    )
    r_x_1b = 1024.0 - r_x
    r_y_1b = 1024.0 - r_y
    small_val = (
        r_x_1b * r_y_1b * at_img(y_i, x_i)
        + r_x * r_y_1b * at_img(y_i, x_i + 1)
        + r_x * r_y * at_img(y_i + 1, x_i + 1)
        + r_x_1b * r_y * at_img(y_i + 1, x_i)
    ) / 1024.0

    # ---- Box path (:410-495) with float weights (no truncation).
    scaling = 4194304.0 / pat_area
    scaling2 = scaling * pat_area / 1024.0

    x_1 = xf - sigma_half
    x1 = xf + sigma_half
    y_1 = yf - sigma_half
    y1 = yf + sigma_half
    x_left = _trunc_i32(x_1 + 0.5)
    y_top = _trunc_i32(y_1 + 0.5)
    x_right = _trunc_i32(x1 + 0.5)
    y_bottom = _trunc_i32(y1 + 0.5)
    x_left, y_top, x_right, y_bottom = jax.lax.optimization_barrier(
        (x_left, y_top, x_right, y_bottom)
    )

    r_x_1f = x_left.astype(jnp.float32) - x_1 + 0.5
    r_y_1f = y_top.astype(jnp.float32) - y_1 + 0.5
    r_x1f = x1 - x_right.astype(jnp.float32) + 0.5
    r_y1f = y1 - y_bottom.astype(jnp.float32) + 0.5
    w_a = r_x_1f * r_y_1f * scaling
    w_b = r_x1f * r_y_1f * scaling
    w_c = r_x1f * r_y1f * scaling
    w_d = r_x_1f * r_y1f * scaling
    r_x_1_i = r_x_1f * scaling
    r_y_1_i = r_y_1f * scaling
    r_x1_i = r_x1f * scaling
    r_y1_i = r_y1f * scaling

    dx_i = x_right - x_left - 1
    dy_i = y_bottom - y_top - 1
    big = dx_i + dy_i > 2
    cd_y = jnp.where(big, y_bottom - 1, y_bottom)
    c_x = jnp.where(big, x_right + 1, x_right)
    d_x = jnp.where(big, x_left + 1, x_left)
    corners = (
        w_a * at_img(y_top, x_left)
        + w_b * at_img(y_top, x_right)
        + w_c * at_img(cd_y, c_x)
        + w_d * at_img(cd_y, d_x)
    )

    t1 = at_int(y_top, x_left + 1)
    t2 = at_int(y_top, x_right)
    t3 = at_int(y_top + 1, x_right)
    t4 = at_int(y_top + 1, x_right + 1)
    t5 = at_int(y_bottom, x_right + 1)
    t6 = at_int(y_bottom, x_right)
    t7 = at_int(y_bottom + 1, x_right)
    t8 = at_int(y_bottom + 1, x_left + 1)
    t9 = at_int(y_bottom, x_left + 1)
    t10 = at_int(y_bottom, x_left)
    t11 = at_int(y_top + 1, x_left)
    t12 = at_int(y_top + 1, x_left + 1)

    upper = (t3 - t2 + t1 - t12) * r_y_1_i
    middle = (t6 - t3 + t12 - t9) * scaling
    left = (t9 - t12 + t11 - t10) * r_x_1_i
    right = (t5 - t4 + t3 - t6) * r_x1_i
    bottom = (t7 - t6 + t9 - t8) * r_y1_i
    box = (corners + upper + middle + left + right + bottom) / scaling2

    val = jnp.where(sigma_half < 0.5, small_val, box)
    return _trunc_i32(256.0 * val)


@dataclasses.dataclass(frozen=True)
class BriskExtractor:
    """BriskDescriptorExtractor on dense, statically shaped arrays.

    Args mirror the reference ctor (brisk-descriptor-extractor.h:62-96):
    rotation_invariant, scale_invariant, version ('v1'/'v2'), pattern_scale.
    """

    rotation_invariant: bool = True
    scale_invariant: bool = True
    version: str = "v2"
    pattern_scale: float = 1.0
    # Runtime .ptn pattern file (the reference's file ctor,
    # brisk-descriptor-extractor.cc:357-367). Overrides `version`.
    pattern_file: str | None = None
    # Bit-exact reference angle/theta via host libm (CPU parity path;
    # see _exact_angle_host).
    angle_exact: bool = False

    def __post_init__(self):
        if self.pattern_file is not None:
            from ethzasl_brisk_jax.core.pattern import pattern_from_file

            host = pattern_from_file(self.pattern_file, self.pattern_scale)
        else:
            host = (
                brisk_v2_pattern(self.pattern_scale)
                if self.version == "v2"
                else brisk_v1_pattern(self.pattern_scale)
            )
        object.__setattr__(self, "_pattern", DevicePattern.from_host(host))
        object.__setattr__(self, "_host_pattern", host)
        # Static dead-branch check: the bilinear small-sigma path only runs
        # when some pattern sigma_half < 0.5 (never for the default tables).
        object.__setattr__(
            self, "_skip_small", bool(host.lut_sigma.min() >= 0.5)
        )

    @property
    def pattern(self) -> DevicePattern:
        return self._pattern

    @property
    def skip_small(self) -> bool:
        return self._skip_small

    @property
    def descriptor_bytes(self) -> int:
        return self._host_pattern.descriptor_bytes

    def _scale_index(self, size: jnp.ndarray) -> jnp.ndarray:
        return scale_index(size, self.scale_invariant)

    def __call__(
        self, img: jnp.ndarray, keypoints: KeyPoints
    ) -> tuple[KeyPoints, jnp.ndarray]:
        """Compute descriptors (jit entry point; threads the pattern
        tables in as runtime arguments — see DevicePattern docs).

        Returns (updated keypoints with angle set and border-filtered
        valid mask, descriptors (K, descriptor_words) uint32).
        """
        return extract_descriptors(
            self._pattern,
            img,
            keypoints,
            rotation_invariant=self.rotation_invariant,
            scale_invariant=self.scale_invariant,
            skip_small=self._skip_small,
            angle_exact=self.angle_exact,
            v1_rounding=(self.version == "v1"
                         and self.pattern_file is None),
        )


def scale_index(size: jnp.ndarray, scale_invariant: bool) -> jnp.ndarray:
    """Keypoint size -> pattern scale index (doDescriptorComputation:629)."""
    log2 = np.float32(0.693147180559945)
    lb_scalerange = np.float32(np.log(SCALERANGE) / log2)
    basic_size06 = np.float32(BASIC_SIZE * 0.6)
    if scale_invariant:
        val = (
            np.float32(SCALES) / lb_scalerange
            * (jnp.log(size / basic_size06) / log2)
            + 0.5
        )
        idx = jnp.maximum(_trunc_i32(val), 0)
        return jnp.minimum(idx, SCALES - 1)
    basic = max(
        int(
            np.float32(SCALES)
            / lb_scalerange
            * (np.log(np.float32(1.45 * BASIC_SIZE) / basic_size06) / log2)
            + 0.5
        ),
        0,
    )
    return jnp.full_like(size, basic, dtype=jnp.int32)


@partial(
    jax.jit,
    static_argnames=(
        "rotation_invariant", "scale_invariant", "skip_small", "angle_exact", "v1_rounding",
    ),
)
def extract_descriptors(
    pat: DevicePattern,
    img: jnp.ndarray,
    keypoints: KeyPoints,
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    skip_small: bool = False,
    angle_exact: bool = False,
    v1_rounding: bool = False,
) -> tuple[KeyPoints, jnp.ndarray]:
    """BRISK description with the pattern as a runtime pytree argument.

    uint8 images use the reference-exact fixed-point path; uint16 images
    use the float path scaled to [0, 1] with a float integral
    (SmoothedIntensity<float, float> x65536 — smoothed_intensity_f32
    docs; the reference's own 16-bit wiring is latently broken).
    """
    rows, cols = img.shape
    if img.dtype == jnp.uint16:
        from ethzasl_brisk_jax.kernels.integral import integral_image_16_f32

        integral = jax.lax.optimization_barrier(integral_image_16_f32(img))
        img = img.astype(jnp.float32) / 65536.0
    else:
        integral = jax.lax.optimization_barrier(integral_image_i32(img))
    return _describe_core(
        pat, img, integral, rows, cols, keypoints,
        row_base=None,
        rotation_invariant=rotation_invariant,
        scale_invariant=scale_invariant,
        skip_small=skip_small, angle_exact=angle_exact,
        v1_rounding=v1_rounding,
    )


@partial(
    jax.jit,
    static_argnames=(
        "rotation_invariant", "scale_invariant", "skip_small", "angle_exact", "v1_rounding",
    ),
)
def extract_descriptors_batch(
    pat: DevicePattern,
    imgs: jnp.ndarray,        # (B, H, W) uint8
    keypoints: KeyPoints,     # batched (B, K) fields
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    skip_small: bool = False,
    angle_exact: bool = False,
    v1_rounding: bool = False,
) -> tuple[KeyPoints, jnp.ndarray]:
    """Batched description as ONE flat call (no per-frame vmap).

    Stacks the per-frame images/integrals along rows (one padding row per
    frame so image and integral share the (H+1) row stride) and shifts
    each keypoint's sampling rows by an INTEGER ``row_base = frame*(H+1)``
    applied only to integer gather/anchor coordinates — all fractional
    fixed-point math stays frame-local, so every tap weight is
    bit-identical to the per-frame path. (Adding the offset to the f32
    keypoint y instead rounds away fractional bits once the stacked
    coordinate exceeds ~2^11 — measured last-ULP angle drift even at
    frame 0 via arctan2 shape-dependence.)
    """
    b, h, w = imgs.shape
    k = keypoints.x.shape[-1]
    img_pad, int_flat = _stack_frames(imgs)
    row_base = jnp.repeat(jnp.arange(b, dtype=jnp.int32) * (h + 1), k)

    flat_kp = jax.tree_util.tree_map(
        lambda a: a.reshape((b * k,) + a.shape[2:]), keypoints
    )
    out_kp, desc = _describe_core(
        pat, img_pad, int_flat, h, w, flat_kp,
        row_base=row_base,
        rotation_invariant=rotation_invariant,
        scale_invariant=scale_invariant,
        skip_small=skip_small,
    )
    out_kp = jax.tree_util.tree_map(
        lambda a: a.reshape((b, k) + a.shape[1:]), out_kp
    )
    return out_kp, desc.reshape(b, k, -1)


@partial(
    jax.jit,
    static_argnames=(
        "capacity", "rotation_invariant", "scale_invariant", "skip_small", "angle_exact", "v1_rounding",
        "with_diagnostics",
    ),
)
def extract_descriptors_compact(
    pat: DevicePattern,
    imgs: jnp.ndarray,        # (B, H, W) uint8
    keypoints: KeyPoints,     # batched (B, K) fields
    *,
    capacity: int,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    skip_small: bool = False,
    angle_exact: bool = False,
    v1_rounding: bool = False,
    with_diagnostics: bool = False,
) -> tuple[KeyPoints, jnp.ndarray]:
    """Batched description over a VALID-COMPACTED static budget.

    The batched layout pads every frame to K keypoint slots, but after
    uniformity only a fraction are valid — and the sampler's cost is per
    SLOT regardless of validity. This entry compacts the valid
    keypoints of the whole batch to the front (stable flat order), runs
    ONE describe call over a static ``capacity`` prefix, and
    un-permutes the results back to the (B, K) layout via gathers (no
    scatter). Values are bit-identical to extract_descriptors_batch for
    every described keypoint. ``capacity`` budgets the DESCRIBABLE
    population — keypoints that are valid AND inside the pattern border
    (the same RoiPredicate test _describe_core applies; border-rejected
    keypoints never consume a slot and keep their original fields with
    angle=-1, invalid either way). If more than ``capacity`` keypoints
    are describable, the overflow (lowest-priority in flat order) is
    dropped with valid=False — a static capacity knob of the same class
    as max_candidates/max_keypoints.

    ``with_diagnostics=True`` appends the batch-total describable count
    as a third return (device scalar int32): ``count <= capacity``
    certifies no overflow on THIS batch (bench.py / library consumers).
    """
    b, h, w = imgs.shape
    k = keypoints.x.shape[-1]
    n = b * k
    capacity = min(capacity, n)
    img_pad, int_flat = _stack_frames(imgs)

    flat_kp = jax.tree_util.tree_map(
        lambda a: a.reshape((n,) + a.shape[2:]), keypoints
    )
    # Compact DESCRIBABLE keypoints only: keypoints outside the pattern
    # border get valid=False from _describe_core's RoiPredicate filter
    # regardless (brisk-descriptor-extractor.cc:532-536), so spending
    # capacity slots on them only inflates the budget the capacity must
    # cover (~580 detect-valid vs ~441 describable per bench frame).
    # Applying the same border test BEFORE compaction is value-neutral
    # for every described keypoint and lets `capacity` track the
    # describable population.
    describable = _describable_mask(pat, h, w, flat_kp, scale_invariant)
    order = jnp.argsort(~describable, stable=True)  # describable first
    sel = order[:capacity]
    comp_kp = jax.tree_util.tree_map(
        lambda a: jnp.take(a, sel, axis=0), flat_kp
    )
    frame_of = (sel // k).astype(jnp.int32)
    row_base = frame_of * (h + 1)

    out_kp_c, desc_c = _describe_core(
        pat, img_pad, int_flat, h, w, comp_kp,
        row_base=row_base,
        rotation_invariant=rotation_invariant,
        scale_invariant=scale_invariant,
        skip_small=skip_small, angle_exact=angle_exact,
        v1_rounding=v1_rounding,
    )

    # Un-permute via gather: pad the compacted results to n rows, then
    # take with the inverse permutation (position of each original slot
    # in `order`; slots beyond `capacity` read the padding = invalid).
    inv = jnp.argsort(order, stable=True)  # (n,) position in order

    described = (inv < capacity).reshape(b, k)

    def unpack(comp, fill):
        pad = jnp.full((n - capacity,) + comp.shape[1:], fill, comp.dtype)
        full = jnp.concatenate([comp, pad], axis=0)
        return jnp.take(full, inv, axis=0)

    def merged(field, orig):
        u = unpack(getattr(out_kp_c, field), 0).reshape(b, k)
        return jnp.where(described, u, orig)

    out_kp = KeyPoints(
        x=merged("x", keypoints.x),
        y=merged("y", keypoints.y),
        size=merged("size", keypoints.size),
        angle=merged("angle", keypoints.angle),
        response=merged("response", keypoints.response),
        octave=merged("octave", keypoints.octave),
        # Overflow slots (valid but beyond capacity) are dropped.
        valid=unpack(out_kp_c.valid, False).reshape(b, k) & described,
    )
    desc = unpack(desc_c, 0).reshape(b, k, -1)
    if with_diagnostics:
        return out_kp, desc, jnp.sum(describable.astype(jnp.int32))
    return out_kp, desc


def _describable_mask(pat, h, w, flat_kp, scale_invariant=True):
    """The DESCRIBABLE predicate (valid AND inside the pattern border —
    the RoiPredicate filter _describe_core applies,
    brisk-descriptor-extractor.cc:532-536). Single source of truth for
    extract_descriptors_compact's budget AND the capacity certs."""
    scale_idx_c = scale_index(flat_kp.size, scale_invariant)
    bf_c = pat.size_list[scale_idx_c].astype(jnp.float32)
    return (
        flat_kp.valid
        & (flat_kp.x >= bf_c) & (flat_kp.x < w - bf_c)
        & (flat_kp.y >= bf_c) & (flat_kp.y < h - bf_c)
    )


def describable_count(pat, imgs, keypoints, *, scale_invariant=True):
    """Batch-total describable keypoints — the exact population
    ``extract_descriptors_compact``'s ``capacity`` must cover. Cheap
    (no sampling): certify ``describable_count(...) <= capacity``
    before enabling a compaction budget on new data (bench.py does)."""
    _, h, w = imgs.shape
    flat_kp = jax.tree_util.tree_map(
        lambda a: a.reshape((-1,) + a.shape[2:]), keypoints
    )
    return jnp.sum(
        _describable_mask(pat, h, w, flat_kp, scale_invariant)
        .astype(jnp.int32)
    )


def _stack_frames(imgs: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Stack (B, H, W) frames along rows with an (H+1) row stride.

    Returns (img_pad (B*(H+1), W), int_flat (B*(H+1), W+1)): one zero
    padding row per frame keeps image and integral on the same stride so
    a single integer ``row_base = frame*(H+1)`` addresses both.
    """
    b, h, w = imgs.shape
    integral = jax.vmap(integral_image_i32)(imgs)  # (B, H+1, W+1)
    int_flat = integral.reshape(b * (h + 1), w + 1)
    img_pad = jnp.concatenate(
        [imgs, jnp.zeros((b, 1, w), imgs.dtype)], axis=1
    ).reshape(b * (h + 1), w)
    return img_pad, int_flat


@partial(
    jax.jit,
    static_argnames=(
        "rotation_invariant", "scale_invariant", "skip_small", "angle_exact", "v1_rounding",
    ),
)
def extract_descriptors_views(
    pat: DevicePattern,
    imgs: jnp.ndarray,        # (V, H, W) uint8 view images
    keypoints: KeyPoints,     # FLAT (K,) fields, coords in view space
    view_idx: jnp.ndarray,    # (K,) i32 — which view each keypoint lives in
    *,
    rotation_invariant: bool = True,
    scale_invariant: bool = True,
    skip_small: bool = False,
    angle_exact: bool = False,
    v1_rounding: bool = False,
    view_cols: jnp.ndarray | None = None,  # (V,) i32 true view widths
    view_rows: jnp.ndarray | None = None,  # (V,) i32 true view heights
) -> tuple[KeyPoints, jnp.ndarray]:
    """Describe a flat keypoint set where each keypoint samples from its
    own frame of a stacked set (camera-aware virtual views).

    Same stacked-frame layout as :func:`extract_descriptors_batch`, but
    with an arbitrary per-keypoint frame assignment instead of contiguous
    (B, K) blocks — ONE dense describe call covers every view (the
    reference loops views and re-runs compute per group,
    brisk/src/camera-aware-feature.cc:590-640). ``view_cols/rows`` give
    each view's TRUE size when the stacked images are padded to a common
    shape: the border filter (RoiPredicate,
    brisk-descriptor-extractor.cc:532-536) then applies per view.
    """
    v, h, w = imgs.shape
    img_pad, int_flat = _stack_frames(imgs)
    row_base = view_idx.astype(jnp.int32) * (h + 1)
    return _describe_core(
        pat, img_pad, int_flat, h, w, keypoints,
        row_base=row_base,
        rotation_invariant=rotation_invariant,
        scale_invariant=scale_invariant,
        skip_small=skip_small, angle_exact=angle_exact,
        v1_rounding=v1_rounding,
        col_limit=None if view_cols is None else view_cols[view_idx],
        row_limit=None if view_rows is None else view_rows[view_idx],
    )


def _describe_core(
    pat: DevicePattern,
    img: jnp.ndarray,
    integral: jnp.ndarray,
    rows: int,
    cols: int,
    keypoints: KeyPoints,
    *,
    row_base,
    rotation_invariant: bool,
    scale_invariant: bool,
    skip_small: bool,
    angle_exact: bool = False,
    v1_rounding: bool = False,
    col_limit: jnp.ndarray | None = None,  # (K,) per-keypoint true width
    row_limit: jnp.ndarray | None = None,
) -> tuple[KeyPoints, jnp.ndarray]:
    scale_idx = scale_index(keypoints.size, scale_invariant)  # (K,)
    border = pat.size_list[scale_idx]  # (K,) i32
    bf = border.astype(jnp.float32)
    w_lim = cols if col_limit is None else col_limit.astype(jnp.float32)
    h_lim = rows if row_limit is None else row_limit.astype(jnp.float32)
    inside = (
        (keypoints.x >= bf)
        & (keypoints.x < w_lim - bf)
        & (keypoints.y >= bf)
        & (keypoints.y < h_lim - bf)
    )
    valid = keypoints.valid & inside

    # key_x/key_y stay FRAME-LOCAL; the stacked-frame layout enters only
    # through the integer ``row_base`` the sampler adds to its integer
    # gather rows (never to the f32 coordinates, which would round away
    # fractional bits — extract_descriptors_batch docs).
    key_x, key_y = keypoints.x, keypoints.y
    sigma = pat.lut_sigma[scale_idx]
    scaling = pat.lut_scaling[scale_idx]
    scaling2 = pat.lut_scaling2[scale_idx]

    if img.dtype == jnp.float32:
        # 16-bit pipeline (scaled float image + float integral).
        def sample(px, py):
            return smoothed_intensity_f32(
                img, integral, key_x, key_y, px, py, sigma,
                4.0 * sigma * sigma,
                row_base=row_base, frame_rows=rows,
            )
    else:
        def sample(px, py):
            return smoothed_intensity_u8(
                img, integral, key_x, key_y, px, py, sigma,
                scaling, scaling2, skip_small=skip_small,
                v1_rounding=v1_rounding,
                row_base=row_base, frame_rows=rows,
            )

    # ---- Phase 1: orientation from unrotated samples + long pairs.
    need_angle = keypoints.angle == -1.0
    pat_x0 = pat.lut_x[scale_idx, 0]  # (K, P)
    pat_y0 = pat.lut_y[scale_idx, 0]
    vals0 = sample(pat_x0, pat_y0)
    if rotation_invariant:
        delta_t = vals0[:, pat.long_i] - vals0[:, pat.long_j]  # (K, L)
        d0 = jnp.sum(
            _trunc_div(delta_t * pat.long_wdx[None, :], 1024), axis=1
        )
        d1 = jnp.sum(
            _trunc_div(delta_t * pat.long_wdy[None, :], 1024), axis=1
        )
        if angle_exact:
            # Host libm double-atan2 chain, bit-exact to the
            # reference (brisk-descriptor-extractor.cc:732-739;
            # brisk-v1.cc:472 — CPU parity path).
            angle, theta = jax.pure_callback(
                _exact_angle_host,
                (
                    jax.ShapeDtypeStruct(d0.shape, jnp.float32),
                    jax.ShapeDtypeStruct(d0.shape, jnp.int32),
                ),
                d0, d1, keypoints.angle, need_angle,
                vmap_method="sequential",
            )
        else:
            computed_angle = (
                jnp.arctan2(d1.astype(jnp.float32), d0.astype(jnp.float32))
                / np.float32(np.pi)
                * 180.0
            )
            angle = jnp.where(need_angle, computed_angle, keypoints.angle)
            theta = _trunc_i32(N_ROT * angle / 360.0 + 0.5)
            theta = jnp.where(theta < 0, theta + N_ROT, theta)
            theta = jnp.where(theta >= N_ROT, theta - N_ROT, theta)
    else:
        angle = keypoints.angle
        theta = jnp.zeros_like(scale_idx)

    # ---- Phase 2: rotated samples + short-pair bits.
    pat_xr = pat.lut_x[scale_idx, theta]  # (K, P)
    pat_yr = pat.lut_y[scale_idx, theta]
    vals = sample(pat_xr, pat_yr)
    return _pack_descriptor(pat, keypoints, angle, vals, valid)


def _pack_descriptor(pat, keypoints, angle, vals, valid):
    """384 short-pair comparisons -> 12 uint32 words LSB-first
    (setDescriptorBits, brisk-descriptor-extractor.cc:538-564)."""
    bits = vals[:, pat.short_i] > vals[:, pat.short_j]  # (K, Sh)
    k = bits.shape[0]
    n_words = pat.descriptor_words
    n_bits = bits.shape[1]
    padded = jnp.zeros((k, n_words * 32), bool).at[:, :n_bits].set(bits)
    weights = (1 << jnp.arange(32, dtype=jnp.uint32)).astype(jnp.uint32)
    desc = jnp.sum(
        padded.reshape(k, n_words, 32).astype(jnp.uint32)
        * weights[None, None, :],
        axis=-1,
        dtype=jnp.uint32,
    )
    desc = jnp.where(valid[:, None], desc, 0)

    out_kp = dataclasses.replace(keypoints, angle=angle, valid=valid)
    return out_kp, desc
