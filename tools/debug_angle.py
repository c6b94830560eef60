"""Debug: per-point smoothed-intensity + orientation vs scalar reference port."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["JAX_ENABLE_X64"] = "1"

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from ethzasl_brisk_jax.core.golden import read_set
from ethzasl_brisk_jax.core.pattern import brisk_v2_pattern

SET = "/root/reference/brisk/src/test/test_data/brisk_verification_harris.set"

f32 = np.float32


def scalar_smoothed_intensity(image, integral, key_x, key_y, pat, scale, rot,
                              point):
    """Scalar port with exact C float semantics."""
    bx = pat.lut_x[scale, rot, point]
    by = pat.lut_y[scale, rot, point]
    sigma_half = pat.lut_sigma[scale, point]
    xf = f32(bx + f32(key_x))
    yf = f32(by + f32(key_y))
    x = int(xf)
    y = int(yf)
    cols = image.shape[1]
    area = f32(f32(4.0) * sigma_half * sigma_half)
    img = image.astype(np.int64)
    itg = integral.astype(np.int64)
    if sigma_half < 0.5:
        r_x = int(f32(xf - x) * 1024)
        r_y = int(f32(yf - y) * 1024)
        r_x_1 = 1024 - r_x
        r_y_1 = 1024 - r_y
        ret = (r_x_1 * r_y_1 * img[y, x]
               + r_x * r_y_1 * img[y, x + 1]
               + r_x * r_y * img[y + 1, x + 1]
               + r_x_1 * r_y * img[y + 1, x])
        return int(ret) // 1024
    scaling = int(np.float64(4194304.0) / np.float64(area))
    scaling2 = int(np.float64(f32(f32(scaling) * area)) / 1024.0)
    x_1 = f32(xf - sigma_half)
    x1 = f32(xf + sigma_half)
    y_1 = f32(yf - sigma_half)
    y1 = f32(yf + sigma_half)
    x_left = int(f32(x_1 + 0.5))
    y_top = int(f32(y_1 + 0.5))
    x_right = int(f32(x1 + 0.5))
    y_bottom = int(f32(y1 + 0.5))
    r_x_1 = f32(f32(x_left) - x_1 + f32(0.5))
    r_y_1 = f32(f32(y_top) - y_1 + f32(0.5))
    r_x1 = f32(x1 - f32(x_right) + f32(0.5))
    r_y1 = f32(y1 - f32(y_bottom) + f32(0.5))
    A = int(f32(r_x_1 * r_y_1) * scaling)
    B = int(f32(r_x1 * r_y_1) * scaling)
    C = int(f32(r_x1 * r_y1) * scaling)
    D = int(f32(r_x_1 * r_y1) * scaling)
    r_x_1_i = int(r_x_1 * scaling)
    r_y_1_i = int(r_y_1 * scaling)
    r_x1_i = int(r_x1 * scaling)
    r_y1_i = int(r_y1 * scaling)
    ret = (A * img[y_top, x_left] + B * img[y_top, x_right]
           + C * img[y_bottom, x_right] + D * img[y_bottom, x_left])
    t1 = itg[y_top, x_left + 1]
    t2 = itg[y_top, x_right]
    t3 = itg[y_top + 1, x_right]
    t4 = itg[y_top + 1, x_right + 1]
    t5 = itg[y_bottom, x_right + 1]
    t6 = itg[y_bottom, x_right]
    t7 = itg[y_bottom + 1, x_right]
    t8 = itg[y_bottom + 1, x_left + 1]
    t9 = itg[y_bottom, x_left + 1]
    t10 = itg[y_bottom, x_left]
    t11 = itg[y_top + 1, x_left]
    t12 = itg[y_top + 1, x_left + 1]
    upper = (t3 - t2 + t1 - t12) * r_y_1_i
    middle = (t6 - t3 + t12 - t9) * scaling
    left = (t9 - t12 + t11 - t10) * r_x_1_i
    right = (t5 - t4 + t3 - t6) * r_x1_i
    bottom = (t7 - t6 + t9 - t8) * r_y1_i
    total = int(ret + upper + middle + left + right + bottom)
    q = abs(total) // scaling2
    return q if total >= 0 else -q


def main():
    import jax.numpy as jnp

    from ethzasl_brisk_jax.describe.extractor import (
        BriskExtractor,
        smoothed_intensity_u8,
    )
    from ethzasl_brisk_jax.kernels.integral import integral_image_i32

    entries = read_set(SET)
    e = entries[0]
    img = e.image
    pat = brisk_v2_pattern(1.0)
    ext = BriskExtractor()
    dp = ext.pattern
    integral = np.asarray(integral_image_i32(jnp.asarray(img)))

    kp = e.keypoints[5]
    print("kp:", kp)
    size = np.float32(kp.size)
    scale_idx = int(np.asarray(ext._scale_index(jnp.asarray([size]))))
    print("scale_idx:", scale_idx)

    # Scalar per-point vals at rot 0.
    vals_scalar = np.array(
        [
            scalar_smoothed_intensity(
                img, integral, kp.x, kp.y, pat, scale_idx, 0, i
            )
            for i in range(pat.n_points)
        ]
    )

    # Vectorized vals.
    kx = jnp.asarray([kp.x], jnp.float32)
    ky = jnp.asarray([kp.y], jnp.float32)
    si = jnp.asarray([scale_idx])
    vals_vec = np.asarray(
        smoothed_intensity_u8(
            jnp.asarray(img),
            jnp.asarray(integral),
            kx,
            ky,
            dp.lut_x[si, 0],
            dp.lut_y[si, 0],
            dp.lut_sigma[si],
            dp.lut_scaling[si],
            dp.lut_scaling2[si],
        )
    )[0]

    diff = vals_scalar - vals_vec
    print("n diff:", (diff != 0).sum(), "max:", np.abs(diff).max())
    bad = np.where(diff != 0)[0]
    for i in bad[:10]:
        print(
            f"  pt {i}: scalar {vals_scalar[i]} vec {vals_vec[i]} "
            f"sigma {pat.lut_sigma[scale_idx, i]}"
        )

    # Orientation from scalar vals.
    d0 = d1 = 0
    for (i, j), (wdx, wdy) in zip(pat.long_pairs, pat.long_weights):
        dt = int(vals_scalar[i]) - int(vals_scalar[j])
        t0 = dt * int(wdx)
        t1 = dt * int(wdy)
        d0 += int(abs(t0) // 1024 * (1 if t0 >= 0 else -1))
        d1 += int(abs(t1) // 1024 * (1 if t1 >= 0 else -1))
    ang = np.degrees(np.arctan2(np.float32(d1), np.float32(d0)))
    print(f"scalar d0 {d0} d1 {d1} angle {ang:.5f} golden {kp.angle:.5f}")


if __name__ == "__main__":
    main()
