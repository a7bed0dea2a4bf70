"""Host-side rotation/shear for the record pipeline; the port's copy of
``resnet_tpu/data/host_warp.py``, code for code.

The reference runs its warpAffine augmentation in the CPU input pipeline
(ref: src/io/image_aug_default.cc: max_rotate_angle / max_shear_ratio are
applied by the decode-thread augmenter), and so does this module: one PIL
affine per image, in a thread pool beside the decode work.

Geometry is that of the device path (ops/augment.py rotate_images):
inverse map about the canvas centre, horizontal shear composed with
rotation, bilinear taps, zero (constant) border. The host path resamples
u8 -> u8, as warpAffine on decoded images does, while the device path
stays float32, so the two differ by rounding.

Determinism/resume: per-batch parameters come from a counter-based numpy
Generator keyed on (seed, epoch, batch_index), so a mid-epoch resume
replays the identical warp stream (pipeline.py cursor contract).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np


def batch_params(seed: int, epoch: int, batch_idx: int, n: int,
                 max_angle_deg: float, max_shear_ratio: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image (angles_rad, shears) for one batch — pure function of
    (seed, epoch, batch_idx), independent of thread schedule or resume
    point (unlike the reference's per-decode-thread RNG, which makes its
    aug stream schedule-dependent)."""
    rng = np.random.default_rng([seed, epoch, batch_idx])
    angles = rng.uniform(-max_angle_deg, max_angle_deg, n) * (np.pi / 180.0)
    shears = rng.uniform(-max_shear_ratio, max_shear_ratio, n)
    return angles, shears


def affine_coeffs(angle_rad: float, shear: float, h: int, w: int):
    """PIL Image.transform AFFINE coefficients for the inverse map used
    by ops/augment.py rotate_images: undo shear [[1, s], [0, 1]] then
    rotation, both about the pixel-index center ((h-1)/2, (w-1)/2).

        ux = (x - cx) - s*(y - cy);  uy = (y - cy)
        sx = cx + uy*sin + ux*cos;   sy = cy + uy*cos - ux*sin

    PIL's bilinear transform evaluates the map at output pixel CENTERS
    (x+0.5, y+0.5) and samples the input at (src-0.5) in index space
    (verified empirically: a 90-degree index-space rotation lands one
    pixel off without compensation, pure translations land exactly), so
    the effective index map of a coefficient tuple (a,b,c,...) is
    src_idx = a*x + b*y + (c + 0.5*(a+b) - 0.5). The returned offsets
    fold that compensation in, making the EFFECTIVE map exactly the
    index-space map above.
    """
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = float(np.cos(angle_rad)), float(np.sin(angle_rad))
    a = cos
    b = sin - cos * shear
    d = -sin
    e = cos + sin * shear
    c = (cx - a * cx - b * cy) - 0.5 * (a + b) + 0.5
    f = (cy - d * cx - e * cy) - 0.5 * (d + e) + 0.5
    return (a, b, c, d, e, f)


def warp_image(img_u8: np.ndarray, angle_rad: float,
               shear: float) -> np.ndarray:
    """One (H,W,3) u8 canvas -> warped u8 canvas (bilinear, zero border).

    The input is zero-padded by one pixel before the transform: PIL
    clamp-replicates edge taps, but the in-graph path zero-masks them,
    and the pad ring turns PIL's clamped taps into zeros — measured
    max diff vs rotate_images after this: 1 u8 count (pure rounding).
    """
    from PIL import Image
    h, w = img_u8.shape[:2]
    padded = np.zeros((h + 2, w + 2, 3), np.uint8)
    padded[1:-1, 1:-1] = img_u8
    a, b, c, d, e, f = affine_coeffs(angle_rad, shear, h, w)
    out = Image.fromarray(padded).transform(
        (w, h), Image.AFFINE, (a, b, c + 1.0, d, e, f + 1.0),
        resample=Image.BILINEAR, fillcolor=(0, 0, 0))
    return np.asarray(out)


def warp_batch(images_u8: np.ndarray, angles: np.ndarray,
               shears: np.ndarray,
               pool: Optional[ThreadPoolExecutor] = None) -> np.ndarray:
    """Warp a (N,H,W,3) u8 batch in place of the device rotate. PIL's
    transform releases the GIL, so a thread pool scales it across host
    cores alongside the decode pool."""
    n = len(images_u8)
    if pool is None:
        return np.stack([warp_image(images_u8[i], angles[i], shears[i])
                         for i in range(n)])
    return np.stack(list(pool.map(
        warp_image, images_u8, angles, shears)))
