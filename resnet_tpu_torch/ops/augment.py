"""On-device augmentation in plain PyTorch.

Port of ``resnet_tpu/ops/augment.py``: MXNet random-resized-crop box
sampling, bilinear crop-resize with the mirror folded into the horizontal
weights, additive HSL jitter, and the mean/std normalize, which are the
plain version the hand-written augmentation kernel
(``ops/augment_fused.py``, ``csrc/augment.cu``) is held against; the
rotate/shear warp, a bilinear gather the kernel does not do; and the
CIFAR pad-and-crop.

Randomness: every sampler takes an explicit ``torch.Generator``, and the
functions that apply random values take the values themselves, so tests
can feed both frameworks the same numbers. Images are NHWC, as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from resnet_tpu_torch.config import DataConfig


def _inv_std(std_rgb: Sequence[float], device) -> torch.Tensor:
    # 1/std taken in double, then rounded to float32: the constants the
    # augmentation kernel receives
    return torch.tensor([1.0 / float(s) for s in std_rgb], dtype=torch.float32,
                        device=device)


def normalize(images: torch.Tensor, mean_rgb, std_rgb,
              dtype=torch.float32) -> torch.Tensor:
    """uint8 [0,255] NHWC -> normalized ``dtype`` (the eval path)."""
    mean = torch.tensor(mean_rgb, dtype=torch.float32, device=images.device)
    inv_std = 1.0 / torch.tensor(std_rgb, dtype=torch.float32,
                                 device=images.device)
    return ((images.float() - mean) * inv_std).to(dtype)


def finish_normalize(images: torch.Tensor, mean_rgb, std_rgb,
                     dtype=torch.float32,
                     alpha: Optional[torch.Tensor] = None,
                     beta: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Train-time normalize epilogue: ``((x - mean) * alpha + beta) / std``.

    ``alpha`` (contrast) and ``beta`` (illumination) are per-image (N,)
    values, or None when the jitter is off. ``1/std`` is rounded from
    double as in the kernel; the JAX package divides in float32 here, a
    difference of at most one float32 ulp in the constant.
    """
    x = images.float() - torch.tensor(mean_rgb, dtype=torch.float32,
                                      device=images.device)
    bshape = (x.shape[0],) + (1,) * (x.ndim - 1)
    if alpha is not None:
        x = x * alpha.float().reshape(bshape)
    if beta is not None:
        x = x + beta.float().reshape(bshape)
    return (x * _inv_std(std_rgb, images.device)).to(dtype)


def aspect_range(max_aspect_ratio: float,
                 min_aspect_ratio: Optional[float] = None):
    """MXNet aspect-ratio convention: ``[min, max]`` when ``min`` is given,
    else ``[1 - a, 1 + a]`` for ``a <= 1`` and ``[1/a, a]`` above 1."""
    if min_aspect_ratio is not None:
        if not 0 < min_aspect_ratio <= max_aspect_ratio:
            raise ValueError(
                f"aspect range [{min_aspect_ratio}, {max_aspect_ratio}] "
                "is empty")
        return float(min_aspect_ratio), float(max_aspect_ratio)
    a = float(max_aspect_ratio)
    if a < 0:
        raise ValueError(f"max_aspect_ratio must be >= 0, got {a}")
    if a <= 1.0:
        return 1.0 - a, 1.0 + a
    return 1.0 / a, a


def _pick_first(m: torch.Tensor, first: torch.Tensor) -> torch.Tensor:
    return torch.gather(m, 1, first[:, None])[:, 0]


def boxes_from_uniforms(u_area, u_ratio, u_y, u_x, src_h, src_w,
                        min_area: float, max_area: float,
                        lo_aspect: float, hi_aspect: float):
    """MXNet random-resized-crop box math as a function of uniform draws.

    Per attempt: area ~ U[min_area, max_area]·H·W, ratio ~ U[lo, hi],
    ``cw = round(sqrt(area·ratio))``, ``ch = round(sqrt(area/ratio))``; the
    first attempt that fits wins, with an integer origin uniform over the
    valid range. When none fits: the centre square of the short side.
    ``u_*`` are (N, A) uniforms, ``src_h``/``src_w`` (N,).
    Returns float (y0, x0, ch, cw), each (N,).
    """
    src_h = src_h.float()[:, None]
    src_w = src_w.float()[:, None]
    area = (min_area + u_area * (max_area - min_area)) * src_h * src_w
    ratio = lo_aspect + u_ratio * (hi_aspect - lo_aspect)
    cw = torch.round(torch.sqrt(area * ratio))
    ch = torch.round(torch.sqrt(area / ratio))
    ok = (cw <= src_w) & (ch <= src_h) & (cw >= 1) & (ch >= 1)
    first = ok.to(torch.uint8).argmax(dim=1)        # first fitting attempt
    any_ok = ok.any(dim=1)
    src_h, src_w = src_h[:, 0], src_w[:, 0]
    short = torch.minimum(src_h, src_w)
    cw = torch.where(any_ok, _pick_first(cw, first), short)
    ch = torch.where(any_ok, _pick_first(ch, first), short)
    uy = _pick_first(u_y, first)
    ux = _pick_first(u_x, first)
    y0_rand = torch.minimum(torch.floor(uy * (src_h - ch + 1.0)), src_h - ch)
    x0_rand = torch.minimum(torch.floor(ux * (src_w - cw + 1.0)), src_w - cw)
    y0 = torch.where(any_ok, y0_rand, torch.floor((src_h - ch) / 2.0))
    x0 = torch.where(any_ok, x0_rand, torch.floor((src_w - cw) / 2.0))
    return y0, x0, ch, cw


def sample_crop_boxes(generator: torch.Generator, src_h, src_w,
                      min_area: float, max_area: float,
                      max_aspect_ratio: float,
                      min_aspect_ratio: Optional[float] = None,
                      attempts: int = 10):
    """Random-resized-crop boxes over per-image source dims (N,)."""
    lo, hi = aspect_range(max_aspect_ratio, min_aspect_ratio)
    shape = (src_h.shape[0], attempts)
    u = [torch.rand(shape, generator=generator, device=src_h.device)
         for _ in range(4)]
    return boxes_from_uniforms(*u, src_h, src_w, min_area, max_area, lo, hi)


def scale_boxes_from_uniforms(u_scale, u_ratio, u_y, u_x, src_h, src_w,
                              min_scale: float, max_scale: float,
                              lo_aspect: float, hi_aspect: float,
                              rand_crop: bool):
    """MXNet's classic scale crop as a source box: a window of
    ``short/s x short/(s·ratio)`` pixels, placed at random or centred."""
    src_h = src_h.float()
    src_w = src_w.float()
    short = torch.minimum(src_h, src_w)
    s = min_scale + u_scale * (max_scale - min_scale)
    ratio = lo_aspect + u_ratio * (hi_aspect - lo_aspect)
    ch = torch.minimum(torch.round(short / s).clamp_min(1.0), src_h)
    cw = torch.minimum(torch.round(short / (s * ratio)).clamp_min(1.0), src_w)
    if rand_crop:
        y0 = torch.minimum(torch.floor(u_y * (src_h - ch + 1.0)), src_h - ch)
        x0 = torch.minimum(torch.floor(u_x * (src_w - cw + 1.0)), src_w - cw)
    else:
        y0 = torch.floor((src_h - ch) / 2.0)
        x0 = torch.floor((src_w - cw) / 2.0)
    return y0, x0, ch, cw


def sample_boxes_canvas(generator: torch.Generator, cfg: DataConfig, n: int,
                        hc: int, wc: int, out_hw: Tuple[int, int],
                        dims: Optional[torch.Tensor] = None,
                        device=None):
    """Crop boxes sampled in ORIGINAL image space, returned in canvas
    coordinates.

    ``dims`` (N,4) = (orig_h, orig_w, eff_h, eff_w) from a letterboxing
    loader: boxes map onto the canvas by the per-image eff/orig scale.
    Without ``dims`` the canvas is the image.
    """
    if dims is None:
        src_h = torch.full((n,), float(hc), device=device)
        src_w = torch.full((n,), float(wc), device=device)
        sy = sx = torch.ones((n,), device=device)
    else:
        src_h = dims[:, 0].float()
        src_w = dims[:, 1].float()
        sy = dims[:, 2].float() / src_h
        sx = dims[:, 3].float() / src_w
    if cfg.random_resized_crop and cfg.rand_crop:
        y0, x0, ch, cw = sample_crop_boxes(
            generator, src_h, src_w, cfg.min_random_area,
            cfg.max_random_area, cfg.max_aspect_ratio, cfg.min_aspect_ratio)
    elif cfg.rand_crop or cfg.min_random_scale != 1.0 \
            or cfg.max_random_scale != 1.0:
        lo, hi = aspect_range(
            cfg.max_aspect_ratio if cfg.rand_crop else 0.0,
            cfg.min_aspect_ratio if cfg.rand_crop else None)
        u = [torch.rand((n,), generator=generator, device=src_h.device)
             for _ in range(4)]
        y0, x0, ch, cw = scale_boxes_from_uniforms(
            *u, src_h, src_w, cfg.min_random_scale, cfg.max_random_scale,
            lo, hi, cfg.rand_crop)
    else:
        # deterministic centre crop of the out_hw aspect
        oh, ow = out_hw
        short = torch.minimum(src_h, src_w)
        ch = torch.minimum(torch.round(short * (oh / max(oh, ow))), src_h)
        cw = torch.minimum(torch.round(short * (ow / max(oh, ow))), src_w)
        y0 = torch.floor((src_h - ch) / 2.0)
        x0 = torch.floor((src_w - cw) / 2.0)
    return y0 * sy, x0 * sx, ch * sy, cw * sx


def resample_weights(starts: torch.Tensor, sizes: torch.Tensor,
                     out_size: int, src_size: int,
                     flip: Optional[torch.Tensor] = None,
                     valid_size: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Per-example dense bilinear resampling matrices, (N, out, src).

    ``w[i, j] = max(0, 1 - |s_i - j|)`` with the cv2/MXNet coordinate
    ``s_i = start + (i + 0.5)·size/out - 0.5``, clipped to
    ``[0, valid_size - 1]`` (a letterboxed canvas is valid only up to the
    image's extent). ``flip`` (N,) bool reverses the output coordinate.
    """
    dev = starts.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    if flip is not None:
        i = torch.where(flip[:, None], out_size - 1 - i, i)
    scale = (sizes / out_size)[:, None]
    src = (starts[:, None] + (i + 0.5) * scale - 0.5).clamp_min(0.0)
    if valid_size is not None:
        src = torch.minimum(src, valid_size.float()[:, None] - 1.0)
    else:
        src = src.clamp_max(src_size - 1.0)
    j = torch.arange(src_size, dtype=torch.float32, device=dev)
    return (1.0 - (src[:, :, None] - j).abs()).clamp_min(0.0)


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) -> (N,H/2,W/2,4C), channel order (py, px, c): the layout
    the space-to-depth stem consumes pre-blocked."""
    n, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs even H and W, got {(h, w)}")
    return (x.reshape(n, h // 2, 2, w // 2, 2, c)
             .permute(0, 1, 3, 2, 4, 5)
             .reshape(n, h // 2, w // 2, 4 * c))


def crop_resize_bilinear(images: torch.Tensor, boxes,
                         out_hw: Tuple[int, int],
                         flip: Optional[torch.Tensor] = None,
                         valid_hw=None, s2d: bool = False) -> torch.Tensor:
    """Per-example crop box -> bilinear resize to ``out_hw``, float32.

    Two batched products with the dense weights, ``Wy @ img`` then ``·Wx``.
    ``s2d=True`` returns the same values regrouped by ``space_to_depth``.
    """
    y0, x0, ch, cw = boxes
    oh, ow = out_hw
    n, sh, sw, c = images.shape
    vh, vw = valid_hw if valid_hw is not None else (None, None)
    wy = resample_weights(y0, ch, oh, sh, valid_size=vh)          # (N,oh,sh)
    wx = resample_weights(x0, cw, ow, sw, flip=flip, valid_size=vw)
    tmp = torch.bmm(wy, images.float().reshape(n, sh, sw * c))
    out = torch.einsum("nws,nhsc->nhwc", wx, tmp.reshape(n, oh, sw, c))
    return space_to_depth(out) if s2d else out


def _rgb_to_hsl_adjust(images: torch.Tensor, dh: torch.Tensor,
                       ds: torch.Tensor, dl: torch.Tensor) -> torch.Tensor:
    """Additive HSL jitter on float32 [0,255] RGB, (n, ..., 3).

    ``dh``/``ds``/``dl`` are per-image (n,) deltas in OpenCV HLS units
    (H in [0,180), L and S in [0,255]). Same expressions, in the same
    order, as the JAX package's version, including both 1e-8 guards and
    the Python-style floor-mod (``torch.remainder``).
    """
    bshape = (images.shape[0],) + (1,) * (images.ndim - 2)
    dh, ds, dl = (d.float().reshape(bshape) for d in (dh, ds, dl))
    x = images / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    cmax = torch.maximum(torch.maximum(r, g), b)
    cmin = torch.minimum(torch.minimum(r, g), b)
    delta = cmax - cmin
    l = (cmax + cmin) / 2.0
    safe = delta > 1e-8
    zero = torch.zeros_like(delta)
    s = torch.where(safe, delta / (1.0 - (2.0 * l - 1.0).abs() + 1e-8), zero)
    hr = torch.where(safe & (cmax == r),
                     torch.remainder((g - b) / (delta + 1e-8), 6.0), zero)
    hg = torch.where(safe & (cmax == g) & (cmax != r),
                     (b - r) / (delta + 1e-8) + 2.0, zero)
    hb = torch.where(safe & (cmax == b) & (cmax != r) & (cmax != g),
                     (r - g) / (delta + 1e-8) + 4.0, zero)
    h = hr + hg + hb

    h = torch.remainder(h * 30.0 + dh, 180.0) / 30.0
    l = (l + dl / 255.0).clamp(0.0, 1.0)
    s = (s + ds / 255.0).clamp(0.0, 1.0)

    c = (1.0 - (2.0 * l - 1.0).abs()) * s
    xx = c * (1.0 - (torch.remainder(h, 2.0) - 1.0).abs())
    m = l - c / 2.0
    hi = h.to(torch.int32) % 6

    def sel(*vals):
        out = vals[5]
        for k in (4, 3, 2, 1, 0):
            out = torch.where(hi == k, vals[k], out)
        return out

    r2 = sel(c, xx, zero, zero, xx, c)
    g2 = sel(xx, c, c, xx, zero, zero)
    b2 = sel(zero, zero, xx, c, c, xx)
    out = torch.stack([r2 + m, g2 + m, b2 + m], dim=-1) * 255.0
    return out.clamp(0.0, 255.0)


def eval_center_crop(canvas_u8: torch.Tensor, cfg: DataConfig,
                     out_hw: Tuple[int, int] = (224, 224),
                     dtype=torch.float32) -> torch.Tensor:
    """Validation path: centre crop of the canvas, then normalize."""
    _, hc, wc, _ = canvas_u8.shape
    oh, ow = out_hw
    y0 = (hc - oh) // 2
    x0 = (wc - ow) // 2
    images = canvas_u8[:, y0:y0 + oh, x0:x0 + ow, :]
    return normalize(images, cfg.mean_rgb, cfg.std_rgb, dtype)


def sample_rotate(generator: torch.Generator, cfg: DataConfig, n: int,
                  device=None):
    """Per-image warp values: angles in radians, uniform over
    ``±max_rotate_angle`` degrees, and shears uniform over
    ``±max_shear_ratio``; (n,) float32 each."""
    u = torch.rand((2, n), generator=generator, device=device)
    a, s = float(cfg.max_rotate_angle), float(cfg.max_shear_ratio)
    return (-a + u[0] * (2 * a)) * (math.pi / 180.0), -s + u[1] * (2 * s)


def rotate_images(images: torch.Tensor, angles: torch.Tensor,
                  shears: torch.Tensor) -> torch.Tensor:
    """Per-image affine warp about the image centre: rotation by ``angles``
    (radians) composed with a horizontal shear by ``shears`` (ref:
    max_rotate_angle / max_shear_ratio, one warpAffine in MXNet's
    augmenter). One batched bilinear gather over (N, H, W, C) float32,
    out-of-bounds taps zero (warpAffine's constant border); the same
    expressions, in the same order, as the JAX package's."""
    n, h, w, _ = images.shape
    dev = images.device
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos = torch.cos(angles.float())[:, None, None]
    sin = torch.sin(angles.float())[:, None, None]
    # inverse map dst -> src: undo the shear [[1, s], [0, 1]], then the
    # rotation, both about the centre
    ux = (xx - cx)[None] - shears.float()[:, None, None] * (yy - cy)[None]
    uy = (yy - cy)[None]
    sy = cy + uy * cos - ux * sin
    sx = cx + uy * sin + ux * cos
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0)[..., None]
    wx = (sx - x0)[..., None]
    img = torch.arange(n, device=dev)[:, None, None]
    src = images.float()

    def corner(yi, xi):
        valid = ((yi >= 0) & (yi < h) & (xi >= 0) & (xi < w))[..., None]
        g = src[img, yi.clamp(0, h - 1).long(), xi.clamp(0, w - 1).long()]
        return torch.where(valid, g, torch.zeros((), device=dev))

    return (corner(y0, x0) * (1 - wy) * (1 - wx)
            + corner(y0, x0 + 1) * (1 - wy) * wx
            + corner(y0 + 1, x0) * wy * (1 - wx)
            + corner(y0 + 1, x0 + 1) * wy * wx)


def sample_cifar_rows(generator: torch.Generator, cfg: DataConfig, n: int,
                      device=None) -> torch.Tensor:
    """(n, 5) float32 rows of ``augment_cifar``'s values: crop offsets
    uniform over ``[0, 2·pad]``, the mirror with p=0.5 (when
    ``rand_mirror``), contrast ``alpha`` and illumination ``beta`` uniform
    over their ranges (1 and 0 when off)."""
    pad = int(cfg.pad)
    off = torch.randint(0, 2 * pad + 1, (2, n), generator=generator,
                        device=device).float()
    u = torch.rand((3, n), generator=generator, device=device)
    flip = (u[0] < 0.5).float() if cfg.rand_mirror else torch.zeros_like(u[0])
    c, il = cfg.max_random_contrast, cfg.max_random_illumination
    alpha = 1.0 - c + u[1] * (2 * c)
    beta = -il + u[2] * (2 * il)
    return torch.stack([off[0], off[1], flip, alpha, beta], dim=1)


def augment_cifar(images_u8: torch.Tensor, generator: Optional[torch.Generator],
                  cfg: DataConfig, dtype=torch.float32,
                  rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N,H,W,3) uint8 -> augmented, normalized (N,H,W,3) ``dtype``: pad
    by ``cfg.pad`` with ``cfg.fill_value``, crop
    H x W at (dy, dx), mirror, then ``finish_normalize`` with the contrast
    and illumination jitters when configured. The per-image values come
    from ``rows`` ((N, 5): dy, dx, flip, alpha, beta) or are drawn from
    ``generator``."""
    n, h, w, _ = images_u8.shape
    dev = images_u8.device
    pad = int(cfg.pad)
    if rows is None:
        rows = sample_cifar_rows(generator, cfg, n, device=dev)
    dy, dx, flip, alpha, beta = rows.unbind(1)
    padded = torch.nn.functional.pad(
        images_u8, (0, 0, pad, pad, pad, pad), value=int(cfg.fill_value))
    ys = dy.long()[:, None] + torch.arange(h, device=dev)
    cols = torch.arange(w, device=dev)
    xs = dx.long()[:, None] + torch.where(flip[:, None] > 0.5,
                                          w - 1 - cols, cols)
    img = torch.arange(n, device=dev)[:, None, None]
    crop = padded[img, ys[:, :, None], xs[:, None, :]]
    return finish_normalize(
        crop, cfg.mean_rgb, cfg.std_rgb, dtype,
        alpha=alpha if cfg.max_random_contrast > 0 else None,
        beta=beta if cfg.max_random_illumination > 0 else None)
