"""The training augmentation, plain float32, for the benchmark's
comparison: the per-step random draws worked out again from the run's
seed, then MXNet's random-resized crop over the letterboxed canvas,
bilinear resize with the mirror, additive HSL jitter and the mean/std
normalize.

The draws: the generator of step ``s`` is seeded from
``numpy.random.SeedSequence([seed, s])`` (its first 64-bit word, shifted
right once) on the canvases' device, and gives, in this order, four
``(N, 10)`` uniforms for ten crop attempts, ``N`` uniforms for the mirror
(p = 0.5), and ``N`` uniforms each for the hue, saturation and lightness
shifts. A crop is drawn in the original image's pixels (``dims``: the
original and the letterboxed extent) and scaled onto the canvas. These
are the training recipe's definitions; the program draws them on the
same generator, so both sides crop the same boxes.

``space_to_depth`` regroups a crop into the 2x2 blocks in which the
program's augmenter hands the s2d stem its input, for the comparison
only; the reference's network takes the standard layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def step_generator(seed: int, step: int, device) -> torch.Generator:
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def _first(m: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(m, 1, idx[:, None])[:, 0]


def crop_boxes(gen: torch.Generator, dims: torch.Tensor, data: dict):
    """Random-resized-crop boxes in canvas pixels, (y0, x0, h, w), each
    (N,): ten attempts of area ~ U[min, max] of the image and aspect ~
    U[1 - a, 1 + a]; the first that fits wins, at an origin uniform over
    the valid range; none fitting, the centred square of the short side."""
    n = dims.shape[0]
    dev = dims.device
    u_area, u_ratio, u_y, u_x = (torch.rand((n, 10), generator=gen,
                                            device=dev) for _ in range(4))
    h = dims[:, 0].float()[:, None]
    w = dims[:, 1].float()[:, None]
    lo, hi = data["min_random_area"], data["max_random_area"]
    a = data["max_aspect_ratio"]
    area = (lo + u_area * (hi - lo)) * h * w
    ratio = (1.0 - a) + u_ratio * ((1.0 + a) - (1.0 - a))
    cw = torch.round(torch.sqrt(area * ratio))
    ch = torch.round(torch.sqrt(area / ratio))
    fits = (cw <= w) & (ch <= h) & (cw >= 1) & (ch >= 1)
    first = fits.to(torch.uint8).argmax(dim=1)
    any_fit = fits.any(dim=1)
    h, w = h[:, 0], w[:, 0]
    short = torch.minimum(h, w)
    cw = torch.where(any_fit, _first(cw, first), short)
    ch = torch.where(any_fit, _first(ch, first), short)
    uy, ux = _first(u_y, first), _first(u_x, first)
    y0 = torch.where(any_fit,
                     torch.minimum(torch.floor(uy * (h - ch + 1.0)), h - ch),
                     torch.floor((h - ch) / 2.0))
    x0 = torch.where(any_fit,
                     torch.minimum(torch.floor(ux * (w - cw + 1.0)), w - cw),
                     torch.floor((w - cw) / 2.0))
    sy = dims[:, 2].float() / h
    sx = dims[:, 3].float() / w
    return y0 * sy, x0 * sx, ch * sy, cw * sx


def draws(seed: int, step: int, dims: torch.Tensor, data: dict) -> dict:
    """The values step ``step`` of a run seeded ``seed`` applies to its
    batch (``dims`` (N, 4) int: original h, w, letterboxed h, w)."""
    gen = step_generator(seed, step, dims.device)
    n = dims.shape[0]
    boxes = crop_boxes(gen, dims, data)
    flip = torch.rand((n,), generator=gen, device=dims.device) < 0.5

    def uniform(r):
        return -r + torch.rand((n,), generator=gen, device=dims.device) \
            * (2.0 * r)

    dh, ds, dl = (uniform(float(data[k]))
                  for k in ("random_h", "random_s", "random_l"))
    return {"boxes": boxes, "flip": flip, "dh": dh, "ds": ds, "dl": dl,
            "valid": (dims[:, 2].float(), dims[:, 3].float())}


def _resample(start, size, out_size, src_size, valid, flip=None):
    """(N, out, src) bilinear weights: sample point ``start + (i + 0.5) *
    size / out - 0.5``, clipped to ``[0, valid - 1]``, weight
    ``max(0, 1 - |s - j|)``; ``flip`` reverses the output index."""
    dev = start.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)[None, :]
    if flip is not None:
        i = torch.where(flip[:, None], out_size - 1 - i, i)
    s = (start[:, None] + (i + 0.5) * (size / out_size)[:, None] - 0.5)
    s = torch.minimum(s.clamp_min(0.0), valid[:, None] - 1.0)
    j = torch.arange(src_size, dtype=torch.float32, device=dev)
    return (1.0 - (s[:, :, None] - j).abs()).clamp_min(0.0)


def _hsl_shift(x: torch.Tensor, dh, ds, dl) -> torch.Tensor:
    """Additive shift in OpenCV's HLS units (hue in [0, 180), lightness
    and saturation in [0, 255]) of float RGB in [0, 255], (N, H, W, 3)."""
    shape = (x.shape[0], 1, 1)
    dh, ds, dl = (d.float().reshape(shape) for d in (dh, ds, dl))
    x = x / 255.0
    r, g, b = x.unbind(-1)
    cmax = torch.maximum(torch.maximum(r, g), b)
    cmin = torch.minimum(torch.minimum(r, g), b)
    delta = cmax - cmin
    lum = (cmax + cmin) / 2.0
    some = delta > 1e-8
    zero = torch.zeros_like(delta)
    sat = torch.where(some, delta / (1.0 - (2.0 * lum - 1.0).abs() + 1e-8),
                      zero)
    hue = torch.where(some & (cmax == r),
                      torch.remainder((g - b) / (delta + 1e-8), 6.0), zero)
    hue = hue + torch.where(some & (cmax == g) & (cmax != r),
                            (b - r) / (delta + 1e-8) + 2.0, zero)
    hue = hue + torch.where(some & (cmax == b) & (cmax != r) & (cmax != g),
                            (r - g) / (delta + 1e-8) + 4.0, zero)
    hue = torch.remainder(hue * 30.0 + dh, 180.0) / 30.0
    lum = (lum + dl / 255.0).clamp(0.0, 1.0)
    sat = (sat + ds / 255.0).clamp(0.0, 1.0)
    c = (1.0 - (2.0 * lum - 1.0).abs()) * sat
    xx = c * (1.0 - (torch.remainder(hue, 2.0) - 1.0).abs())
    m = lum - c / 2.0
    sector = hue.to(torch.int32) % 6
    table = ((c, xx, zero), (xx, c, zero), (zero, c, xx),
             (zero, xx, c), (xx, zero, c), (c, zero, xx))
    out = []
    for ch in range(3):
        v = table[5][ch]
        for k in (4, 3, 2, 1, 0):
            v = torch.where(sector == k, table[k][ch], v)
        out.append(v + m)
    return (torch.stack(out, dim=-1) * 255.0).clamp(0.0, 255.0)


def augment(canvas_u8: torch.Tensor, d: dict, out_hw: Tuple[int, int],
            data: dict) -> torch.Tensor:
    """(N, H, W, 3) uint8 canvases and a step's draws -> normalized float32
    (N, oh, ow, 3)."""
    n, sh, sw, c = canvas_u8.shape
    oh, ow = out_hw
    y0, x0, ch, cw = d["boxes"]
    vh, vw = d["valid"]
    wy = _resample(y0, ch, oh, sh, vh)
    wx = _resample(x0, cw, ow, sw, vw, flip=d["flip"])
    rows = torch.bmm(wy, canvas_u8.float().reshape(n, sh, sw * c))
    x = torch.einsum("nws,nhsc->nhwc", wx, rows.reshape(n, oh, sw, c))
    x = _hsl_shift(x, d["dh"], d["ds"], d["dl"])
    mean = torch.tensor(data["mean_rgb"], dtype=torch.float32,
                        device=x.device)
    inv_std = torch.tensor([1.0 / s for s in data["std_rgb"]],
                           dtype=torch.float32, device=x.device)
    return (x - mean) * inv_std


def normalize(images_u8: torch.Tensor, data: dict) -> torch.Tensor:
    """The serving input: uint8 -> ``(x - mean) / std`` in float32."""
    mean = torch.tensor(data["mean_rgb"], dtype=torch.float32,
                        device=images_u8.device)
    std = torch.tensor(data["std_rgb"], dtype=torch.float32,
                       device=images_u8.device)
    return (images_u8.float() - mean) / std


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/2, W/2, 4C), channels in (row, column, c)
    order of each 2x2 block."""
    n, h, w, c = x.shape
    return (x.reshape(n, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
             .reshape(n, h // 2, w // 2, 4 * c))


def touched(start, size, valid, out_size: int, src_size: int,
            ) -> torch.Tensor:
    """(N,) the source lines a crop's bilinear taps touch with a non-zero
    weight."""
    w = _resample(start, size, out_size, src_size, valid)
    return (w > 0).any(dim=1).sum(dim=1)
