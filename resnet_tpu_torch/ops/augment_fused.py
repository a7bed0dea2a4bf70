"""The fused augmentation kernel's wrapper, its plain version, and the
train-time augmenters built on it.

Port of ``resnet_tpu/ops/augment_pallas.py``. The kernel
(``csrc/augment.cu``) takes a uint8 NHWC canvas and one float32 row of 12
per-image values, ``y0, x0, ch, cw, flip, vh, vw, dh, ds, dl, alpha,
beta``, and emits the normalized crop. Randomness is drawn outside it,
from an explicit ``torch.Generator``, so a test can hand the kernel the
values the JAX samplers drew.

Two variants route around the fused form by configuration, as in the JAX
package: the rotate/shear warp (the kernel reads a uint8 canvas, the warp
makes a float32 one, which the plain version crops), and
``augment_impl="pallas-split"`` (the kernel crops with identity
normalization into float32, and the photometric jitter and normalize run
as plain ops after it).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from resnet_tpu_torch.config import DTYPES, Config, DataConfig
from resnet_tpu_torch.ops.augment import (_rgb_to_hsl_adjust,
                                          augment_cifar,
                                          crop_resize_bilinear,
                                          finish_normalize, replica_draw,
                                          rotate_images, sample_boxes_canvas,
                                          sample_rotate)
from resnet_tpu_torch.utils.op_count import report_kernel

ROW_LEN = 12
_OUT_DTYPES = (torch.bfloat16, torch.float32)
# the kernel's launch geometry (csrc/augment.cu)
AUG_THREADS = 128
AUG_MAX_BAND = 8            # output rows a block owns, at most
AUG_SMEM_TARGET = 48 * 1024  # a band whose shared memory needs more is halved
AUG_SMEM_MAX = 232448       # 227 KB, a block's most on sm_90


class AugPlan(NamedTuple):
    band_rows: int     # output rows a block owns (even in s2d)
    staged_rows: int   # canvas rows a block stages (0: none)
    staged_cols: int   # canvas columns a staged row may span
    smem_bytes: int    # dynamic shared memory a block
    bands: int         # blocks an image: the grid is (bands, N)


def band_source_rows(band: int, sh: int, oh: int) -> int:
    """Canvas rows a band of ``band`` output rows taps at most, for any crop
    inside an ``sh``-row canvas: its first and last sample points lie at
    most ``(band-1)*sh/oh`` apart, so their floors differ by at most that
    rounded down plus one, and the last point's second tap adds a row; and
    no more than the canvas's rows and the one past it."""
    return min((band - 1) * sh // oh + 3, sh + 1)


def aug_smem_bytes(ow: int, band: int, staged_rows: int,
                   staged_cols: int) -> int:
    """The kernel's dynamic shared memory: 16-byte taps of the ``ow``
    columns and the ``band`` rows, the vertical pass (``band`` x
    ``staged_cols`` float4) and the staged canvas rows,
    ``floor((3*staged_cols + 30) / 16)`` 16-byte chunks a row."""
    raw_pitch = (3 * staged_cols + 30) // 16 * 16
    return 16 * (ow + band + band * staged_cols) + staged_rows * raw_pitch


@functools.lru_cache(maxsize=None)
def aug_plan(sh: int, sw: int, oh: int, ow: int, s2d: bool) -> AugPlan:
    """Launch geometry of the augmentation kernel for an ``(sh, sw)``
    canvas and ``(oh, ow)`` output: the largest band, up to
    ``AUG_MAX_BAND`` rows (even in s2d), whose shared memory stays within
    ``AUG_SMEM_TARGET``; the smallest band where none does. A window spans
    at most ``sw + 1`` columns (the taps clamp to the canvas). Where even
    the smallest band exceeds a block's shared memory the kernel stages
    nothing and reads its taps from the canvas; a band whose crop taps
    more rows than the plan staged (rows no sampler draws) does the same,
    so no shape is refused."""
    step = 2 if s2d else 1
    cols = sw + 1

    def smem(band):
        return aug_smem_bytes(ow, band, band_source_rows(band, sh, oh), cols)

    band = min(AUG_MAX_BAND, -(-oh // step) * step)
    while band > step and smem(band) > AUG_SMEM_TARGET:
        band = max(step, band // 2 // step * step)
    staged = band_source_rows(band, sh, oh)
    if smem(band) > AUG_SMEM_MAX:
        staged = 0
    cols = cols if staged else 0
    return AugPlan(band, staged, cols,
                   aug_smem_bytes(ow, band, staged, cols), -(-oh // band))


def _check_args(canvas_u8: torch.Tensor, rows: torch.Tensor,
                out_hw: Tuple[int, int], dtype, s2d: bool) -> None:
    if canvas_u8.dtype != torch.uint8 or canvas_u8.ndim != 4 \
            or canvas_u8.shape[-1] != 3:
        raise ValueError("canvas must be uint8 (N, H, W, 3), got "
                         f"{canvas_u8.dtype} {tuple(canvas_u8.shape)}")
    n = canvas_u8.shape[0]
    if rows.dtype != torch.float32 or tuple(rows.shape) != (n, ROW_LEN):
        raise ValueError(f"rows must be float32 ({n}, {ROW_LEN}), got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if rows.device != canvas_u8.device:
        raise ValueError("canvas and rows must be on one device")
    if dtype not in _OUT_DTYPES:
        raise ValueError(f"output dtype must be one of {_OUT_DTYPES}")
    oh, ow = out_hw
    if s2d and (oh % 2 or ow % 2):
        raise ValueError(f"s2d augmentation needs even output, got {out_hw}")


def _photometric_normalize(x: torch.Tensor, rows: torch.Tensor, mean_rgb,
                          std_rgb, dtype, hsl: bool, contrast: bool,
                          illum: bool) -> torch.Tensor:
    """The kernel's per-pixel steps on a float32 crop (N, H, W, 3) or its
    s2d blocks (N, H/2, W/2, 12), which run on a (..., 4, 3) view: HSL
    jitter, then the normalize with contrast and illumination, and the
    cast, with the values of the (N, 12) rows."""
    dh, ds, dl, alpha, beta = rows[:, 7:].unbind(1)
    shape = x.shape
    x = x.reshape(shape[:-1] + (-1, 3))
    if hsl:
        x = _rgb_to_hsl_adjust(x, dh, ds, dl)
    x = finish_normalize(x, mean_rgb, std_rgb, dtype,
                         alpha=alpha if contrast else None,
                         beta=beta if illum else None)
    return x.reshape(shape)


def _crop_normalize_plain(canvas: torch.Tensor, rows: torch.Tensor,
                          out_hw, mean_rgb, std_rgb, dtype, s2d, hsl,
                          contrast, illum) -> torch.Tensor:
    y0, x0, ch, cw, flip, vh, vw = rows[:, :7].unbind(1)
    x = crop_resize_bilinear(canvas, (y0, x0, ch, cw), out_hw,
                             flip=flip > 0.5, valid_hw=(vh, vw), s2d=s2d)
    return _photometric_normalize(x, rows, mean_rgb, std_rgb, dtype, hsl,
                                 contrast, illum)


def fused_crop_mirror_normalize_reference(
        canvas_u8: torch.Tensor, rows: torch.Tensor,
        out_hw: Tuple[int, int], mean_rgb: Sequence[float],
        std_rgb: Sequence[float], dtype=torch.bfloat16, *,
        s2d: bool = False, hsl: bool = False, contrast: bool = False,
        illum: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: dense resample weights,
    ``Wy @ img`` then ``·Wx``, then HSL jitter, normalize and cast, all
    driven by the same (N, 12) rows. With ``s2d`` the per-pixel steps run
    on a (..., 4, 3) view of the blocked crop."""
    _check_args(canvas_u8, rows, out_hw, dtype, s2d)
    return _crop_normalize_plain(canvas_u8, rows, out_hw, mean_rgb, std_rgb,
                                 dtype, s2d, hsl, contrast, illum)


def fused_crop_mirror_normalize(
        canvas_u8: torch.Tensor, rows: torch.Tensor,
        out_hw: Tuple[int, int], mean_rgb: Sequence[float],
        std_rgb: Sequence[float], dtype=torch.bfloat16, *,
        s2d: bool = False, hsl: bool = False, contrast: bool = False,
        illum: bool = False) -> torch.Tensor:
    """(N,Hc,Wc,3) uint8 canvas + (N,12) rows -> (N,oh,ow,3) normalized
    ``dtype``, or (N,oh/2,ow/2,12) in the (py, px, c) block order with
    ``s2d``.

    On a CUDA tensor it launches the CUDA kernel and raises if the launch
    fails; on a CPU tensor it runs the plain version.
    ``fused_crop_mirror_normalize.launches`` counts kernel launches; each
    is reported to the active op counter (``utils/op_count.py``).
    """
    if canvas_u8.device.type == "cpu":
        return fused_crop_mirror_normalize_reference(
            canvas_u8, rows, out_hw, mean_rgb, std_rgb, dtype, s2d=s2d,
            hsl=hsl, contrast=contrast, illum=illum)
    if canvas_u8.device.type != "cuda":
        raise ValueError(f"unsupported device {canvas_u8.device}")
    _check_args(canvas_u8, rows, out_hw, dtype, s2d)
    if not (canvas_u8.is_contiguous() and rows.is_contiguous()):
        raise ValueError("canvas and rows must be contiguous")
    n, sh, sw, _ = canvas_u8.shape
    oh, ow = out_hw
    if n > 65535:
        raise ValueError(f"at most 65535 images per launch, got {n}")
    if sh * sw * 3 >= 2 ** 31:
        raise ValueError(f"an image of at most 2^31 bytes, got {sh}x{sw}")
    shape = (n, oh // 2, ow // 2, 12) if s2d else (n, oh, ow, 3)
    out = torch.empty(shape, dtype=dtype, device=canvas_u8.device)
    from resnet_tpu_torch._build import load_library
    lib = load_library("augment")
    plan = aug_plan(sh, sw, oh, ow, bool(s2d))
    mean = [float(m) for m in mean_rgb]
    inv_std = [1.0 / float(s) for s in std_rgb]
    with torch.cuda.device(canvas_u8.device):
        err = lib.fused_crop_mirror_normalize_launch(
            canvas_u8.data_ptr(), rows.data_ptr(), out.data_ptr(),
            n, sh, sw, oh, ow, plan.band_rows, plan.staged_rows,
            plan.staged_cols, plan.smem_bytes, *mean, *inv_std,
            int(dtype == torch.bfloat16), int(s2d), int(hsl),
            int(contrast), int(illum),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"fused_crop_mirror_normalize kernel launch failed: CUDA error "
            f"{err}")
    fused_crop_mirror_normalize.launches += 1
    # no products; its bound's bytes: each input read once, the output
    # written once
    report_kernel("fused_crop_mirror_normalize", 0,
                  sum(t.numel() * t.element_size()
                      for t in (canvas_u8, rows, out)))
    return out


fused_crop_mirror_normalize.launches = 0


def sample_photometric(generator: torch.Generator, cfg: DataConfig, n: int,
                       device=None) -> dict:
    """Per-image photometric jitter values: ``dh/ds/dl`` (HSL, when any
    range is set), ``alpha`` (contrast) and ``beta`` (illumination), each
    uniform over its configured range, (n,) float32."""
    def uniform(lo, hi):
        u = torch.rand((n,), generator=generator, device=device)
        return lo + u * (hi - lo)

    ph = {}
    if cfg.random_h or cfg.random_s or cfg.random_l:
        ph["dh"] = uniform(-cfg.random_h, cfg.random_h)
        ph["ds"] = uniform(-cfg.random_s, cfg.random_s)
        ph["dl"] = uniform(-cfg.random_l, cfg.random_l)
    if cfg.max_random_contrast > 0:
        c = cfg.max_random_contrast
        ph["alpha"] = uniform(1.0 - c, 1.0 + c)
    if cfg.max_random_illumination > 0:
        il = cfg.max_random_illumination
        ph["beta"] = uniform(-il, il)
    return ph


def augment_rows(boxes, flip: Optional[torch.Tensor], valid_hw,
                 photometric: dict, n: int, canvas_hw: Tuple[int, int],
                 device=None) -> torch.Tensor:
    """Pack per-image values into the kernel's (N, 12) float32 rows;
    missing values default as the JAX wrapper does (no flip, the whole
    canvas valid, zero jitter)."""
    zeros = torch.zeros((n,), device=device)
    if valid_hw is None:
        valid_hw = (torch.full((n,), float(canvas_hw[0]), device=device),
                    torch.full((n,), float(canvas_hw[1]), device=device))
    cols = [*boxes, zeros if flip is None else flip, *valid_hw,
            *(photometric.get(k, zeros)
              for k in ("dh", "ds", "dl", "alpha", "beta"))]
    return torch.stack([c.float() for c in cols], dim=1).contiguous()


def augment_imagenet_fused(canvas_u8: torch.Tensor,
                           generator: Optional[torch.Generator],
                           cfg: DataConfig,
                           out_hw: Tuple[int, int] = (224, 224),
                           dtype=torch.bfloat16,
                           dims: Optional[torch.Tensor] = None,
                           s2d: bool = False,
                           rows: Optional[torch.Tensor] = None,
                           plain: bool = False,
                           split: bool = False,
                           warp: Optional[Tuple[torch.Tensor,
                                                torch.Tensor]] = None,
                           replica: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """Train-time ImageNet augmentation through the fused kernel: MXNet
    random-resized-crop boxes (full-image domain when ``dims`` gives the
    original sizes), mirror with p=0.5, HSL/contrast/illumination jitter,
    normalize and cast. The drop-in for ``augment_imagenet_pallas``.

    The per-image values are drawn from ``generator`` in the order boxes,
    mirror, photometrics, unless ``rows`` (N, 12) supplies them; then,
    when ``max_rotate_angle`` or ``max_shear_ratio`` is set, the warp's
    angles and shears, unless ``warp`` supplies them.
    ``plain=True`` applies them with the kernel's plain PyTorch version on
    every device (``augment_impl="xla"``). The warp, by configuration,
    always does: it makes a float32 canvas, and the kernel reads uint8.
    ``split=True`` (``augment_impl="pallas-split"``): the kernel crops
    with identity normalization into float32 and the photometric steps run
    after it as plain ops; without a photometric jitter this is the fused
    launch.
    ``replica`` = (rank, world): the values drawn are the global batch's
    (``ops/augment.py::replica_draw``); the images' own ``dims`` stand in
    for the other ranks', whose values are dropped.
    """
    n, hc, wc, _ = canvas_u8.shape
    dev = canvas_u8.device
    rotate = cfg.max_rotate_angle > 0 or cfg.max_shear_ratio > 0
    n_draw, mine = replica_draw(n, replica)
    if rows is None:
        d_all = (dims if dims is None or n_draw == n
                 else dims.repeat(n_draw // n, 1))
        boxes = sample_boxes_canvas(generator, cfg, n_draw, hc, wc, out_hw,
                                    d_all, device=dev)
        flip = (torch.rand((n_draw,), generator=generator, device=dev) < 0.5
                if cfg.rand_mirror else None)
        valid = (d_all[:, 2], d_all[:, 3]) if dims is not None else None
        ph = sample_photometric(generator, cfg, n_draw, device=dev)
        rows = augment_rows(boxes, flip, valid, ph, n_draw, (hc, wc),
                            device=dev)[mine].contiguous()
    hsl = bool(cfg.random_h or cfg.random_s or cfg.random_l)
    contrast = cfg.max_random_contrast > 0
    illum = cfg.max_random_illumination > 0
    norm = (cfg.mean_rgb, cfg.std_rgb, dtype)
    if rotate:
        if warp is None:
            warp = tuple(v[mine] for v in sample_rotate(
                generator, cfg, n_draw, device=dev))
        return _crop_normalize_plain(rotate_images(canvas_u8, *warp), rows,
                                     out_hw, *norm, s2d, hsl, contrast,
                                     illum)
    if split and not plain and (hsl or contrast or illum):
        x = fused_crop_mirror_normalize(canvas_u8, rows, out_hw,
                                        (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
                                        torch.float32, s2d=s2d)
        return _photometric_normalize(x, rows, *norm, hsl, contrast, illum)
    apply = (fused_crop_mirror_normalize_reference if plain
             else fused_crop_mirror_normalize)
    return apply(canvas_u8, rows, out_hw, *norm, s2d=s2d, hsl=hsl,
                 contrast=contrast, illum=illum)


def make_augment_fn(cfg: Config) -> Callable:
    """The train step's augmenter for ``cfg``, as the JAX Solver picks it:
    ``augment_cifar`` for CIFAR-10; else ``augment_imagenet_fused`` with
    output ``image_shape[:2]`` in the compute dtype, in the s2d block
    layout when ``aug_s2d``, through the kernel unless
    ``augment_impl="xla"`` selects the plain version
    (``"pallas-split"``: the split photometric form). Returns
    ``f(canvas_u8, generator, dims=None, rows=None, replica=None)``."""
    dtype = DTYPES[cfg.train.dtype]
    d = cfg.data
    if cfg.model.dataset == "cifar10":
        def cifar_fn(images_u8, generator, dims=None, rows=None,
                     replica=None):
            return augment_cifar(images_u8, generator, d, dtype, rows=rows,
                                 replica=replica)
        return cifar_fn
    out_hw = tuple(d.image_shape[:2])
    s2d = cfg.train.aug_s2d
    if s2d and (not cfg.train.stem_s2d or cfg.model.version != 1
                or out_hw[0] % 2 or out_hw[1] % 2):
        raise ValueError(
            "--aug-s2d (augmenter emits space-to-depth blocks) needs "
            "--stem-s2d, a v1 network, the ImageNet stem and an even "
            "output size")
    plain = d.augment_impl == "xla"
    split = d.augment_impl == "pallas-split"

    def augment_fn(canvas_u8, generator, dims=None, rows=None,
                   replica=None):
        return augment_imagenet_fused(canvas_u8, generator, d, out_hw,
                                      dtype, dims=dims, s2d=s2d, rows=rows,
                                      plain=plain, split=split,
                                      replica=replica)
    return augment_fn
