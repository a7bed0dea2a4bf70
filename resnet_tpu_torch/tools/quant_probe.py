"""int8 against bf16 on ResNet-50's serving shapes. Port of
``tools/quant_probe.py``.

The question: would an int8 serving path beat the bf16 one on these
shapes, or are they bound by memory, where int8 can win only the halved
bytes? Three shapes of the bs128 serving forward:

  - dot 25088x1024x256 (a stage-3 1x1 conv), dot 401408x64x256 (a
    stage-1 1x1 conv): ``torch._int_mm`` (int8 in, int32 out) against
    bf16 ``torch.mm``;
  - the 3x3 conv 128x14x14x256 (stage 3): torch has no int8 convolution
    on CUDA, so its int8 leg is im2col plus ``torch._int_mm``
    (:func:`conv3x3_int8`; ``F.unfold`` takes no int8, so it unfolds in
    bf16, exact for |v| <= 256, then casts), set beside cuDNN's bf16 conv.
    That leg is not a fused convolution: its JSON gives the unfold's time
    apart.

Each time is the median of ``--windows`` windows of ``--iters``
back-to-back calls, CUDA events around each window, with the port's
default backend switches (cuDNN times its algorithms, as in training).
The int8 results are checked exact: a dot's sampled rows against an
int64 product, the conv's leading images against a float64 convolution
on the CPU.

    python -m resnet_tpu_torch.tools.quant_probe [--iters 30]
    python -m resnet_tpu_torch.tools.quant_probe --quick --device cpu

``--quick`` runs tiny shapes (the host clock times them on the CPU).
Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Callable

import torch
import torch.nn.functional as F

from resnet_tpu_torch.utils.device import resolve_device

SAMPLE_ROWS = 64       # rows of an int8 product checked against int64
SAMPLE_IMAGES = 2      # images of the int8 conv checked in float64


def conv3x3_int8(x8: torch.Tensor, k8: torch.Tensor) -> torch.Tensor:
    """3x3/1 SAME convolution of int8 NHWC ``x8`` by the int8 HWIO kernel
    ``k8`` (3, 3, C, O) into int32 NHWC: im2col (``F.unfold`` in bf16,
    exact on int8 values, cast back) and one ``torch._int_mm``."""
    n, h, w, c = x8.shape
    cols = unfold3x3(x8)
    wmat = k8.permute(2, 0, 1, 3).reshape(c * 9, -1)   # (c, kh, kw) rows
    return torch._int_mm(cols, wmat.contiguous()).reshape(n, h, w, -1)


def unfold3x3(x8: torch.Tensor) -> torch.Tensor:
    """(N*H*W, C*9) int8 patches of NHWC ``x8``, ``F.unfold``'s (c, kh,
    kw) order, zero padded by one."""
    n, h, w, c = x8.shape
    cols = F.unfold(x8.permute(0, 3, 1, 2).to(torch.bfloat16), 3, padding=1)
    return cols.transpose(1, 2).reshape(n * h * w, c * 9).to(torch.int8)


def window_ms(fn: Callable, device, iters: int, windows: int) -> float:
    """Median ms a call over ``windows`` windows of ``iters`` calls, after
    one warm-up call: CUDA events on the card, the host clock on the
    CPU."""
    fn()
    times = []
    for _ in range(windows):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            tic = time.perf_counter()
            for _ in range(iters):
                fn()
            times.append((time.perf_counter() - tic) * 1e3 / iters)
    return statistics.median(times)


def _exact_rows(got: torch.Tensor, a8: torch.Tensor, b8: torch.Tensor
                ) -> bool:
    """Rows spread over ``got`` (M, N) int32 equal the int64 product."""
    m = a8.shape[0]
    rows = torch.linspace(0, m - 1, min(SAMPLE_ROWS, m)).long()
    want = a8[rows.to(a8.device)].cpu().long() @ b8.cpu().long()
    return torch.equal(got[rows.to(got.device)].cpu().long(), want)


def _exact_conv(got: torch.Tensor, x8: torch.Tensor, k8: torch.Tensor
                ) -> bool:
    """The leading images of ``got`` (NHWC int32) equal a float64
    convolution on the CPU, exact at these magnitudes (< 2^53)."""
    x = x8[:SAMPLE_IMAGES].cpu().permute(0, 3, 1, 2).double()
    want = F.conv2d(x, k8.cpu().permute(3, 2, 0, 1).double(), padding=1)
    return torch.equal(got[:SAMPLE_IMAGES].cpu().long(),
                       want.permute(0, 2, 3, 1).long())


def dot_case(m, k, n, label, gen, device, iters, windows) -> dict:
    a8 = torch.randint(-127, 127, (m, k), generator=gen, dtype=torch.int8)
    b8 = torch.randint(-127, 127, (k, n), generator=gen, dtype=torch.int8)
    abf = torch.randn((m, k), generator=gen).to(torch.bfloat16)
    bbf = torch.randn((k, n), generator=gen).to(torch.bfloat16)
    a8, b8, abf, bbf = (t.to(device) for t in (a8, b8, abf, bbf))
    t_bf = window_ms(lambda: torch.mm(abf, bbf), device, iters, windows)
    t_i8 = window_ms(lambda: torch._int_mm(a8, b8), device, iters, windows)
    flops = 2 * m * k * n
    return {"case": "dot", "shape": [m, k, n], "label": label,
            "bf16_ms": t_bf, "int8_ms": t_i8,
            "bf16_tflops": flops / t_bf / 1e9,
            "int8_tops": flops / t_i8 / 1e9, "speedup": t_bf / t_i8,
            "int8_exact": _exact_rows(torch._int_mm(a8, b8), a8, b8)}


def conv_case(nb, h, w, c, label, gen, device, iters, windows) -> dict:
    x8 = torch.randint(-127, 127, (nb, h, w, c), generator=gen,
                       dtype=torch.int8)
    k8 = torch.randint(-127, 127, (3, 3, c, c), generator=gen,
                       dtype=torch.int8)
    xbf = torch.randn((nb, c, h, w), generator=gen).to(torch.bfloat16)
    kbf = torch.randn((c, c, 3, 3), generator=gen).to(torch.bfloat16)
    x8, k8 = x8.to(device), k8.to(device)
    xbf = xbf.to(device).contiguous(memory_format=torch.channels_last)
    kbf = kbf.to(device).contiguous(memory_format=torch.channels_last)
    t_bf = window_ms(lambda: F.conv2d(xbf, kbf, padding=1), device, iters,
                     windows)
    t_i8 = window_ms(lambda: conv3x3_int8(x8, k8), device, iters, windows)
    t_unfold = window_ms(lambda: unfold3x3(x8), device, iters, windows)
    flops = 2 * nb * h * w * c * c * 9
    return {"case": "conv3x3", "shape": [nb, h, w, c], "label": label,
            "bf16_ms": t_bf, "int8_ms": t_i8, "int8_unfold_ms": t_unfold,
            "int8_matmul_ms": t_i8 - t_unfold,
            "bf16_tflops": flops / t_bf / 1e9,
            "int8_tops": flops / t_i8 / 1e9, "speedup": t_bf / t_i8,
            "int8_exact": _exact_conv(conv3x3_int8(x8, k8), x8, k8),
            "int8_leg": "im2col (F.unfold in bf16, cast to int8) + "
                        "torch._int_mm; not a fused convolution",
            "bf16_leg": "F.conv2d, channels_last (cuDNN on the card)",
            "cudnn_benchmark": torch.backends.cudnn.benchmark}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes, to try the harness on the CPU")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def probe(args) -> list:
    """The three cases' records (``--quick``: two tiny ones), with the
    port's default backend switches on (``utils/xla_opts.py``: cuDNN
    picks its algorithms by timing them, as in training) and put back
    after."""
    from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                                 compiler_options)
    device = resolve_device(args.device)
    restore = apply_backend_options(compiler_options(backend=device.type))
    try:
        return _cases(args, device)
    finally:
        restore()


def _cases(args, device) -> list:
    gen = torch.Generator().manual_seed(0)
    run = dict(gen=gen, device=device, iters=args.iters,
               windows=args.windows)
    if args.quick:
        return [dot_case(256, 64, 64, "quick", **run),
                conv_case(2, 8, 8, 32, "quick", **run)]
    # representatives of the bs128 serving forward
    return [dot_case(128 * 14 * 14, 1024, 256, "stage-3 1x1", **run),
            conv_case(128, 14, 14, 256, "stage-3 3x3", **run),
            dot_case(128 * 56 * 56, 64, 256, "stage-1 1x1", **run)]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    for rec in probe(args):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
