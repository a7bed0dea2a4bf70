"""Where the augmentation-to-stem boundary spends its time, on one card.
Port of ``tools/aug_fusion_probe.py``.

The ``imagenet_resnet50`` preset's augmenter (K1, ``csrc/augment.cu``)
writes the crop in the space-to-depth block layout the stem conv reads,
with the photometric jitter and the normalize inside the kernel. This
times three bs128 programs on the same canvases and the same per-image
values (drawn once, as the train step's samplers draw them):

  A  K1, fused s2d mode (bf16 out) + the stem (``models/resnet.py``
     ``StemConvS2D``, ``pre_blocked``), summed;
  B  K1 in split mode alone (``augment_impl="pallas-split"``'s launch:
     identity normalize, float32 out), summed: A - B is what the fused
     epilogue and the stem cost (``epilogue_ms_estimate(A-B)``);
  C  the kernel's plain PyTorch version (``augment_impl="xla"``) + the
     stem: the unfused anchor.

Each time is ms a call over ``--steps`` calls after ``--warmup``, CUDA
events around them, with the port's default backend switches (cuDNN
times its algorithms, as in training). For A and C the report lists what runs between the
augmenter and the stem's convolution: the kernels a profiler trace shows
there (read with ``utils/profiler.py``'s parser), each with the host op
that launched it, and the ops ``utils/op_count.py``'s counter sees there,
with their bytes.

    python -m resnet_tpu_torch.tools.aug_fusion_probe [--batch-size 128]
        [--steps 50] [--warmup 5]
    python -m resnet_tpu_torch.tools.aug_fusion_probe --device cpu \\
        --batch-size 2 --steps 2 --warmup 1

Runs on the card unless ``--device cpu``; without a card it raises. On
the CPU the host clock times the calls and there is no kernel list.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from typing import Callable, Dict

import torch

from resnet_tpu_torch.config import imagenet_resnet50
from resnet_tpu_torch.data.pipeline import canvas_size
from resnet_tpu_torch.ops.augment import sample_boxes_canvas
from resnet_tpu_torch.ops.augment_fused import (augment_imagenet_fused,
                                                augment_rows,
                                                fused_crop_mirror_normalize,
                                                sample_photometric)
from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.op_count import OpCounter

STEM_RANGE = "aug_fusion_probe:stem"
CONV_OPS = ("aten::cudnn_convolution", "aten::convolution",
            "aten::_convolution", "aten::conv2d")


def programs(cfg, canvas, dims, rows, stem) -> Dict[str, tuple]:
    """The three programs (module docstring) over fixed inputs, each an
    (augmenter, rest) pair: ``rest(augmenter())`` is the call."""
    d = cfg.data
    out_hw = tuple(d.image_shape[:2])

    def stem_sum(x):
        return stem(x.permute(0, 3, 1, 2), pre_blocked=True).float().sum()

    def aug(plain):
        return lambda: augment_imagenet_fused(
            canvas, None, d, out_hw, torch.bfloat16, dims=dims, s2d=True,
            rows=rows, plain=plain)

    def split():
        return fused_crop_mirror_normalize(
            canvas, rows, out_hw, (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
            torch.float32, s2d=True)

    return {"A_fused_aug_plus_s2d_stem": (aug(False), stem_sum),
            "B_split_crop_only": (split, torch.sum),
            "C_plain_aug_plus_s2d_stem": (aug(True), stem_sum)}


def inputs(cfg, n: int, device, seed: int = 0):
    """``n`` random uint8 canvases (the train canvas size), full-canvas
    ``dims`` and the (n, 12) per-image values the samplers draw."""
    h, w, _ = cfg.data.image_shape
    ch, cw = canvas_size((h, w))
    gen = torch.Generator(device=device).manual_seed(seed)
    canvas = torch.randint(0, 256, (n, ch, cw, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    dims = torch.tensor([ch, cw, ch, cw], dtype=torch.int32,
                        device=device).repeat(n, 1)
    boxes = sample_boxes_canvas(gen, cfg.data, n, ch, cw, (h, w), dims,
                                device=device)
    flip = torch.rand((n,), generator=gen, device=device) < 0.5
    ph = sample_photometric(gen, cfg.data, n, device=device)
    rows = augment_rows(boxes, flip, (dims[:, 2], dims[:, 3]), ph, n,
                        (ch, cw), device=device)
    return canvas, dims, rows


def ms_per_call(fn: Callable, device, steps: int, warmup: int) -> float:
    for _ in range(warmup):
        out = fn()
    float(out)
    if device.type != "cuda":
        tic = time.perf_counter()
        for _ in range(steps):
            out = fn()
        float(out)
        return (time.perf_counter() - tic) * 1e3 / steps
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / steps


def boundary_kernels(aug: Callable, rest: Callable) -> dict:
    """The kernels of one traced call that run after the augmenter's and
    before the stem's convolution: those the stem's ops launch ahead of
    it, the stem's ops being the ones that begin inside a
    ``record_function`` range around ``rest``."""
    from torch.profiler import record_function

    from resnet_tpu_torch.utils.profiler import (kernel_sequence, load_trace,
                                                 maybe_trace, newest_trace)
    with tempfile.TemporaryDirectory(prefix="aug_fusion_") as logdir:
        with maybe_trace(logdir):
            x = aug()
            with record_function(STEM_RANGE):
                float(rest(x))
        trace = load_trace(newest_trace(logdir))
    mark = next(ev for ev in trace["traceEvents"]
                if ev.get("name") == STEM_RANGE and ev.get("ph") == "X")
    t0, t1 = float(mark["ts"]), float(mark["ts"]) + float(mark["dur"])
    seq = kernel_sequence(trace)
    inside = [i for i, k in enumerate(seq)
              if k["op_ts"] is not None and t0 <= k["op_ts"] <= t1]
    conv = next((i for i in inside if seq[i]["op"] in CONV_OPS), None)
    if not inside or conv is None:
        return {"stem_conv_found": False,
                "kernels": [{k: v for k, v in x.items() if k != "name"}
                            for x in seq]}
    last_aug = inside[0] - 1
    between = [seq[i] for i in inside if i < conv]
    conv_kernels = [seq[i] for i in inside if seq[i]["op"] in CONV_OPS]
    return {"stem_conv_found": True,
            "augmenter_last_kernel": seq[last_aug]["group"],
            "augmenter_last_us": seq[last_aug]["us"],
            "stem_conv_kernels": [{"kernel": k["group"], "us": k["us"]}
                                  for k in conv_kernels],
            "n_kernels_between": len(between),
            "us_between": sum(k["us"] for k in between),
            "kernels_between": [{"kernel": k["group"], "us": k["us"],
                                 "op": k["op"]} for k in between]}


def boundary_ops(aug: Callable, rest: Callable) -> dict:
    """The ops one counted call dispatches after the augmenter returns and
    before the stem's convolution, with their bytes."""
    with OpCounter() as counter:
        x = aug()
        start = len(counter.events)
        rest(x)
    ops = counter.events[start:]
    conv = next(i for i, e in enumerate(ops)
                if e.op in ("aten.convolution", "aten._convolution"))
    between = [e for e in ops[:conv] if e.bytes or e.flops]
    return {"n_ops_between": len(between),
            "bytes_between": sum(e.bytes for e in between),
            "ops_between": [{"op": e.op, "bytes": e.bytes}
                            for e in between]}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def probe(args) -> dict:
    """The three programs timed and inspected; the port's default backend
    switches on (``utils/xla_opts.py``: cuDNN picks its algorithms by
    timing them, as in training) and put back after."""
    from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                                 compiler_options)
    device = resolve_device(args.device)
    restore = apply_backend_options(compiler_options(backend=device.type))
    try:
        return _probe(args, device)
    finally:
        restore()


def _probe(args, device) -> dict:
    from resnet_tpu_torch.models.resnet import StemConvS2D
    cfg = imagenet_resnet50()
    canvas, dims, rows = inputs(cfg, args.batch_size, device)
    stem = StemConvS2D(3, 64, dtype=torch.bfloat16)
    stem.reset_parameters(torch.Generator().manual_seed(cfg.train.seed))
    stem = stem.to(device)
    progs = programs(cfg, canvas, dims, rows, stem)
    report = {"batch_size": args.batch_size,
              "canvas": list(canvas.shape[1:3]), "device": str(device),
              "cudnn_benchmark": torch.backends.cudnn.benchmark}
    with torch.no_grad():
        for name, (aug, rest) in progs.items():
            rec = {"ms_per_call": ms_per_call(lambda: rest(aug()), device,
                                              args.steps, args.warmup)}
            if name[0] in "AC":
                rec.update(boundary_ops(aug, rest))
                if device.type == "cuda":
                    rec.update(boundary_kernels(aug, rest))
            report[name] = rec
    report["epilogue_ms_estimate(A-B)"] = (
        report["A_fused_aug_plus_s2d_stem"]["ms_per_call"]
        - report["B_split_crop_only"]["ms_per_call"])
    if device.type == "cuda":
        report["device_name"] = torch.cuda.get_device_name(device)
    return report


def main(argv=None) -> int:
    print(json.dumps(probe(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
