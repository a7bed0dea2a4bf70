#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``resnet_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card at the shapes its path gives
it and times it there, and drives the ``imagenet_resnet50`` training step
at full width (ResNet-50, batch 128, bf16, six steps per call) through the
port's entry points on four execution paths: the preset's bn-ema path, the
chain units (``unit_chain="pallas"``), the fused conv+BN units
(``fused_convbn``) and, beside them, the full-batch-BN path both replace.
It checks one float32 step of each path, and of the subsampled and grouped
BatchNorm modes, against the port's CPU path on a small input, and runs
one eval step. Then the two probes: ``reduce_probe`` (the BatchNorm
backward's sum pair, K5, at ResNet-50's bs256 shapes) and ``trace_probe``
(device time by kernel of the bs256 ``bn_subsample=8`` train step), and
the fused 1x1-conv kernels' timings at every ResNet-50 shape, with each
kernel apart from the wrapper's partial sums from a profiled window a
shape. Last, in a child process, the training entry point: ``fit_path``
runs ``python -m resnet_tpu_torch.train_resnet``'s ``main`` at the preset
(2 epochs of in-memory data with validation and checkpoints, the bn-ema
switch inside; its img/s beside ``main_path``'s is the fit loop's input
overhead, and CUDA events around its train calls give the device's idle
share), and ``fit_params`` round-trips its checkpoint through an MXNet
``.params`` file. The phases that time nothing run side by side, before
the child processes: ``fit_resume`` SIGTERMs a real CLI process
mid-epoch and resumes it (all four processes on deterministic
algorithms, through ``--deterministic-train``, so that the resumed run
can be held bit for bit), and ``dp_reference`` and ``dryrun`` start
their rank processes, each from a thread, while this thread runs the
float32 reference steps and ``prefetch_check``, which holds the
side-stream prefetch against the host batches. ``serve``, after
``fit_path`` in its process, takes its epoch-2 checkpoint (ResNet-50 at full width) through the
deployment path: the ``-symbol.json`` the fit wrote, ``export_mxnet``,
``predict`` on PNG and ``.rec`` requests, ``validate``, ``serve_export
--check`` (symbolic, pinned, and a two-device artifact this card must
refuse) and ``bench_serving`` at batch 256. Each phase prints JSON
lines, each with ``seconds`` (since the phase began, unless the line
times a step of its own), and a ``timing`` line gives every phase's
seconds; a failed check raises and the script exits non-zero. The last
lines are the kernels line, the card's ``nvidia-smi`` name and power
limit, and ``{"ok": true, "device": {...}}``. Imports nothing of JAX or
of the JAX package.

The augmentation kernel (K1) has two phases: ``k1`` holds it against
its plain version (``k1_check``, ``k1_s2d_regroup``) and times the main
path's launch and the trace probe's (``k1_timing``, with the bytes and
operations bounds at this card's lane-instruction rate, printed on the
``card`` line); ``k1_split`` times the main path's launch with one switch
changed at a time (no canvas rows staged, HSL off, standard layout,
float32 output) and the trace probe's launch with and without staging.

The rest of the model family and the augmentation variants: one float32
step each of ResNeXt-50 (``resnext_reference``), v2 ResNet-50
(``v2_reference``), CIFAR ResNet-18 (``cifar_reference``), the mask
max-pool backward (``mask_pool_reference``) and remat
(``remat_reference``, also against the card's step without remat) against
the CPU path; the device rotate/shear warp against the CPU's, with K1
launching no time on its path (``rotate_check``); the train calls of
ResNeXt-50 32x4d at its preset, block-diagonal (``resnext_path``) and
through cuDNN's grouped convolution (``resnext_grouped_path``), of the
CIFAR ResNet-18 preset (``cifar_path``) and of ``imagenet_resnet152_dp``'s
per-device share at depth 50 (``DP_DEPTH``) with and without remat
(``remat_path``); and K1's split mode (``k1_split_mode``: the kernel at
identity normalization against its plain version, the split augmenter
against the fused one, and the preset's path with
``augment_impl="pallas-split"``).

Data parallelism, each in processes of its own: ``dp_reference`` runs
two ranks on the one card, joined by gloo (NCCL refuses two ranks on one
device), and holds a float32 CIFAR ResNet-20's ``jit`` step against one
step on the global batch, its ``shard_map`` step against the two halves
averaged, a K=1 ``dispatch`` step against step-sync and bf16
communication against float32; ``dp_path`` drives
``imagenet_resnet152_dp`` at its per-replica width (depth 50, batch
128, bf16, bn-ema, remat, s2d stem fed by K1, 4 steps a call) through
``python -m resnet_tpu_torch.tools.launch -n 1`` over NCCL in both
``dp_mode``s, with the collectives a step from a profiled call, holds
each against the plain step from the same state on deterministic
algorithms, and runs the chain and fused paths under ``shard_map`` (K4f,
K4b, K2);
``dryrun`` runs ``dryrun_multichip(1)`` over NCCL.

The audit tools and the compile-check entry: ``quant_probe`` (int8
against bf16 on ResNet-50's serving shapes, exact on sampled blocks) and
``aug_fusion_probe`` (K1 fused and split and the plain version, with the
s2d stem, and what runs between the augmenter and the stem conv) are
timed in a child process of their own, with nothing beside it;
``entry`` (``dryrun.entry()``'s ResNet-50 bf16 forward against the
CPU's), ``cost_probe`` (FLOPs and bytes of a bs256 ResNet-50 step per
``unit_chain`` variant, against the analytic count) and ``pod_probe``
(``imagenet_resnet152_dp`` as rank 0 of a 16-rank fake group, both DP
modes: all-reduces, bytes, peak GiB) count in the untimed block;
``ema_equivalence`` (the JAX CI rung: one seed, 10 epochs, both BN
programs) runs in a child process beside it; and ``serving_pod_probe``
reads the two-device artifact ``serve`` exported.

``--only PHASE[,PHASE...]`` runs a subset after the build (for work on one
kernel); with no arguments every phase runs. The phases: k1, k1_split,
mm_check, k3_path, k5_check, reduce_probe, reference, chain_reference,
fused_reference, subsample_reference, grouped_reference,
resnext_reference, v2_reference, cifar_reference, mask_pool_reference,
remat_reference, rotate_check, main, chain, fused, fullbatch, resnext,
resnext_grouped, cifar, remat, k1_split_mode (after main, for its img/s),
trace_probe, bench_input, quant_probe, aug_fusion_probe, dp_reference,
dp_path (after remat, for its img/s), dryrun, convergence,
device_parity, ema_probe, ema_equivalence, entry, cost_probe, pod_probe,
mm_timing, fit, serve (with fit), serving_pod_probe (with serve),
fit_resume, prefetch.
"""

import argparse
import contextlib
import copy
import dataclasses
import importlib.util
import io
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

CANVAS, OUT, BATCH = 256, 224, 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
BF16_OPS_PER_S = 989e12            # H100 SXM, dense bf16 on the tensor cores
# float32 operations the augmentation kernel needs (each add, subtract,
# multiply, divide, min, max, abs, floor, compare and floor-mod one),
# counted from the expressions csrc/augment.cu evaluates: per output pixel
# the horizontal interpolation of three channels (9) and the normalize (6,
# and 3 each for contrast and illumination); per output row and canvas
# column the band taps, the vertical interpolation (9); per pixel with HSL
# on, the round-trip through the one hue branch it takes (59: 3 divisions
# by 255, 4 min/max, delta 1, l 2, the guard 1, s 6, the hue branch 6,
# h*30 + dh, mod 180 and /30 4, l and s jitter and clip 3 + 3, c 5, x 5,
# m 2, the sector 2, the three outputs 12); per output row its vertical
# taps (16) and per output column its horizontal ones, mirror included
# (18), once an image. The reference's per-pixel form (151, as first counted)
# repeats the vertical interpolation and the taps at every pixel and
# evaluates all three hue branches. Bound by the lane-instruction rate:
# the kernel is built without contracted multiply-adds, so an operation is
# one instruction.
AUG_PIXEL_OPS = 9 + 6
AUG_VERTICAL_OPS = 9
AUG_HSL_OPS = 59
AUG_ROW_OPS = 16
AUG_COL_OPS = 18
# tolerances of the kernel against its plain version (HSL on): the CPU
# tests' bar, atol 5e-2 / rtol 1e-4 in float32; in bf16 one bf16 ulp more
# (2^-7 relative), since the two may round on either side of a boundary
TOL = {torch.float32: (5e-2, 1e-4), torch.bfloat16: (5e-2, 2.0 ** -7)}


class PhaseClock:
    """Wall seconds of this process's phases: ``begin`` ends the current
    phase and starts the next; ``seconds`` is the time since the current
    one began; ``totals`` holds each ended phase's seconds."""

    def __init__(self):
        self.name, self.start, self.totals = "start", time.perf_counter(), {}

    def begin(self, name):
        now = time.perf_counter()
        self.totals[self.name] = self.totals.get(self.name, 0.0) \
            + now - self.start
        self.name, self.start = name, now

    def seconds(self):
        return time.perf_counter() - self.start


CLOCK = PhaseClock()


# the untimed phases print from several threads: one writer at a time
# (a text stream is not safe to write from two threads at once)
STDOUT_LOCK = threading.Lock()


def write_out(text):
    """``text`` to standard output, flushed, under ``STDOUT_LOCK``."""
    with STDOUT_LOCK:
        sys.stdout.write(text)
        sys.stdout.flush()


def emit(**fields):
    """One JSON line, in one write (``fit_resume`` emits from a thread);
    ``seconds``, unless given, is the time since the current phase began
    (so a phase's last line carries its whole time)."""
    fields.setdefault("seconds", CLOCK.seconds())
    write_out(json.dumps(fields) + "\n")


def nvidia_smi_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def require(cond, what):
    if not cond:
        raise AssertionError(what)


@contextlib.contextmanager
def full_float32():
    """TF32 off for float32 convolutions and matrix products (every float32
    comparison on the card needs that); the flags are restored afterwards,
    so the train paths run at PyTorch's defaults."""
    from resnet_tpu_torch.utils.device import set_tf32
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    set_tf32(False)
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def aug_inputs(cfg_data, gen, n, contrast_illum, canvas_side=CANVAS,
               out=OUT, letterbox=True, wide_dh=False):
    """Canvases (with ``letterbox``, a third letterboxed, zero beyond their
    extent) and the (n, 12) rows the port's samplers draw for them. With
    ``wide_dh`` every image's hue shift lies in 180 <= |dh| < 540."""
    from resnet_tpu_torch.ops.augment import sample_boxes_canvas
    from resnet_tpu_torch.ops.augment_fused import (augment_rows,
                                                    sample_photometric)
    dev = gen.device
    dims = torch.full((n, 4), canvas_side, dtype=torch.int32, device=dev)
    lb = torch.arange(n, device=dev) % 3 == 0
    orig = torch.randint(160, 640, (n, 2), generator=gen, device=dev)
    scale = canvas_side / orig.max(dim=1).values.float()
    eff = torch.round(orig.float() * scale[:, None]).clamp_max(canvas_side)
    if letterbox:
        dims[lb, :2] = orig[lb].int()
        dims[lb, 2:] = eff[lb].int()
    canvas = torch.randint(0, 256, (n, canvas_side, canvas_side, 3),
                           generator=gen, device=dev, dtype=torch.uint8)
    idx = torch.arange(canvas_side, device=dev)
    inside = ((idx[None, :, None] < dims[:, 2, None, None])
              & (idx[None, None, :] < dims[:, 3, None, None]))
    canvas *= inside[..., None].to(torch.uint8)
    data = dataclasses.replace(
        cfg_data, max_random_contrast=0.3 if contrast_illum else 0.0,
        max_random_illumination=20.0 if contrast_illum else 0.0)
    boxes = sample_boxes_canvas(gen, data, n, canvas_side, canvas_side,
                                (out, out), dims, device=dev)
    flip = torch.rand((n,), generator=gen, device=dev) < 0.5
    ph = sample_photometric(gen, data, n, device=dev)
    if wide_dh:
        u = torch.rand((n,), generator=gen, device=dev)
        sign = torch.where(torch.arange(n, device=dev) % 2 == 0, 1.0, -1.0)
        ph["dh"] = sign * (180.0 + 360.0 * u)
    rows = augment_rows(boxes, flip, (dims[:, 2], dims[:, 3]), ph, n,
                        (canvas_side, canvas_side), device=dev)
    return canvas, rows, data


def touched_taps(rows, sh, sw, oh, ow):
    """Per image, the canvas rows and the canvas columns that carry a
    non-zero tap weight (the kernel's own coordinate arithmetic): (N,) each.
    Their product times three is the canvas bytes the kernel must read."""
    def taps(start, size, valid, out_size, src_size):
        i = torch.arange(out_size, dtype=torch.float32, device=rows.device)
        src = (start[:, None] + (i + 0.5) * (size / out_size)[:, None]
               - 0.5).clamp_min(0.0)
        src = torch.minimum(src, valid[:, None] - 1.0)
        lo = torch.floor(src)
        hi_w = (1.0 - (src - (lo + 1.0)).abs()).clamp_min(0.0)
        used = torch.zeros((start.shape[0], src_size + 1), dtype=torch.bool,
                           device=rows.device)
        used.scatter_(1, lo.long(), True)
        used.scatter_(1, torch.where(hi_w > 0, lo + 1, lo).long(), True)
        return used[:, :src_size].sum(dim=1)
    return (taps(rows[:, 0], rows[:, 2], rows[:, 5], oh, sh),
            taps(rows[:, 1], rows[:, 3], rows[:, 6], ow, sw))


def lane_ops_per_s():
    """(SMs, maximum SM clock in MHz, lane-instructions per second) of card
    0: SMs x 128 float32 lanes x the clock. The augmentation kernel is
    built without contracted multiply-adds, so each of its operations is
    one lane-instruction at this rate (the data sheet's 67 TFLOP/s counts
    a multiply-add as two operations)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms, mhz, sms * 128 * mhz * 1e6


def aug_bounds(canvas, rows, out_hw, dtype, hsl, contrast, illum):
    """Bytes and float32 operations the augmentation kernel needs for
    these inputs, and the least time each takes on this card."""
    n, sh, sw, _ = canvas.shape
    oh, ow = out_hw
    used_rows, used_cols = touched_taps(rows, sh, sw, oh, ow)
    read = int((used_rows * used_cols).sum()) * 3
    moved = read + rows.numel() * 4 + n * oh * ow * 3 * dtype.itemsize
    per_pixel = (AUG_PIXEL_OPS + (AUG_HSL_OPS if hsl else 0)
                 + 3 * int(contrast) + 3 * int(illum))
    ops = (n * (oh * ow * per_pixel + oh * AUG_ROW_OPS + ow * AUG_COL_OPS)
           + oh * AUG_VERTICAL_OPS * int(used_cols.sum()))
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / lane_ops_per_s()[2] * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    return dict(bytes=moved, canvas_bytes_read=read,
                full_canvas_bytes=canvas.numel(), operations=ops,
                operations_per_pixel=ops / (n * oh * ow),
                bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


# K1's checked cases: name -> (aug_inputs arguments, kernel flags)
K1_CHECKS = {
    "hsl": (dict(contrast_illum=False), dict(hsl=True)),
    "hsl_contrast_illum": (dict(contrast_illum=True),
                           dict(hsl=True, contrast=True, illum=True)),
    "contrast_illum": (dict(contrast_illum=True),
                       dict(contrast=True, illum=True)),
    "wide_dh": (dict(contrast_illum=False, wide_dh=True), dict(hsl=True)),
    "canvas512": (dict(contrast_illum=False, canvas_side=512),
                  dict(hsl=True)),
}
# K1's timed launches: the main path's (bs128, 256 canvas -> 224, bf16
# s2d, HSL on), the trace probe's (bs256, a full 224 canvas -> 224, bf16,
# standard layout, HSL on), and each with one switch changed; staging off
# and on alternate
K1_MAIN = dict(n=BATCH, canvas_side=CANVAS, letterbox=True, s2d=True,
               dtype=torch.bfloat16, hsl=True)
K1_TRACE = dict(n=256, canvas_side=OUT, letterbox=False, s2d=False,
                dtype=torch.bfloat16, hsl=True)
K1_SPLIT = {"main": K1_MAIN, "no_staging": dict(K1_MAIN, staging=False),
            "hsl_off": dict(K1_MAIN, hsl=False),
            "standard": dict(K1_MAIN, s2d=False),
            "float32": dict(K1_MAIN, dtype=torch.float32),
            "trace_probe_no_staging": dict(K1_TRACE, staging=False),
            "trace_probe": K1_TRACE}


def check_augment_kernel(cfg):
    """K1 against its plain version at the training shapes, in both layouts
    and both dtypes, for each case of ``K1_CHECKS``; s2d must be a bitwise
    regroup of the standard output. Returns the largest |diff| against the
    plain version."""
    from resnet_tpu_torch.ops.augment import space_to_depth
    from resnet_tpu_torch.ops.augment_fused import (
        fused_crop_mirror_normalize as k1,
        fused_crop_mirror_normalize_reference as k1_plain)
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for case, (inputs, flags) in K1_CHECKS.items():
        canvas, rows, data = aug_inputs(cfg.data, gen, BATCH, **inputs)
        for dtype in (torch.float32, torch.bfloat16):
            outs = {}
            for s2d in (False, True):
                args = (canvas, rows, (OUT, OUT), data.mean_rgb,
                        data.std_rgb, dtype)
                got = k1(*args, s2d=s2d, **flags)
                want = k1_plain(*args, s2d=s2d, **flags)
                torch.cuda.synchronize()
                require(got.shape == want.shape and got.dtype == dtype,
                        f"kernel output {got.dtype} {tuple(got.shape)}")
                require(bool(torch.isfinite(got).all()), "non-finite output")
                diff = (got.float() - want.float()).abs()
                atol, rtol = TOL[dtype]
                bad = int((diff > atol + rtol * want.float().abs()).sum())
                err = float(diff.max())
                emit(phase="k1_check", case=case, dtype=str(dtype), s2d=s2d,
                     canvas=canvas.shape[1], max_abs_diff=err, atol=atol,
                     rtol=rtol, out_of_tolerance=bad)
                require(bad == 0, "augmentation kernel disagrees with its "
                        "plain version")
                worst = max(worst, err)
                outs[s2d] = got
                del want, diff
            require(torch.equal(outs[True], space_to_depth(outs[False])),
                    "s2d output is not a bitwise regroup of the standard")
            emit(phase="k1_s2d_regroup", case=case, dtype=str(dtype),
                 bitwise=True)
    return worst


@contextlib.contextmanager
def staging_off():
    """K1's launch plan with no canvas rows staged: every band reads its
    taps from the canvas directly, as a band that overruns the staging
    budget does. What staging is worth, beside the plan's own launch."""
    from resnet_tpu_torch.ops import augment_fused as af
    plan = af.aug_plan

    def unstaged(sh, sw, oh, ow, s2d):
        p = plan(sh, sw, oh, ow, s2d)
        return p._replace(staged_rows=0, staged_cols=0, smem_bytes=(
            af.aug_smem_bytes(ow, p.band_rows, 0, 0)))
    af.aug_plan = unstaged
    try:
        yield
    finally:
        af.aug_plan = plan


def time_augment_launch(cfg, gen, flush, n, canvas_side, letterbox, s2d,
                        dtype, hsl, plain=False, staging=True):
    """CUDA-event median (25 runs, L2 flushed, 1 ms spin) of one K1 launch
    at these settings (``staging=False``: under ``staging_off``), with its
    bounds on this card."""
    from resnet_tpu_torch.ops.augment_fused import (
        fused_crop_mirror_normalize as k1,
        fused_crop_mirror_normalize_reference as k1_plain)
    from resnet_tpu_torch.utils.profiler import cuda_median_ms
    canvas, rows, data = aug_inputs(cfg.data, gen, n, False,
                                    canvas_side=canvas_side,
                                    letterbox=letterbox)
    args = (canvas, rows, (OUT, OUT), data.mean_rgb, data.std_rgb, dtype)
    with contextlib.nullcontext() if staging else staging_off():
        ms = cuda_median_ms(lambda: k1(*args, s2d=s2d, hsl=hsl), flush=flush)
    out = dict(ms=ms, **aug_bounds(canvas, rows, (OUT, OUT), dtype, hsl,
                                   False, False))
    out["share_of_bound"] = out["bound_ms"] / ms
    if plain:
        out["plain_ms"] = cuda_median_ms(
            lambda: k1_plain(*args, s2d=s2d, hsl=hsl), flush=flush)
    return out


def augment_split(cfg):
    """K1 at the main path's launch with one switch changed at a time, and
    at the trace probe's launch with and without staging: what staging,
    the HSL round-trip, the layout and the output dtype cost beside the
    bounds."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    for case, setting in K1_SPLIT.items():
        # the same inputs for every case of one shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        t = time_augment_launch(cfg, gen, flush, **setting)
        emit(phase="k1_split", case=case, runs=25,
             **{k: (str(v) if k == "dtype" else v)
                for k, v in setting.items()}, **t)
        torch.cuda.empty_cache()


def augment_timing(cfg):
    """K1 at the main path's launch (with its plain version) and at the
    trace probe's; the main path's is the kernels line's."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    main = time_augment_launch(cfg, gen, flush, plain=True, **K1_MAIN)
    trace = time_augment_launch(cfg, gen, flush, **K1_TRACE)
    sms, mhz, rate = lane_ops_per_s()
    emit(phase="k1_timing", runs=25, sms=sms, sm_clock_max_mhz=mhz,
         lane_ops_per_s=rate, main_path=main, trace_probe=trace,
         card=nvidia_smi_line())
    torch.cuda.empty_cache()
    return main


def reference_check(phase, n=8, preset="imagenet_resnet50",
                    model_overrides=None, data_overrides=None,
                    **train_overrides):
    """One float32 train step of a full-width net on a small input (``n``
    images), on the card (through the kernels) and on the CPU (through
    their plain versions) from the same weights and rows: the CPU path is
    the one the tests hold against the JAX package. The net is ``preset``
    (ResNet-50 unless named) with ``model_overrides``, ``data_overrides``
    and ``train_overrides`` set on ``cfg.model``, ``cfg.data`` and
    ``cfg.train`` (the execution-path and BatchNorm switches). Returns the
    card's train state."""
    from resnet_tpu_torch.config import PRESETS
    from resnet_tpu_torch.ops.augment import sample_cifar_rows
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    cfg = PRESETS[preset]()
    cfg.train.dtype = "float32"
    cfg.data.image_shape = (96, 96, 3)
    for section, overrides in ((cfg.model, model_overrides),
                               (cfg.data, data_overrides),
                               (cfg.train, train_overrides)):
        for name, value in (overrides or {}).items():
            setattr(section, name, value)
    gen = torch.Generator(device="cuda").manual_seed(1)
    if cfg.model.dataset == "cifar10":
        side = cfg.data.image_shape[0]
        canvas = torch.randint(0, 256, (n, side, side, 3), generator=gen,
                               device="cuda", dtype=torch.uint8)
        rows = sample_cifar_rows(gen, cfg.data, n, device="cuda")
    else:
        canvas, rows, _ = aug_inputs(cfg.data, gen, n, False,
                                     canvas_side=112, out=96)
    batch = {"image": canvas,
             "label": torch.randint(0, cfg.data.num_classes, (n,),
                                    generator=gen, device="cuda"),
             "rows": rows}
    results = {}
    with full_float32():
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, device=dev)
            step = make_train_step(augment_fn=make_augment_fn(cfg))
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            results[dev] = (float(m["loss_sum"]), state)
    (loss_cpu, st_cpu), (loss_gpu, st_gpu) = results["cpu"], results["cuda"]
    mom_err = list_gap(st_gpu.momentum, st_cpu.momentum)
    head = [i for i, p in enumerate(st_cpu.model.parameters())
            if p is st_cpu.model.fc.weight]
    head_err = list_gap([st_gpu.momentum[i] for i in head],
                   [st_cpu.momentum[i] for i in head])
    stats_err = list_gap(st_gpu.model.buffers(), st_cpu.model.buffers())
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    emit(phase=phase, model=f"{preset} f32" if preset != "imagenet_resnet50"
         else "resnet50 f32", batch=n,
         image=list(cfg.data.image_shape), switches=train_overrides,
         model_switches=model_overrides or {},
         data_switches=data_overrides or {},
         loss_cuda=loss_gpu, loss_cpu=loss_cpu, loss_rel_err=loss_err,
         momentum_rel_err=mom_err, fc_momentum_rel_err=head_err,
         running_stats_rel_err=stats_err)
    require(loss_err < 1e-4, "loss differs from the CPU path")
    # the momentum is the update, -lr * (gradient + wd * w). ResNet-50's
    # backward at init amplifies rounding from the head down: two float32
    # paths that sum in other orders agree on the whole update to a few
    # percent here, on the fc head's and on the refreshed running statistics
    # (forward only) to far better; a wrong path on none of them
    require(head_err < 1e-3, "the fc update differs from the CPU path")
    require(stats_err < 1e-3, "the running statistics differ from the CPU "
            "path")
    require(mom_err < 1e-1, "the update differs from the CPU path")
    return st_gpu


# ---------------------------------------------------------------------------
# the fused 1x1-conv kernels: K2, K3, K4f (forward), K4b (backward)
# ---------------------------------------------------------------------------

# tolerances of a kernel against its plain version. y and dx, elementwise:
# |diff| <= atol + rtol*|want| with atol = 1e-5 * max|want| (float32
# accumulators summed in another order, which is all that differs in
# float32, hence rtol 1e-4 there) and, in bf16, rtol = 2^-7: one bf16 ulp,
# where the two round on either side of a boundary. The column sums, dW,
# dgamma and dbeta are float32 sums of up to 401408 terms: |diff| <=
# 1e-5 * sum|terms|, a bound relative to the terms and not to a result
# that may cancel.
MM_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
MM_ATOL_OF_MAX = 1e-5
MM_SUM_TOL = 1e-5


def r50_op_shapes(model, batch, side):
    """The (M, K, N) of every 1x1 conv of one train step, in the model's
    order, from its structure: ``(op A shapes, op B shapes)``; conv1 and
    the projection ``sc`` are op A, conv3 is op B. Also the input shape
    every unit must see, for the check against the running model."""
    hw = side // 4                      # the stem conv and the pool halve it
    ops_a, ops_b, unit_inputs = [], [], []
    for unit in model.units():
        mid, cin = unit.conv1.weight.shape[:2]
        filters = unit.conv3.weight.shape[0]
        unit_inputs.append((batch, cin, hw, hw))
        ops_a.append((batch * hw * hw, cin, mid))
        hw = (hw - 1) // unit.conv2.stride + 1
        if not unit.dim_match:
            ops_a.append((batch * hw * hw, cin, filters))
        ops_b.append((batch * hw * hw, mid, filters))
    return ops_a, ops_b, unit_inputs


def op_inputs(gen, m, k, n, dtype):
    """x (M, K), w (K, N) as the model passes it (the transposed view of an
    MSRA-scaled (N, K) weight), BN vectors of x's channels, and the
    backward's cotangents."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale
    x = randn(m, k).to(dtype)
    w = randn(n, k, scale=(2.0 / k) ** 0.5).to(dtype).t()
    bn = dict(mean=randn(k, scale=0.2), var=randn(k).abs() + 0.5,
              gamma=1.0 + randn(k, scale=0.1), beta=randn(k, scale=0.1))
    cots = dict(gy=randn(m, n).to(dtype), gs=randn(n, scale=0.1),
                gss=randn(n, scale=0.01))
    return x, w, bn, cots


def compare(got, want, bound):
    """(entries out of tolerance, max |diff|, max |diff|/bound)."""
    diff = (got.float() - want.float()).abs()
    return (int((diff > bound).sum()), float(diff.max()),
            float((diff / bound).max()))


def elementwise_bound(want, dtype):
    w = want.float().abs()
    return MM_ATOL_OF_MAX * w.max() + MM_RTOL[dtype] * w


def report(phase, results, **fields):
    """Emit one check line; raise if any output has an entry out of
    tolerance. ``results``: name -> compare(...) tuple."""
    bad = {k: v[0] for k, v in results.items()}
    emit(phase=phase, **fields, out_of_tolerance=bad,
         max_abs_diff={k: v[1] for k, v in results.items()},
         max_diff_over_bound={k: v[2] for k, v in results.items()})
    require(not any(bad.values()),
            f"{phase}: kernel disagrees with its plain version: {bad}")


def check_forward_kernels(ops_a, ops_b):
    """K2, K3 and K4f against their plain versions at every distinct shape
    of ResNet-50's 1x1 convs, in bf16 and in float32 (TF32 off): K2 at
    all of them (the fused path runs conv3 through it too), K4f at the op A
    shapes without and the op B shapes with the prologue, K3 at the op B
    shapes. Returns name -> worst |diff| of y."""
    from resnet_tpu_torch.ops import fused_chain as fc
    from resnet_tpu_torch.ops import fused_convbn as cb
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops import matmul_stats_cuda as mk
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {"k2": 0.0, "k3": 0.0, "k4f": 0.0}

    def check(phase, key, got, want, dtype, **fields):
        torch.cuda.synchronize()
        y, s, ss = want
        require(got[0].dtype == dtype and got[0].shape == y.shape
                and bool(torch.isfinite(got[0].float()).all()),
                f"{phase}: output {got[0].dtype} {tuple(got[0].shape)}")
        yf = y.float()
        results = {
            "y": compare(got[0], y, elementwise_bound(y, dtype)),
            "sum": compare(got[1], s, MM_SUM_TOL * yf.abs().sum(0)),
            "sumsq": compare(got[2], ss, MM_SUM_TOL * (yf * yf).sum(0))}
        report(phase, results, dtype=str(dtype), **fields)
        worst[key] = max(worst[key], results["y"][1])

    for dtype in (torch.bfloat16, torch.float32):
        for shape in sorted(set(ops_a) | set(ops_b), reverse=True):
            x, w, _, _ = op_inputs(gen, *shape, dtype)
            want = mk.forward_plain(x, w)
            check("k2_check", "k2", cb.matmul_with_stats(x, w), want, dtype,
                  shape=shape)
            if shape not in ops_a:
                continue
            with torch.no_grad():
                got = fu.matmul_stats(x, w, "pallas")
            check("k4f_check", "k4f", got, want, dtype, shape=shape,
                  normalize=False, relu=False)
        for shape in sorted(set(ops_b), reverse=True):
            x, w, bn, _ = op_inputs(gen, *shape, dtype)
            for relu in (True, False):
                want = fc.normalized_matmul_with_stats_plain(
                    x, w, **bn, relu=relu)
                got = fc.normalized_matmul_with_stats(x, w, **bn, relu=relu)
                check("k3_check", "k3", got, want, dtype, shape=shape,
                      relu=relu)
                with torch.no_grad():
                    got = fu.norm_relu_matmul_stats(x, w, *bn.values(), 2e-5,
                                                    relu, "pallas")
                check("k4f_check", "k4f", got, want, dtype, shape=shape,
                      normalize=True, relu=relu)
    return worst


def backward_consts(bn, eps=2e-5):
    inv = torch.rsqrt(bn["var"] + eps)
    a = bn["gamma"] * inv
    return a, bn["beta"] - bn["mean"] * a, inv, -bn["mean"] * inv


def check_backward_kernel(ops_a, ops_b):
    """K4b against its plain version at every distinct shape of
    ResNet-50's 1x1 convs: op A, op B with and without ReLU. Returns the
    worst |diff| of dx."""
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops import matmul_stats_cuda as mk
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = 0.0
    cases = [(s, False, False) for s in sorted(set(ops_a), reverse=True)] \
        + [(s, True, relu) for s in sorted(set(ops_b), reverse=True)
           for relu in (True, False)]
    for dtype in (torch.bfloat16, torch.float32):
        for shape, normalize, relu in cases:
            x, w, bn, cots = op_inputs(gen, *shape, dtype)
            consts = backward_consts(bn) if normalize else None
            a, b = consts[:2] if normalize else (None, None)
            y = mk.forward_plain(x, w, a, b, relu)[0]
            args = (cots["gy"], cots["gs"], cots["gss"], y, x, w, consts,
                    relu)
            got = fu.fused_backward(*args)
            want = fu.fused_backward_plain(*args)
            torch.cuda.synchronize()
            require(got[0].dtype == dtype and got[1].dtype == torch.float32
                    and got[1].shape == want[1].shape,
                    f"k4b outputs {got[0].dtype} {tuple(got[1].shape)}")
            g = mk.folded_cotangent(cots["gy"], cots["gs"], cots["gss"], y)
            act = mk.activation(x, a, b, relu)
            dw_terms = act.float().abs().t() @ g.float().abs()
            results = {
                "dx": compare(got[0], want[0],
                              elementwise_bound(want[0], dtype)),
                "dw": compare(got[1], want[1], MM_SUM_TOL * dw_terms)}
            if normalize:
                # |gxh| recovered from dx = gxh * a
                gxh = want[0].float().abs() / a.abs()
                xhat = (x.float() * consts[2] + consts[3]).abs()
                results["dgamma"] = compare(
                    got[2], want[2], MM_SUM_TOL * (gxh * xhat).sum(0))
                results["dbeta"] = compare(got[3], want[3],
                                           MM_SUM_TOL * gxh.sum(0))
            else:
                require(got[2] is None and got[3] is None,
                        "op A returns no dgamma/dbeta")
            report("k4b_check", results, dtype=str(dtype), shape=shape,
                   normalize=normalize, relu=relu,
                   dw_splits=mk.dw_plan(*shape)[1])
            worst = max(worst, results["dx"][1])
    return worst


def mm_bound(m, k, n, backward):
    """(bound ms, what bounds it) of one op in bf16: the bytes it must move
    over the memory rate against its products' operations over the tensor
    cores' rate. Forward: read x and W, write y and the two (N,) sums.
    Backward: read gy, y, x, W; write dx and the float32 dW; two products."""
    if backward:
        moved = (2 * m * n + 2 * m * k + k * n) * 2 + k * n * 4
        ops = 2 * 2 * m * k * n
    else:
        moved = (m * k + k * n + m * n) * 2 + 2 * n * 4
        ops = 2 * m * k * n
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / BF16_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), "bytes" if bytes_ms >= ops_ms else \
        "operations"


def kernel_ms_by_group(fn, flush, want, calls=5):
    """Device ms per call of each kernel ``fn`` launches, from one profiled
    window of ``calls`` calls (L2 flushed before each): the profiler
    module's reading of the chrome trace, keyed by ``kernel_group``, and
    the number of calls it saw. ``want`` are kernel groups launched once a
    call. Once a process has traced before, the tracer drops the first
    call of a window (every group alike), so the sums are divided by the
    calls the trace holds, not by ``calls``. At times it loses a window's
    kernels altogether (one window in about 50 on the card); such a
    window is taken again, up to three windows in all."""
    from resnet_tpu_torch.utils.profiler import (kernel_group, kernel_times,
                                                 load_trace, maybe_trace,
                                                 newest_trace)
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with trace_dir() as logdir:
            with maybe_trace(logdir):
                for _ in range(calls):
                    flush()
                    fn()
                torch.cuda.synchronize()
            us, count = kernel_times(load_trace(newest_trace(logdir)))
        total, seen = {}, {}
        for name, t in us.items():
            key = kernel_group(name)
            total[key] = total.get(key, 0.0) + t
            seen[key] = seen.get(key, 0) + count[name]
        traced = seen.get(want[0], 0)
        if traced >= 2 and all(seen.get(k) == traced for k in want):
            return {key: t / 1e3 / traced for key, t in total.items()}, traced
    raise AssertionError(f"3 traces of {calls} calls each: the last holds "
                         f"{seen} of {want}")


@contextlib.contextmanager
def timed_launch_functions():
    """Host microseconds of every call of a kernel library's C launch
    function while inside: the wrappers load their library through
    ``_build.load_library`` at each call, so a stand-in that times each
    exported function sees exactly the launch (tensor-map encoding and
    kernel launches, no Python around it). Yields the list of times."""
    from resnet_tpu_torch import _build
    real, times = _build.load_library, []

    class Timed:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            fn = getattr(self.lib, name)

            def timed(*args):
                tic = time.perf_counter()
                out = fn(*args)
                times.append((time.perf_counter() - tic) * 1e6)
                return out
            return timed

    _build.load_library = lambda name: Timed(real(name))
    try:
        yield times
    finally:
        _build.load_library = real


def launch_host_us(fn, calls=20):
    """Median host µs of the C launch function under ``fn``, one call of
    the wrapper each (the card synchronized before, not between)."""
    torch.cuda.synchronize()
    with timed_launch_functions() as times:
        for _ in range(calls):
            fn()
    torch.cuda.synchronize()
    return statistics.median(times)


def time_matmul_kernels(ops_a, ops_b):
    """Each distinct ResNet-50 shape, forward and backward, bf16: the
    kernel, its plain version, the bound, ``torch.mm`` on the bare
    product(s) as context (summed over the step beside the kernels' sums;
    cuBLAS computes less than the kernels do), the host µs of the C launch
    function; and from one profiled window each, the forward kernel apart
    from the wrapper's ``psum.sum`` and the backward's dx kernel, dW kernel
    and partial sums apart. Returns per-step sums by kernel."""
    from resnet_tpu_torch.ops import fused_chain as fc
    from resnet_tpu_torch.ops import fused_convbn as cb
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops import matmul_stats_cuda as mk
    from resnet_tpu_torch.utils.profiler import cuda_median_ms
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    dtype = torch.bfloat16
    count_a = {s: ops_a.count(s) for s in dict.fromkeys(ops_a)}
    count_b = {s: ops_b.count(s) for s in dict.fromkeys(ops_b)}
    zero = lambda: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                        ops_ms=0.0, torch_mm_ms=0.0)
    step = {"k2": zero(), "k3": zero(), "k4f": zero(), "k4b": zero()}
    parts = dict(fwd_kernel_ms=0.0, fwd_sums_ms=0.0, dx_kernel_ms=0.0,
                 dw_kernel_ms=0.0, bwd_sums_ms=0.0)

    def add(key, times, ms, plain_ms, bound, by, mm_ms):
        step[key]["ms"] += times * ms
        step[key]["plain_ms"] += times * plain_ms
        step[key]["bound_ms"] += times * bound
        step[key]["bytes_ms" if by == "bytes" else "ops_ms"] += times * bound
        step[key]["torch_mm_ms"] += times * mm_ms

    def med(fn):
        return cuda_median_ms(fn, flush=flush)

    with torch.no_grad():
        for shape, times, prologue in (
                [(s, c, False) for s, c in count_a.items()]
                + [(s, c, True) for s, c in count_b.items()]):
            x, w, bn, cots = op_inputs(gen, *shape, dtype)
            consts = backward_consts(bn) if prologue else None
            a, b = consts[:2] if prologue else (None, None)
            bound, by = mm_bound(*shape, backward=False)
            plain_ms = med(lambda: mk.forward_plain(x, w, a, b, prologue))
            mm_ms = med(lambda: torch.mm(x, w))
            if prologue:
                ms = med(lambda: fu.norm_relu_matmul_stats(
                    x, w, *bn.values(), 2e-5, True, "pallas"))
                k3_ms = med(lambda: fc.normalized_matmul_with_stats(
                    x, w, **bn))
                add("k3", times, k3_ms, plain_ms, bound, by, mm_ms)
                # K2 runs conv3 too, without the prologue
                k2_ms = med(lambda: cb.matmul_with_stats(x, w))
                k2_plain = med(lambda: mk.forward_plain(x, w))
            else:
                ms = med(lambda: fu.matmul_stats(x, w, "pallas"))
                k2_ms, k2_plain = med(lambda: cb.matmul_with_stats(x, w)), \
                    plain_ms
            add("k4f", times, ms, plain_ms, bound, by, mm_ms)
            add("k2", times, k2_ms, k2_plain, bound, by, mm_ms)
            k4f_call = (lambda: fu.norm_relu_matmul_stats(
                x, w, *bn.values(), 2e-5, True, "pallas")) if prologue \
                else (lambda: fu.matmul_stats(x, w, "pallas"))
            host_us = launch_host_us(k4f_call)
            split, fwd_traced = kernel_ms_by_group(
                k4f_call, flush, want=("matmul_stats_kernel",))
            kernel_ms = split["matmul_stats_kernel"]
            sums_ms = split.get("reduce_kernel", 0.0)
            parts["fwd_kernel_ms"] += times * kernel_ms
            parts["fwd_sums_ms"] += times * sums_ms
            emit(phase="k4f_timing", shape=shape, per_step=times,
                 normalize=prologue, relu=prologue, runs=25, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 share_of_bound=bound / ms, torch_mm_ms=mm_ms, k2_ms=k2_ms,
                 k3_ms=k3_ms if prologue else None, launch_host_us=host_us,
                 tile=mk.forward_plan(*shape)[0],
                 traced_calls=fwd_traced, traced_kernel_ms=kernel_ms,
                 traced_psum_sums_ms=sums_ms)

            y = mk.forward_plain(x, w, a, b, prologue)[0]
            args = (cots["gy"], cots["gs"], cots["gss"], y, x, w, consts,
                    prologue)
            bound, by = mm_bound(*shape, backward=True)
            ms = med(lambda: fu.fused_backward(*args))
            plain_ms = med(lambda: fu.fused_backward_plain(*args))
            gy = cots["gy"]
            mm_ms = med(lambda: (torch.mm(gy, w.t()), torch.mm(x.t(), gy)))
            add("k4b", times, ms, plain_ms, bound, by, mm_ms)
            host_us = launch_host_us(lambda: fu.fused_backward(*args))
            split, bwd_traced = kernel_ms_by_group(
                lambda: fu.fused_backward(*args), flush,
                want=("bwd_dx_kernel", "bwd_dw_kernel"))
            dx_ms, dw_ms = split["bwd_dx_kernel"], split["bwd_dw_kernel"]
            sums_ms = split.get("reduce_kernel", 0.0)
            parts["dx_kernel_ms"] += times * dx_ms
            parts["dw_kernel_ms"] += times * dw_ms
            parts["bwd_sums_ms"] += times * sums_ms
            dw_tile, splits, _, _ = mk.dw_plan(*shape)
            emit(phase="k4b_timing", shape=shape, per_step=times,
                 normalize=prologue, relu=prologue, runs=25, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 share_of_bound=bound / ms, torch_mm_ms=mm_ms,
                 launch_host_us=host_us,
                 dx_tile=mk.dx_plan(*shape, normalize=prologue)[0],
                 dw_tile=dw_tile, dw_splits=splits, traced_calls=bwd_traced,
                 traced_dx_ms=dx_ms,
                 traced_dw_ms=dw_ms, traced_partial_sums_ms=sums_ms)
    for key, t in step.items():
        t["bound_by"] = "bytes" if t.pop("bytes_ms") >= t.pop("ops_ms") \
            else "operations"
        emit(phase=f"{key}_step_total", launches_per_step=(
            sum(count_b.values()) if key == "k3"
            else sum(count_a.values()) + sum(count_b.values())),
            share_of_bound=t["bound_ms"] / t["ms"], **t)
    # K4f's and K4b's step sums split by kernel, from the profiled windows
    emit(phase="k4_step_split", **parts)
    return step


def k3_path(ops_b):
    """K3 has no model path in the JAX package; its path here is one call
    per conv3 of a ResNet-50 step, at those shapes, in bf16. Returns the
    launches."""
    from resnet_tpu_torch.ops.fused_chain import normalized_matmul_with_stats
    gen = torch.Generator(device="cuda").manual_seed(5)
    inputs = {s: op_inputs(gen, *s, torch.bfloat16)
              for s in dict.fromkeys(ops_b)}
    normalized_matmul_with_stats.launches = 0
    for shape in ops_b:
        x, w, bn, _ = inputs[shape]
        y, s, ss = normalized_matmul_with_stats(x, w, **bn)
        require(y.shape == (shape[0], shape[2]) and bool(
            torch.isfinite(y.float()).all() & torch.isfinite(s).all()
            & torch.isfinite(ss).all()), f"k3_path output at {shape}")
    torch.cuda.synchronize()
    launches = normalized_matmul_with_stats.launches
    emit(phase="k3_path", calls=len(ops_b), launches=launches)
    require(launches == len(ops_b), f"K3 launched {launches} times in "
            f"{len(ops_b)} calls")
    return launches


# ---------------------------------------------------------------------------
# K5, the BatchNorm backward's sum pair, and the two probes
# ---------------------------------------------------------------------------

REDUCE_PROBE_ITERS = 10


def library_sums(gy, x, mean, inv, weight):
    """K5's pair by the one PyTorch call that computes it, the column
    reduction of BatchNorm's backward: its grad_bias is Σ gy and its
    grad_weight Σ gy·(x−mean)·inv (``weight``: ones, float32). Checked and
    timed here as the library's number; the port never calls it."""
    _, _, s2, s1 = torch.batch_norm_backward_reduce(
        gy, x, mean, inv, weight, False, True, True)
    return s1, s2


def check_k5():
    """K5 and the library call against K5's plain version at the reduce
    probe's 8 shapes in bf16 and at 4096x128 in float32, with random mean
    and inv in [0.5, 2]; two launches on the same input give the same bits.
    Returns K5's worst |diff| of either sum."""
    from resnet_tpu_torch.tools import reduce_probe as rp
    gen = torch.Generator(device="cuda").manual_seed(6)
    worst = 0.0
    cases = [(shape, torch.bfloat16) for shape in rp.SHAPES] \
        + [((4096, 128), torch.float32)]
    for (m, c), dtype in cases:
        gy = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
        x = torch.randn((m, c), generator=gen, device="cuda").to(dtype)
        mean = torch.randn((c,), generator=gen, device="cuda") * 0.2
        inv = 0.5 + 1.5 * torch.rand((c,), generator=gen, device="cuda")
        got = rp.cuda_sums(gy, x, mean, inv)
        again = rp.cuda_sums(gy, x, mean, inv)
        want = rp.torch_sums(gy, x, mean, inv)
        library = library_sums(gy, x, mean, inv, torch.ones_like(mean))
        torch.cuda.synchronize()
        require(all(g.dtype == torch.float32 and tuple(g.shape) == (c,)
                    and bool(torch.isfinite(g).all()) for g in got),
                f"k5 outputs at {(m, c)}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"k5 is not deterministic at {(m, c)}")
        bounds = rp.sum_bounds(gy, x, mean, inv)
        results = {name: compare(g, w, bound) for name, g, w, bound in zip(
            ("s1", "s2"), got, want, bounds)}
        worst = max(worst, results["s1"][1], results["s2"][1])
        results.update({name: compare(g, w, bound) for name, g, w, bound
                        in zip(("library_s1", "library_s2"), library, want,
                               bounds)})
        report("k5_check", results, dtype=str(dtype), shape=[m, c],
               splits=rp.sum_splits(m, c)[0], bar_of_sum_abs=rp.SUM_TOL)
        del gy, x
    return worst


def reduce_probe_phase():
    """The port's reduce probe, as ``python -m
    resnet_tpu_torch.tools.reduce_probe --iters 10`` runs it, with K5's
    launch count set to 0 just before and read just after; then the library
    call timed the same way (bf16 inputs from seed 0, L2 flushed before
    each run) at each shape. Returns K5's sums over the 8 shapes (ms, plain
    ms, library ms, bound ms) and its launches."""
    from resnet_tpu_torch.tools import reduce_probe as rp
    from resnet_tpu_torch.utils.profiler import cuda_median_ms
    rp.cuda_sums.launches = 0
    rows = rp.probe(iters=REDUCE_PROBE_ITERS)
    torch.cuda.synchronize()
    launches = rp.cuda_sums.launches
    by_shape = {}
    for row in rows:
        by_shape.setdefault(tuple(row["shape"]), {})[row["route"]] = row
    require(sorted(by_shape) == sorted(rp.SHAPES)
            and all(set(v) == {"torch", "cuda"} for v in by_shape.values()),
            "the reduce probe did not time both routes at every shape")
    flush = torch.ones(64 << 20, dtype=torch.uint8, device="cuda").sum
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes, total = [], dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                             bound_ms=0.0)
    for m, c in rp.SHAPES:
        routes = by_shape[(m, c)]
        gy = torch.randn((m, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        x = torch.randn((m, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        mean, inv, weight = (torch.full((c,), v, device="cuda")
                             for v in (0.0, 1.0, 1.0))
        library_sums(gy, x, mean, inv, weight)             # warm
        library_ms = cuda_median_ms(
            lambda: library_sums(gy, x, mean, inv, weight),
            runs=REDUCE_PROBE_ITERS, flush=flush)
        shapes.append(dict(shape=[m, c], cuda_ms=routes["cuda"]["ms"],
                           torch_ms=routes["torch"]["ms"],
                           library_ms=library_ms,
                           cuda_gb_per_s=routes["cuda"]["gb_per_s"],
                           torch_gb_per_s=routes["torch"]["gb_per_s"],
                           library_gb_per_s=2 * m * c * 2 / library_ms / 1e6,
                           bound_ms=routes["cuda"]["bound_ms"],
                           splits=rp.sum_splits(m, c)[0]))
        total["ms"] += routes["cuda"]["ms"]
        total["plain_ms"] += routes["torch"]["ms"]
        total["library_ms"] += library_ms
        total["bound_ms"] += routes["cuda"]["bound_ms"]
        del gy, x
    require(launches > 0, "the reduce probe launched K5 no time")
    emit(phase="reduce_probe", iters=REDUCE_PROBE_ITERS, launches=launches,
         shapes=shapes, step_sum=total, card=nvidia_smi_line())
    return dict(total, launches=launches)


def trace_probe_phase(steps=5, warmup=3):
    """The port's trace probe at its defaults (ResNet-50, batch 256, bf16,
    ``bn_subsample=8``, standard stem, the augmentation kernel in the
    standard layout), traced into a temporary directory. K1's launch count
    must move by one a step."""
    from resnet_tpu_torch.ops.augment_fused import \
        fused_crop_mirror_normalize as k1
    from resnet_tpu_torch.tools import trace_probe as tp
    k1.launches = 0
    with trace_dir() as logdir:
        run = tp.trace_train_step(steps=steps, warmup=warmup, logdir=logdir)
        launches = k1.launches
        summary = tp.parse_trace(logdir, top=25, steps=steps)
    torch.cuda.empty_cache()
    require(summary is not None, "the trace holds no kernel events")
    require(launches == warmup + steps, f"K1 launched {launches} times in "
            f"{warmup + steps} steps")
    require(math.isfinite(run["loss"]), f"non-finite loss {run['loss']}")
    emit(phase="trace_probe", model="resnet50", batch=256, bn_subsample=8,
         steps=steps, warmup=warmup, k1_launches=launches,
         device_ms_per_step=summary["ms_per_step"],
         untraced_step_ms=run["untraced_step_ms"],
         traced_wall_ms_per_step=run["traced_wall_ms"] / steps,
         grouped_ms_per_step=summary["groups"], top=summary["top"][:10],
         loss=run["loss"], card=nvidia_smi_line())


# device-time categories of the traced call, matched on kernel names in
# this order
KERNEL_GROUPS = (
    ("augment kernel", ("fused_crop_mirror_normalize",)),
    ("collectives (NCCL)", ("nccl",)),
    ("fused 1x1-conv kernels", ("matmul_stats_", "bwd_dx_", "bwd_dw_")),
    ("conv and matmul", ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90",
                         "wgrad", "dgrad", "implicit")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def trace_dir():
    """A temporary directory for a chrome trace, inside the checkout's
    ignored build directory; removed when the ``with`` block ends."""
    from resnet_tpu_torch import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(prefix="trace_", dir=_build.BUILD_DIR)


def profile_call(phase, step, state, batch, images, untraced_ms, steps=1):
    """One more train call under torch.profiler: device time by kernel
    group, and the device's busy share of an untraced call (device time
    over the untraced calls' median wall time; the traced call's own wall
    time carries the tracer's overhead). The per-kernel sums are the
    profiler module's reading of the exported (uncompressed) chrome
    trace; device time
    counts kernels and the copy engines' copies and fills, as the
    profiler's CUDA events did before, and the copies' share is reported
    apart. Collectives a step (of the call's ``steps``): the host's
    all-reduce calls (``c10d::allreduce_`` events) and NCCL's kernels
    and their device ms."""
    import os
    from torch.profiler import ProfilerActivity, profile
    from resnet_tpu_torch.utils.profiler import (DEVICE_CATEGORIES,
                                                 kernel_times, load_trace)
    torch.cuda.synchronize()
    with trace_dir() as logdir:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) * 1e3
        # uncompressed: gzip, which maybe_trace's file name asks for, took
        # about 5 s a call of this script's 14
        path = os.path.join(logdir, "call.pt.trace.json")
        prof.export_chrome_trace(path)
        trace = load_trace(path)
    total_us, launches = kernel_times(trace, DEVICE_CATEGORIES)
    host_allreduce = sum(1 for e in trace.get("traceEvents", [])
                         if e.get("cat") == "cpu_op"
                         and e.get("name") == "c10d::allreduce_")
    nccl = [name for name in total_us if "nccl" in name.lower()]
    copies_ms = (sum(total_us.values())
                 - sum(kernel_times(trace)[0].values())) / 1e3
    by_kernel = {name: us / 1e3 for name, us in total_us.items()}
    groups = {}
    for name, ms in by_kernel.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(key in name.lower() for key in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", path=phase, images=images, traced_wall_ms=wall_ms,
         untraced_call_ms=untraced_ms,
         device_busy_ms=busy_ms if busy_ms else "not measured",
         device_busy_share=(busy_ms / untraced_ms if busy_ms
                            else "not measured"),
         memcpy_memset_ms=copies_ms, device_ms_by_group=groups,
         allreduce_calls_per_step=host_allreduce / steps,
         nccl_kernel_launches_per_step=sum(launches[n] for n in nccl) / steps,
         nccl_kernel_ms_per_step=sum(total_us[n] for n in nccl) / 1e3 / steps,
         top_kernels=[{"name": n[:90], "ms": ms} for n, ms in top])


def train_path(phase, cfg, timed_calls, per_step, eval_after=False,
               model="resnet50", absent=(), group=None, **fields):
    """One full-width train path: ``model`` as ``cfg`` builds it (ResNet-50,
    batch 128, bf16, 6 steps a call, unless ``cfg`` says otherwise); 1
    warm-up call and ``timed_calls`` timed ones. ``per_step`` maps each
    kernel wrapper on this path to its expected launches per step, and
    each wrapper of ``absent`` must launch no time; the counts are set to 0
    just before the path is driven and read just after. ``group``: the
    data-parallel step of ``cfg.train.dp_mode`` over that process group.
    ``fields`` go on the phase's line. Returns (wrapper -> launches, img/s
    of the median call, peak GiB allocated)."""
    from resnet_tpu_torch.config import DTYPES
    from resnet_tpu_torch.ops.augment import eval_center_crop, normalize
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import eval_step, make_train_step
    torch.backends.cudnn.benchmark = True
    k = cfg.train.steps_per_dispatch
    bs = cfg.train.batch_size
    cifar = cfg.model.dataset == "cifar10"
    side = cfg.data.image_shape[0] if cifar else CANVAS
    jit = group is not None and cfg.train.dp_mode == "jit"
    state = create_train_state(cfg, device="cuda",
                               bn_group=group if jit else None)
    step = make_train_step(label_smooth=cfg.train.label_smooth,
                           augment_fn=make_augment_fn(cfg),
                           steps_per_dispatch=k, group=group,
                           dp_mode=cfg.train.dp_mode)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = []
    for _ in range(2):
        batch = {
            "image": torch.randint(0, 256, (k, bs, side, side, 3),
                                   generator=gen, device="cuda",
                                   dtype=torch.uint8),
            "label": torch.randint(0, cfg.data.num_classes, (k, bs),
                                   generator=gen, device="cuda")}
        if not cifar:
            # full-canvas dims: orig == eff == canvas
            batch["dims"] = torch.full((k, bs, 4), CANVAS, dtype=torch.int32,
                                       device="cuda")
        if k == 1:
            batch = {name: v[0] for name, v in batch.items()}
        pool.append(batch)
    # the shapes this file times are derived from the model's structure:
    # hold them against what the running model's units really receive
    seen = []
    hooks = [u.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
        for u in state.model.units()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for wrapper in (*per_step, *absent):
        wrapper.launches = 0
    calls, times, losses = 1 + timed_calls, [], []
    for c in range(calls):
        tic = time.perf_counter()
        state, m = step(state, pool[c % 2])
        torch.cuda.synchronize()
        if c:                                   # call 0 is the warm-up
            times.append(time.perf_counter() - tic)
        else:
            for h in hooks:
                h.remove()
        losses.append(float(m["loss_sum"] / m["count"]))
    launches = {w: w.launches for w in per_step}
    steps = calls * k
    require(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    for w, n in per_step.items():
        require(launches[w] == steps * n and launches[w] > 0,
                f"{phase}: {w.__name__} launched {launches[w]} times in "
                f"{steps} steps, expected {n} a step")
    for w in absent:
        require(w.launches == 0, f"{phase}: {w.__name__} launched "
                f"{w.launches} times, expected none")
    require(state.step == steps, "step count")
    if not cifar and state.model.units()[0].bottleneck:
        want_inputs = r50_op_shapes(state.model, bs, OUT)[2]
        if cfg.train.remat or cfg.train.remat_policy != "none":
            # the backward runs each unit once more, last unit first
            want_inputs = want_inputs + want_inputs[::-1]
        require(seen == want_inputs * k, f"{phase}: the units saw "
                f"{seen[:3]}..., the shape table assumes {want_inputs[:3]}...")
    call_s = statistics.median(times)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    emit(phase=phase, model=model, batch=bs, steps_per_call=k,
         calls=calls, warmup_calls=1, losses=losses, call_seconds=times,
         median_call_seconds=call_s, img_per_s=k * bs / call_s,
         bn_ema=cfg.train.bn_ema, unit_chain=cfg.train.unit_chain,
         fused_convbn=cfg.train.fused_convbn,
         launches={w.__name__: n for w, n in launches.items()},
         launches_per_step={w.__name__: n for w, n in per_step.items()},
         absent={w.__name__: w.launches for w in absent},
         peak_memory_gib=peak_gib, **fields,
         card=nvidia_smi_line(), device=torch.cuda.get_device_name(0))
    profile_call(phase, step, state, pool[0], k * bs, call_s * 1e3, k)
    if eval_after:
        first = {name: v[0] if k > 1 else v for name, v in pool[0].items()}
        dtype = DTYPES[cfg.train.dtype]
        preprocess = (
            (lambda im: normalize(im, cfg.data.mean_rgb, cfg.data.std_rgb,
                                  dtype)) if cifar else
            (lambda im: eval_center_crop(im, cfg.data, (OUT, OUT), dtype)))
        metrics = eval_step(state, {"image": first["image"],
                                    "label": first["label"]},
                            preprocess_fn=preprocess)
        ev = {name: float(v) for name, v in metrics.items()}
        require(ev["count"] == bs and all(map(math.isfinite, ev.values())),
                f"eval metrics {ev}")
        emit(phase="eval_step", path=phase, **ev)
    del state, step, pool
    torch.cuda.empty_cache()
    return launches, k * bs / call_s, peak_gib


# ---------------------------------------------------------------------------
# The rest of the model family and the augmentation variants
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, without autotuning, inside the
    block: two runs of one computation then give the same bits."""
    prev = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def remat_reference_phase():
    """ResNet-50 with remat: one float32 step on the card against the CPU
    path (``reference_check``), then on the card against the same step
    without remat from the same weights and rows: the update (hence the
    gradient) equal, and the running statistics bit-equal, refreshed once
    (twice would move them by another 10%)."""
    with deterministic_cudnn():
        states = {remat: reference_check(
            "remat_reference" if remat else "remat_reference_plain",
            remat=remat) for remat in (True, False)}
    on, off = states[True], states[False]
    upd = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))
              for a, b in zip(on.momentum, off.momentum))
    stats_equal = all(torch.equal(a, b) for a, b in
                      zip(on.model.buffers(), off.model.buffers()))
    emit(phase="remat_reference_vs_plain", max_update_diff_of_max=upd,
         running_stats_bit_equal=stats_equal)
    require(upd < 1e-5, "remat changes the update")
    require(stats_equal, "remat changes the running statistics")


def k1_split_mode_phase(cfg):
    """K1 in the split mode of ``augment_impl="pallas-split"`` (identity
    normalization, float32 out, no photometric flags) at the main path's
    launch, bs128 256 -> 224 in s2d, against its plain version and timed;
    then the whole split augmenter against the fused one on the same rows,
    within ``TOL``. Returns K1's split-mode numbers."""
    from resnet_tpu_torch.ops.augment_fused import (
        augment_imagenet_fused, fused_crop_mirror_normalize as k1,
        fused_crop_mirror_normalize_reference as k1_plain)
    from resnet_tpu_torch.utils.profiler import cuda_median_ms
    gen = torch.Generator(device="cuda").manual_seed(0)
    canvas, rows, data = aug_inputs(cfg.data, gen, BATCH, True)
    args = (canvas, rows, (OUT, OUT), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
            torch.float32)
    got, want = k1(*args, s2d=True), k1_plain(*args, s2d=True)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    atol, rtol = TOL[torch.float32]
    bad = int((diff > atol + rtol * want.abs()).sum())
    err = float(diff.max())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    t = dict(ms=cuda_median_ms(lambda: k1(*args, s2d=True), flush=flush),
             plain_ms=cuda_median_ms(lambda: k1_plain(*args, s2d=True),
                                     flush=flush),
             **aug_bounds(canvas, rows, (OUT, OUT), torch.float32, False,
                          False, False))
    emit(phase="k1_split_mode", batch=BATCH, canvas=CANVAS, out=OUT,
         s2d=True, dtype="torch.float32", max_abs_diff=err, atol=atol,
         rtol=rtol, out_of_tolerance=bad, runs=25, **t,
         share_of_bound=t["bound_ms"] / t["ms"])
    require(bad == 0, "K1's split mode disagrees with its plain version")
    for dtype in (torch.float32, torch.bfloat16):
        outs = [augment_imagenet_fused(canvas, None, data, (OUT, OUT), dtype,
                                       s2d=True, rows=rows, split=split)
                for split in (True, False)]
        d = (outs[0].float() - outs[1].float()).abs()
        atol, rtol = TOL[dtype]
        bad = int((d > atol + rtol * outs[1].float().abs()).sum())
        emit(phase="k1_split_augmenter", dtype=str(dtype),
             photometric="hsl+contrast+illumination", max_abs_diff=float(
                 d.max()), atol=atol, rtol=rtol, out_of_tolerance=bad)
        require(bad == 0, "the split augmenter disagrees with the fused one")
    del canvas, rows, got, want, diff, outs, d
    torch.cuda.empty_cache()
    return dict(t, max_abs_err=err)


def rotate_check_phase(cfg):
    """The device rotate/shear warp at bs128 on 256x256 canvases (angles
    within 10 degrees, shears within 0.1) on the card against the CPU, and
    timed; then the whole rotate augmenter, through which K1 launches no
    time (the warp makes a float32 canvas, and K1 reads uint8)."""
    from resnet_tpu_torch.ops.augment import rotate_images, sample_rotate
    from resnet_tpu_torch.ops.augment_fused import (
        fused_crop_mirror_normalize as k1, make_augment_fn)
    from resnet_tpu_torch.utils.profiler import cuda_median_ms
    rot = copy.deepcopy(cfg)
    rot.data = dataclasses.replace(cfg.data, max_rotate_angle=10.0,
                                   max_shear_ratio=0.1,
                                   rotate_backend="device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    canvas, _, _ = aug_inputs(rot.data, gen, BATCH, False)
    angles, shears = sample_rotate(gen, rot.data, BATCH, device="cuda")
    got = rotate_images(canvas, angles, shears)
    want = rotate_images(canvas.cpu(), angles.cpu(), shears.cpu())
    err = float((got.cpu() - want).abs().max())
    ms = cuda_median_ms(lambda: rotate_images(canvas, angles, shears))
    fn = make_augment_fn(rot)
    dims = torch.full((BATCH, 4), CANVAS, dtype=torch.int32, device="cuda")
    k1.launches = 0
    out = fn(canvas, gen, dims)
    torch.cuda.synchronize()
    launches = k1.launches
    aug_ms = cuda_median_ms(lambda: fn(canvas, gen, dims), runs=5)
    emit(phase="rotate_check", batch=BATCH, canvas=CANVAS,
         max_angle_deg=10.0, max_shear=0.1, max_abs_diff_vs_cpu=err,
         atol=5e-2, rotate_images_ms=ms, augmenter_ms=aug_ms,
         k1_launches=launches, out_shape=list(out.shape),
         card=nvidia_smi_line())
    require(err < 5e-2, "the card's warp differs from the CPU's")
    require(launches == 0, "K1 launched on the rotate path")
    require(bool(torch.isfinite(out.float()).all()), "non-finite output")
    del canvas, got, want, out
    torch.cuda.empty_cache()


def resnext_cfg(grouped_dense=True):
    from resnet_tpu_torch.config import imagenet_resnext50
    cfg = imagenet_resnext50()
    cfg.train.grouped_dense = grouped_dense
    return cfg


# The imagenet_resnet152_dp preset's per-device share (batch 2048 over 16
# devices: 128) at this depth in remat_path and dp_path: the preset's
# widths, bn-ema, remat, s2d stem and K1 at about a third of ResNet-152's
# time. At depth 152 the two phases took 43 s and 125 s of this script's
# 600 s budget on an H100.
DP_DEPTH = 50


def dp_preset(**train):
    """imagenet_resnet152_dp at depth ``DP_DEPTH``, one device, batch 128,
    with ``train`` set on ``cfg.train``."""
    from resnet_tpu_torch.config import imagenet_resnet152_dp
    cfg = imagenet_resnet152_dp()
    cfg.model.depth = DP_DEPTH
    cfg.train.num_devices, cfg.train.batch_size = 1, BATCH
    for name, value in train.items():
        setattr(cfg.train, name, value)
    return cfg


def remat_path_phase(k1):
    """``dp_preset``: ResNet-50 at the widths of imagenet_resnet152_dp's
    per-device share, bf16, batch 128, 4 steps a call, with remat and
    without; peak memory and img/s of both."""
    out = {}
    for remat in (True, False):
        out[remat] = train_path(
            "remat_path" if remat else "remat_path_off",
            dp_preset(remat=remat), 2, {k1: 1},
            model=f"resnet{DP_DEPTH}", remat=remat,
            note=f"per-device share of imagenet_resnet152_dp (2048/16), "
                 f"num_devices=1, depth {DP_DEPTH}")
    (_, img_on, gib_on), (_, img_off, gib_off) = out[True], out[False]
    emit(phase="remat_summary", img_per_s_remat=img_on,
         img_per_s_no_remat=img_off, peak_gib_remat=gib_on,
         peak_gib_no_remat=gib_off, peak_gib_saved=gib_off - gib_on,
         card=nvidia_smi_line())
    require(gib_on < gib_off, "remat saved no memory")
    return img_on


# ---------------------------------------------------------------------------
# The training entry point: the fit loop, prefetch, checkpoints, resume
# ---------------------------------------------------------------------------

# 24 steps of batch 128 an epoch: four 6-step dispatches
FIT_EXAMPLES = 3072


def fit_argv(prefix, *extra):
    """The CLI of the fit phases: the imagenet_resnet50 preset (ResNet-50,
    batch 128, bf16, 6 steps a call) on the in-memory pipeline, 2 epochs,
    the bn-ema switch at step 12, a Speedometer window every dispatch."""
    return ["--preset", "imagenet_resnet50", "--pipeline", "memory",
            "--num-examples", str(FIT_EXAMPLES), "--num-epochs", "2",
            "--bn-ema-warmup", "12", "--frequent", "6",
            "--model-prefix", prefix, *extra]


class LogLines:
    """The messages the port's logger emits inside the ``with`` block."""

    def __enter__(self):
        import logging
        self.lines = []
        self.handler = logging.Handler()
        self.handler.emit = lambda rec: self.lines.append(rec.getMessage())
        logging.getLogger("resnet_tpu_torch").addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        import logging
        logging.getLogger("resnet_tpu_torch").removeHandler(self.handler)

    def numbers(self, pattern):
        return [float(m.group(1)) for m in map(re.compile(pattern).search,
                                               self.lines) if m]


def eval_logits(state, images):
    with torch.no_grad():
        state.model.eval()
        return state.model(images)


@contextlib.contextmanager
def timed_train_calls():
    """CUDA events around every train call the Solver makes: yields the
    list of (start, end) event pairs, in call order."""
    import resnet_tpu_torch.train.solver as solver_module
    make = solver_module.make_train_step
    events = []

    def timed_make(*args, **kw):
        step = make(*args, **kw)

        def timed(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch)
            end.record()
            events.append((start, end))
            return out
        return timed
    solver_module.make_train_step = timed_make
    try:
        yield events
    finally:
        solver_module.make_train_step = make


def fit_path_phase(main_img_s, tmp):
    """``train_resnet.main`` at the preset: 2 epochs with a checkpoint and a
    validation pass each; CUDA events around each train call give the
    device's share of the second epoch's wall time (the rest is the host:
    the loop, the prefetch, the metric reads). Then the checkpoint's save
    and load times, and ``fit_params``: the epoch checkpoint as an MXNet
    ``.params`` file, loaded by ``--load-epoch``, gives bit-equal eval
    logits."""
    import os
    from resnet_tpu_torch import train_resnet
    from resnet_tpu_torch.config import build_parser, config_from_args
    from resnet_tpu_torch.ops.augment_fused import \
        fused_crop_mirror_normalize as k1
    from resnet_tpu_torch.train import checkpoint as ckpt
    from resnet_tpu_torch.train.solver import Solver, _eval_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.utils.export import save_mxnet_style
    from resnet_tpu_torch.utils.profiler import input_overhead
    prefix = os.path.join(tmp, "r50")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1.launches = 0
    tic = time.perf_counter()
    with LogLines() as log, timed_train_calls() as calls:
        state = train_resnet.main(fit_argv(prefix))
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - tic
    launches = k1.launches
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    call_ms = [a.elapsed_time(b) for a, b in calls]
    windows = log.numbers(r"Speed: ([\d.]+) samples/sec")
    switched = log.numbers(r"bn-ema: warmup done at step (\d+)")
    epoch_s = log.numbers(r"Epoch\[\d+\] Time cost=([\d.]+)")
    losses = log.numbers(r"Epoch\[\d+\] Train-cross-entropy=([-\w.]+)")
    val = log.numbers(r"Epoch\[\d+\] Validation-accuracy=([-\w.]+)")
    steps = 2 * FIT_EXAMPLES // 128
    require(state.step == steps, f"fit ended at step {state.step}")
    require(switched == [12.0], f"bn-ema switched at {switched}")
    require(len(losses) == 2 and all(map(math.isfinite, losses)),
            f"epoch losses {losses}")
    require(len(val) == 2 and len(windows) == 6 and len(call_ms) == 8,
            f"{val} {windows} {call_ms}")
    require(launches == steps, f"K1 launched {launches} times in "
            f"{steps} steps")
    cfg = config_from_args(build_parser().parse_args(fit_argv(prefix)))
    # the checkpoint's save and load
    torch.cuda.synchronize()
    tic = time.perf_counter()
    ckpt.save_checkpoint(os.path.join(tmp, "copy"), 2, state)
    save_s = time.perf_counter() - tic
    fresh = create_train_state(cfg, device="cuda")
    torch.cuda.synchronize()
    tic = time.perf_counter()
    ckpt.load_checkpoint(prefix, 2, fresh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - tic
    require(fresh.step == steps and all(
        torch.equal(a, b) for a, b in zip(fresh.momentum,
                                          state.momentum)),
            "the loaded checkpoint differs from the state")
    # fit_params
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randint(0, 256, (64, OUT, OUT, 3), generator=gen,
                           device="cuda", dtype=torch.uint8)
    x = _eval_fn(cfg)(images)
    want = eval_logits(state, x)
    mx_prefix = os.path.join(tmp, "mx")
    save_mxnet_style(mx_prefix, 2, state, fmt="params")
    mx_cfg = config_from_args(build_parser().parse_args(
        fit_argv(mx_prefix, "--load-epoch", "2")))
    loaded = Solver(mx_cfg, device="cuda").init_state()
    got = eval_logits(loaded, x)
    require(loaded.step == steps and not any(
        m.any() for m in loaded.momentum), ".params resume state")
    require(torch.equal(got, want), "eval logits after the .params "
            f"round trip differ by {(got - want).abs().max().item()}")
    emit(phase="fit_params", file=os.path.basename(mx_prefix)
         + "-0002.params", step=loaded.step, logits=tuple(got.shape),
         bit_equal=True)
    del fresh, loaded, state
    steady = windows[1:]
    fit_img_s = statistics.median(steady)
    busy_ms = sum(call_ms[4:])        # the 4 calls of epoch 1
    fields = dict(
        phase="fit_path", model="resnet50", batch=128, steps_per_call=6,
        examples=FIT_EXAMPLES, epochs=2, steps=steps, wall_seconds=wall_s,
        window_img_per_s=windows, steady_windows=steady,
        median_img_per_s=fit_img_s, bn_ema_switch_step=switched[0],
        epoch_seconds=epoch_s, epoch_train_cross_entropy=losses,
        val_accuracy=val, checkpoint_save_s=save_s, checkpoint_load_s=load_s,
        peak_memory_gib=peak_gib, k1_launches=launches, call_device_ms=call_ms,
        device_idle_share=1 - busy_ms / (epoch_s[1] * 1e3),
        card=nvidia_smi_line())
    if main_img_s:
        fields.update(main_path_img_per_s=main_img_s,
                      input_overhead=input_overhead(1 / fit_img_s,
                                                    1 / main_img_s))
    emit(**fields)
    torch.cuda.empty_cache()
    return launches


def _state_gap(path_a, path_b, init):
    """How far apart two checkpoint files are, relative to how far training
    moved: ``||(a - init) - (b - init)|| / ||a - init||`` over all model
    tensors (params and BN stats) together, and ``||a - b|| / ||a||`` over
    the momentum buffers; the larger of the two."""
    a = torch.load(path_a, map_location="cpu", weights_only=True)
    b = torch.load(path_b, map_location="cpu", weights_only=True)
    require(a["step"] == b["step"], f"steps {a['step']} {b['step']}")

    def rel(xs, ys, base):
        num = sum(float(((x.double() - y.double()) ** 2).sum())
                  for x, y in zip(xs, ys))
        den = sum(float(((x.double() - z.double()) ** 2).sum())
                  for x, z in zip(xs, base))
        return math.sqrt(num / max(den, 1e-300))
    zeros = [torch.zeros_like(m) for m in a["momentum"]]
    return max(rel(list(a["model"].values()), list(b["model"].values()),
                   list(init.values())),
               rel(a["momentum"], b["momentum"], zeros))


def fit_resume_phase():
    """Real CLI processes: two uninterrupted runs, and one that gets
    SIGTERM mid-epoch, exits 143 and is relaunched with ``--auto-resume``.
    One epoch of ResNet-18 at 112x112 (the preset otherwise) keeps the
    four processes short; the two
    uninterrupted runs and the killed one start at once, the relaunch
    when the killed one has exited. Each runs the entry point through
    ``deterministic_train`` (deterministic cuDNN and cuBLAS,
    ``torch.use_deterministic_algorithms``): where the two
    uninterrupted runs agree bit for bit, the resumed run must equal them
    bit for bit, as the CPU test ``test_kill_and_resume_is_bit_equal``
    holds it; where they do not, the ops that warned are named and the
    resumed run may be no further from run a than twice run b is."""
    import os
    import signal
    root = os.path.dirname(os.path.abspath(__file__))

    def cli(prefix, *extra):
        return [sys.executable, "-u", __file__, "--deterministic-train",
                *fit_argv(prefix, "--num-epochs", "1", "--depth", "18",
                          "--image-shape", "112,112,3", *extra)]

    def run(cmd, kill_at=None):
        proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        out, killed = [], False
        try:
            for line in proc.stdout:
                out.append(line)
                if kill_at and kill_at in line and not killed:
                    proc.send_signal(signal.SIGTERM)
                    killed = True
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        return rc, "".join(out)

    outs = []
    with trace_dir() as tmp:
        tic = time.perf_counter()
        killed = os.path.join(tmp, "killed")
        # side by side on the card: deterministic algorithms give the same
        # bits however the processes interleave
        def kill_and_resume():
            first = run(cli(killed), "Epoch[0] Batch [12]")
            if first[0] != 143:
                return first, None
            return first, run(cli(killed, "--auto-resume"))

        with ThreadPoolExecutor(3) as pool:
            runs = [pool.submit(run, cli(os.path.join(tmp, name)))
                    for name in ("a", "b")]
            resumed = pool.submit(kill_and_resume)
            for name, fut in zip(("a", "b"), runs):
                rc, out = fut.result()
                outs.append(out)
                require(rc == 0, f"run {name} failed:\n{out[-3000:]}")
            (rc_kill, out), second = resumed.result()
        outs.append(out)
        require(rc_kill == 143, f"killed run exited {rc_kill}:\n{out[-3000:]}")
        saved = re.findall(r"checkpointed epoch 0 batch (\d+)", out)
        rc_res, out = second
        outs.append(out)
        require(rc_res == 0, f"resumed run failed:\n{out[-3000:]}")
        require("Resumed from epoch 0" in out, "the relaunch did not resume")
        from resnet_tpu_torch.config import build_parser, config_from_args
        from resnet_tpu_torch.train.state import create_train_state
        # the seeded initial state every run starts from
        init = create_train_state(config_from_args(build_parser().parse_args(
            cli(killed)[4:])), device="cpu").model.state_dict()
        run_gap = _state_gap(os.path.join(tmp, "a", "1.pt"),
                             os.path.join(tmp, "b", "1.pt"), init)
        resume_gap = _state_gap(os.path.join(tmp, "a", "1.pt"),
                                os.path.join(killed, "1.pt"), init)
        seconds = time.perf_counter() - tic
    ops = sorted(set(NONDETERMINISTIC.findall("".join(outs))))
    emit(phase="fit_resume", killed_exit=rc_kill, saved_at_batch=saved,
         run_to_run_gap=run_gap, resume_gap=resume_gap,
         bit_equal=resume_gap == 0 and run_gap == 0,
         deterministic_algorithms=True, nondeterministic_ops=ops,
         seconds=seconds, processes=4)
    if run_gap == 0:
        require(resume_gap == 0, f"the runs agree bit for bit, the resumed "
                f"run is {resume_gap} from them")
    else:
        require(resume_gap <= 2 * run_gap,
                f"resumed run {resume_gap} from the uninterrupted one, runs "
                f"{run_gap} from each other (nondeterministic: {ops})")


def prefetch_check_phase(cfg):
    """Batches through the pinned, side-stream ``prefetch_grouped`` equal
    the host batches over two epochs while the K-step call trains on them:
    a checksum of every batch is taken on the compute stream after the
    train call and its reference dropped, so that memory handed back too
    early would show; the first group of each epoch is also compared byte
    for byte."""
    import numpy as np
    from resnet_tpu_torch.data.loader import MemoryIter
    from resnet_tpu_torch.data.prefetch import prefetch_grouped
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    k, bs, n_batches = 6, 128, 15        # two groups and a 3-batch tail
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (bs * n_batches, OUT, OUT, 3), np.uint8)
    labels = rng.integers(0, 1000, bs * n_batches).astype(np.int32)
    it = MemoryIter(images, labels, bs, seed=0)
    state = create_train_state(cfg, device="cuda")
    steps = {n: make_train_step(augment_fn=make_augment_fn(cfg),
                                steps_per_dispatch=n) for n in (1, k)}
    weights = {}

    def checksum(t):
        flat = t.reshape(-1).to(torch.int64)
        if flat.numel() not in weights:
            weights[flat.numel()] = torch.arange(
                flat.numel(), device=t.device, dtype=torch.int64) % 251 + 1
        return torch.stack([flat.sum(), (flat * weights[flat.numel()]).sum()])

    def host_checksum(a):
        flat = a.reshape(-1).astype(np.int64)
        w = np.arange(flat.size, dtype=np.int64) % 251 + 1
        return [int(flat.sum()), int((flat * w).sum())]

    sums, want, ns, exact = [], [], [], 0
    for epoch in (0, 1):
        host = list(it.epoch_iter(epoch))
        i = 0
        for batch, n in prefetch_grouped(it.epoch_iter(epoch), k, size=2,
                                         device="cuda"):
            group = host[i:i + n]
            if i == 0:
                for name, t in batch.items():
                    require(np.array_equal(
                        t.cpu().numpy(),
                        np.stack([b[name] for b in group])),
                        f"epoch {epoch} group 0 {name} differs")
                    exact += 1
            state, _ = steps[n](state, batch)
            sums.append({name: checksum(t) for name, t in batch.items()})
            want.append({name: host_checksum(
                np.stack([b[name] for b in group]) if n > 1
                else group[0][name]) for name in batch})
            ns.append(n)
            i += n
            del batch
        require(i == n_batches, f"epoch {epoch}: {i} batches")
    torch.cuda.synchronize()
    got = [{name: c.tolist() for name, c in s.items()} for s in sums]
    require(got == want, "a prefetched batch differs from its host batch")
    emit(phase="prefetch_check", epochs=2, dispatch_sizes=ns,
         checksummed=len(got), compared_exactly=exact, equal=True)
    del state, steps
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Deployment: fit_path's checkpoint through the symbol file, the MXNet pair,
# predict, validate, the serving artifact and its benchmark
# ---------------------------------------------------------------------------

# the artifact against the live model on the card: serve_export --check's bar
SERVE_TOL = 1e-3
SERVE_REQUESTS = 8
SERVE_BATCHES = (1, 7, 256)


def tool_run(main, argv):
    """A tool's ``main(argv)`` in this process, its standard output captured
    (its lines must not pass for this script's JSON lines); returns (exit
    code, output)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = main(argv)
    return rc, out.getvalue()


def serve_phase(tmp):
    """fit_path's epoch-2 checkpoint in ``tmp`` (the imagenet_resnet50
    preset at full width: ResNet-50 v1, s2d stem, bf16, 224x224) through
    the deployment tools, one line a step: the ``-symbol.json`` fit wrote
    (``serve_symbol``); ``export_mxnet``'s pair (``serve_export_mxnet``);
    ``predict`` on 8 PNG files and an 8-record JPEG ``.rec`` of the
    validation canvases, from the ``.pt`` checkpoint and from the pair
    with wrong ``--depth`` flags (``serve_predict``); ``validate`` against
    the Solver's epoch-2 validation (``serve_validate``); ``serve_export
    --check`` with a symbolic batch (then checked at batches 1, 7 and 256
    on the card), a pinned one, and for two devices, which this one-card
    machine refuses (``serve_export_check``); and ``bench_serving`` at
    ResNet-50, batch 256 (``serve_bench``). The tools' checks run on
    cuDNN's deterministic algorithms, so the live model and the artifact
    take the same ones."""
    import ast
    import io
    import os
    import numpy as np
    from PIL import Image
    from resnet_tpu_torch.config import build_parser, config_from_args
    from resnet_tpu_torch.data.loader import make_val_iter
    from resnet_tpu_torch.data.recordio import (RecordIOWriter,
                                                pack_image_record)
    from resnet_tpu_torch.tools import (bench_serving, export_mxnet, predict,
                                        serve_export, validate)
    from resnet_tpu_torch.tools.common import load_trained
    from resnet_tpu_torch.utils.export import export_mxnet_params
    from resnet_tpu_torch.utils.mxnet_params import load_params
    from resnet_tpu_torch.utils.serving import load_serving, make_serving_fn
    from resnet_tpu_torch.utils.symbol_export import (config_from_symbol,
                                                      symbol_json)
    prefix = os.path.join(tmp, "r50")
    argv = fit_argv(prefix, "--load-epoch", "2")
    cfg = config_from_args(build_parser().parse_args(argv))
    with deterministic_cudnn():
        tic = time.perf_counter()
        sym_path = f"{prefix}-symbol.json"
        with open(sym_path) as f:
            sym_equal = f.read() == symbol_json(cfg)
        other = config_from_args(build_parser().parse_args(
            ["--preset", "cifar10_resnet18", "--num-classes", "7"]))
        back = config_from_symbol(other, sym_path)
        got = [back.model.network, back.model.depth, back.model.version,
               back.data.num_classes]
        want = [cfg.model.network, cfg.model.depth, cfg.model.version,
                cfg.data.num_classes]
        emit(phase="serve_symbol", file=os.path.basename(sym_path),
             equals_symbol_json=sym_equal, config_from_symbol=got,
             preset=want, seconds=time.perf_counter() - tic)
        require(sym_equal, "fit's -symbol.json is not symbol_json(cfg)")
        require(got == want, f"config_from_symbol gave {got}, not {want}")

        tic = time.perf_counter()
        pair = os.path.join(tmp, "pair", "r50")
        rc, out = tool_run(export_mxnet.main, ["--out", pair, "--", *argv])
        require(rc == 0 and out.split() == [f"{pair}-symbol.json",
                                            f"{pair}-0002.params"], out)
        _, state = load_trained(cfg, "cuda")
        tables = load_params(f"{pair}-0002.params")
        want_tables = export_mxnet_params(state)
        pair_equal = all(
            sorted(t) == sorted(w) and all(np.array_equal(t[k], w[k])
                                           for k in w)
            for t, w in zip(tables, want_tables))
        emit(phase="serve_export_mxnet", files=out.split(),
             arrays=sum(map(len, tables)), equal_to_checkpoint=pair_equal,
             seconds=time.perf_counter() - tic)
        require(pair_equal, "the .params arrays differ from the checkpoint")

        tic = time.perf_counter()
        val = next(iter(make_val_iter(cfg).epoch_iter(0)))["image"]
        requests = os.path.join(tmp, "requests")
        os.makedirs(requests)
        rec = os.path.join(tmp, "requests.rec")
        with RecordIOWriter(rec) as w:
            for i, img in enumerate(val[:SERVE_REQUESTS]):
                Image.fromarray(img).save(os.path.join(requests,
                                                       f"{i}.png"))
                jpeg = io.BytesIO()
                Image.fromarray(img).save(jpeg, format="JPEG", quality=95)
                w.write(pack_image_record(jpeg.getvalue(), 0.0, i))
        inputs = ["--inputs", requests, rec, "--"]
        rc_pt, from_pt = tool_run(predict.main, inputs + argv)
        rc_pair, from_pair = tool_run(predict.main, inputs + fit_argv(
            pair, "--load-epoch", "2", "--depth", "18", "--num-classes",
            "10"))
        answers = [json.loads(line) for line in from_pt.splitlines()]
        top1 = [a["top_k"][0]["class"] for a in answers]
        canvases = np.stack([c for _, c in predict._iter_inputs(
            [requests, rec], (OUT, OUT), 1 << 30)])
        live = make_serving_fn(cfg, state.model)
        with torch.inference_mode():
            argmax = live(torch.from_numpy(canvases).cuda()).argmax(
                -1).tolist()
        emit(phase="serve_predict", requests=len(answers),
             png=SERVE_REQUESTS, rec_records=SERVE_REQUESTS,
             pair_equals_checkpoint=from_pair == from_pt, top1=top1,
             live_argmax=argmax, first_answer=answers[0],
             seconds=time.perf_counter() - tic)
        require(rc_pt == 0 and rc_pair == 0, "predict failed")
        require(len(answers) == 2 * SERVE_REQUESTS, f"{len(answers)} answers")
        require(from_pair == from_pt, "predict from the pair (wrong --depth "
                "flags, the symbol overriding them) answers otherwise")
        require(top1 == argmax, "predict's top-1 is not the live argmax")

        tic = time.perf_counter()
        with open(f"{prefix}.metrics.jsonl") as f:
            fit_val = next(r for r in map(json.loads, f)
                           if r["split"] == "val" and r["epoch"] == 1)
        rc, out = tool_run(validate.main, argv)
        got = ast.literal_eval(out.strip().splitlines()[-1])
        n = len(make_val_iter(cfg).images)
        # the two passes may take other cuDNN algorithms (the fit's were
        # autotuned): within one image of each count, the loss to 1e-3
        gaps = {k: abs(got[k] - fit_val[k]) * n for k in
                ("accuracy", "top_k_accuracy_5")}
        loss_gap = abs(got["cross-entropy"] - fit_val["cross-entropy"]) \
            / abs(fit_val["cross-entropy"])
        emit(phase="serve_validate", images=n, validate=got,
             fit_epoch_2={k: fit_val[k] for k in got}, count_gaps=gaps,
             loss_rel_gap=loss_gap, seconds=time.perf_counter() - tic)
        require(rc == 0 and all(g <= 1 + 1e-6 * n for g in gaps.values())
                and loss_gap <= 1e-3, "validate differs from the Solver")

        tic = time.perf_counter()
        art = os.path.join(tmp, "artifacts")
        checks = {}
        for name, extra in (("symbolic", []),
                            ("pinned", ["--serve-batch-size", "8"])):
            rc, out = tool_run(serve_export.main, [
                "--out", os.path.join(art, name), "--check", *extra, "--",
                *argv])
            require(rc == 0, f"serve_export --check ({name}):\n{out}")
            checks[name] = float(re.search(r"max \|dlogit\| = (\S+)",
                                           out).group(1))
        sym = os.path.join(art, "symbolic")
        written_on = sorted({t.device.type for t in
                             torch.export.load(sym + ".pt2")
                             .state_dict.values()})
        serve, manifest = load_serving(sym)
        gen = torch.Generator(device="cuda").manual_seed(5)
        x = torch.randint(0, 256, (max(SERVE_BATCHES), OUT, OUT, 3),
                          generator=gen, device="cuda", dtype=torch.uint8)
        batch_errs = {}
        for b in SERVE_BATCHES:
            got = serve(x[:b])
            with torch.inference_mode():
                want = live(x[:b])
            require(got.shape == (b, cfg.data.num_classes)
                    and got.device.type == "cuda", f"batch {b}: {got.shape}")
            batch_errs[b] = float((got - want).abs().max())
            require(torch.allclose(got, want, atol=SERVE_TOL,
                                   rtol=SERVE_TOL),
                    f"batch {b}: the artifact is {batch_errs[b]} off")
        try:
            tool_run(serve_export.main, [
                "--out", os.path.join(art, "two"), "--serve-devices", "2",
                "--check", "--", *argv])
            refused = None
        except ValueError as e:
            refused = str(e)
        emit(phase="serve_export_check", tol=SERVE_TOL,
             check_max_abs_err=checks, written_on=written_on,
             loaded_on="cuda", batch_max_abs_err=batch_errs,
             input_shape=manifest["input"]["shape"],
             artifact_mb=os.path.getsize(sym + ".pt2") / 2 ** 20,
             two_device_refused=refused, seconds=time.perf_counter() - tic)
        require(written_on == ["cpu"], f"artifact tensors on {written_on}")
        require(refused is not None and "exported for 2 devices" in refused,
                f"a 2-device artifact on one card: {refused}")
    del state, live, serve, x
    torch.cuda.empty_cache()

    tic = time.perf_counter()
    rc, out = tool_run(bench_serving.main, ["--windows", "3", "--steps",
                                            "50"])
    rec = json.loads(next(line for line in out.splitlines()
                          if line.startswith("{")))
    emit(phase="serve_bench", **rec, card=nvidia_smi_line(),
         seconds=time.perf_counter() - tic)
    require(rc == 0 and rec["value"] > 0 and rec["live_jit"] > 0,
            "bench_serving")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Data parallelism: the modes over two ranks against plain computations, the
# imagenet_resnet152_dp path at world size 1, the dry run
# ---------------------------------------------------------------------------

# a data-parallel step against its plain computation, float32 with TF32
# off, each list of tensors as a whole (||a - b|| / ||b|| over all its
# tensors together). The two sum in other orders (a global mean from two
# half means, a gradient from two half backwards, cuDNN's algorithm for
# another batch). How far that parts one step of this net, measured on the
# CPU by switching the conv algorithm alone: params 6.2e-5, momentum (the
# update, ill-conditioned at init) 7.2e-3, the fc head's momentum 4.0e-6,
# running statistics 1.5e-7. How far a step on one half of the batch (no
# reduction) parts: 1.0e-2, 0.86, 0.84, 7.6e-3. Each bar sits between
DP_TOL = {"params": 1e-3, "momentum": 1e-1, "fc_momentum": 1e-3,
          "running_stats": 1e-4, "loss": 1e-4}
# dispatch at K=1 against step-sync: one update of an average against the
# average of two updates, the same arithmetic reordered (6.2e-8 on the CPU)
DISPATCH_TOL = {k: 1e-5 for k in DP_TOL}
# bf16 gradient communication against float32: each rank's gradient and
# their sum are rounded to bf16's 8 significant bits, so the update moves
# by at most 2^-7 of itself (cancellation between the ranks aside), and
# by more than nothing
BF16_COMM_TOL = 2.0 ** -7


def deterministic_train(argv):
    """``resnet_tpu_torch.train_resnet.main(argv)`` with cuDNN's and
    cuBLAS's deterministic algorithms and no autotuning, and
    ``torch.use_deterministic_algorithms`` on: every op that has no
    deterministic form warns, naming itself, on this process's output."""
    import os
    import warnings
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    warnings.simplefilter("default")
    from resnet_tpu_torch.train_resnet import main as train_main
    train_main(argv)
    return 0


NONDETERMINISTIC = re.compile(r"UserWarning: (\S+) does not have a "
                              r"deterministic implementation")


def rank_script(only, world, extra=(), timeout=600):
    """Run ``world`` ranks of this script's ``--only only`` (a rank
    program) through ``python -m resnet_tpu_torch.tools.launch -n world``;
    relay their output and return its JSON lines. A failed rank fails the
    launch; past ``timeout`` the launcher is told to stop its ranks. The
    ranks' cuBLAS keeps the fixed workspace its deterministic mode needs
    (``dp_equivalence``)."""
    import os
    import signal
    from resnet_tpu_torch.tools.launch import free_port
    cmd = [sys.executable, "-m", "resnet_tpu_torch.tools.launch", "-n",
           str(world), "--coordinator", f"127.0.0.1:{free_port()}", "--",
           sys.executable, "-u", __file__, "--child", "--only", only, *extra]
    sys.stdout.flush()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=dict(os.environ,
                                     CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGTERM)    # the launcher stops its ranks
        out, _ = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    write_out(out)
    require(proc.returncode == 0,
            f"{only} failed (exit {proc.returncode})")
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def list_gap(xs, ys):
    """||x - y|| / ||y|| over all tensors of two lists together (on the
    CPU: the lists may lie on two devices)."""
    num = den = 0.0
    for x, y in zip(xs, ys):
        x, y = x.detach().double().cpu(), y.detach().double().cpu()
        num += float((x - y).norm() ** 2)
        den += float(y.norm() ** 2)
    return (num / max(den, 1e-300)) ** 0.5


def state_gap(a, b):
    """``list_gap`` of two train states' params, momentum, fc head
    momentum and BN running statistics."""
    fc = [i for i, p in enumerate(b.model.parameters())
          if p is b.model.fc.weight or p is b.model.fc.bias]
    return {"params": list_gap(a.model.parameters(), b.model.parameters()),
            "momentum": list_gap(a.momentum, b.momentum),
            "fc_momentum": list_gap([a.momentum[i] for i in fc],
                                    [b.momentum[i] for i in fc]),
            "running_stats": list_gap(a.model.buffers(), b.model.buffers())}


def metrics_gap(m, want):
    """Relative error of the loss and count sums (a top-1 or top-5 hit may
    flip on a near-tie, so those are printed, not held)."""
    return max(abs(float(m[k]) - float(want[k]))
               / max(abs(float(want[k])), 1e-30)
               for k in ("loss_sum", "count"))


def dp_reference_rank():
    """One rank of ``dp_reference``: a CIFAR ResNet-20, float32 (TF32 off),
    global batch 16 at 32x32, each rank on the one card, joined by gloo.
    The four checks of ``dp_reference_phase``; rank 0 computes each plain
    computation and prints the lines."""
    import datetime
    import os
    import torch.distributed as dist
    from resnet_tpu_torch.config import cifar10_resnet18
    from resnet_tpu_torch.ops.augment import sample_cifar_rows
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.ops.metrics import cross_entropy_loss, metric_sums
    from resnet_tpu_torch.parallel.mesh import replica_block
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    world = int(os.environ["RESNET_TPU_NUM_PROCS"])
    rank = int(os.environ["RESNET_TPU_PROC_ID"])
    # gloo, chosen here and only here: NCCL refuses two ranks on one
    # device. Gloo takes CUDA tensors, staging them through pinned host
    # memory inside its all-reduce
    dist.init_process_group(
        "gloo", init_method=f"tcp://{os.environ['RESNET_TPU_COORDINATOR']}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=300))
    group = dist.group.WORLD
    torch.cuda.set_device(0)
    cfg = cifar10_resnet18()
    cfg.model.depth, cfg.train.batch_size = 20, 16
    n = cfg.train.batch_size
    aug = make_augment_fn(cfg)
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {"image": torch.randint(0, 256, (n, 32, 32, 3), generator=gen,
                                    device="cuda", dtype=torch.uint8),
             "label": torch.randint(0, 10, (n,), generator=gen,
                                    device="cuda"),
             "rows": sample_cifar_rows(gen, cfg.data, n, device="cuda")}
    block = replica_block(n, rank, world)
    mine = {k: v[block] for k, v in batch.items()}
    common = dict(model="cifar_resnet20 f32", batch=n, ranks=world,
                  backend="gloo over CUDA tensors (explicit: NCCL refuses "
                  "two ranks on one device)",
                  device=torch.cuda.get_device_name(0))

    def dp_step(mode, **kw):
        st = create_train_state(cfg, device="cuda",
                                bn_group=group if mode == "jit" else None)
        return make_train_step(augment_fn=aug, group=group, dp_mode=mode,
                               **kw)(st, mine)

    def report(phase, got, want, tol, **fields):
        (st, m), (st_ref, m_ref) = got, want
        gap = dict(state_gap(st, st_ref), loss=metrics_gap(m, m_ref))
        emit(phase=phase, rel_err=gap, tol=tol,
             top1=[float(m["top1_sum"]), float(m_ref["top1_sum"])],
             **fields, **common)
        require(all(gap[k] <= tol[k] for k in tol), f"{phase}: {gap}")

    with full_float32():
        # 1. jit at world size 2 against one step on the global batch
        got = dp_step("jit")
        if rank == 0:
            plain = create_train_state(cfg, device="cuda")
            report("dp_reference_jit", got,
                   make_train_step(augment_fn=aug)(plain, batch), DP_TOL,
                   against="world size 1 on the global batch")
        # 2. shard_map against the halves through the local model, their
        # gradients and BN statistics averaged
        got = dp_step("shard_map")
        if rank == 0:
            states, grads, sums = [], [], []
            for r in range(world):
                half = {k: v[replica_block(n, r, world)]
                        for k, v in batch.items()}
                st = create_train_state(cfg, device="cuda")
                st.model.train()
                logits = st.model(aug(half["image"], None, None,
                                      half["rows"]))
                loss = cross_entropy_loss(logits, half["label"])
                grads.append(torch.autograd.grad(
                    loss, list(st.model.parameters())))
                sums.append(metric_sums(logits, half["label"], loss))
                states.append(st)
            with torch.no_grad():
                for bufs in zip(*(st.model.buffers() for st in states)):
                    bufs[0].copy_(sum(bufs) / world)
            states[0].apply_gradients([sum(g) / world for g in zip(*grads)])
            report("dp_reference_shard_map", got,
                   (states[0], {k: sum(m[k] for m in sums) for k in sums[0]}),
                   DP_TOL, against="halves through the local model, "
                   "gradients and BN statistics averaged")
        # 3. dispatch at K=1 against step-sync
        step_sync = got
        got = dp_step("shard_map", dp_sync="dispatch")
        if rank == 0:
            report("dp_reference_dispatch_k1", got, step_sync, DISPATCH_TOL,
                   against="shard_map step-sync")
        # 4. bf16 gradient communication against float32
        got = dp_step("shard_map", comm_dtype=torch.bfloat16)
        if rank == 0:
            (st, _), (ref, _) = got, step_sync
            ratio = list_gap(st.momentum, ref.momentum)
            emit(phase="dp_reference_bf16_comm", momentum_rel_diff=ratio,
                 tol=BF16_COMM_TOL, against="float32 communication",
                 **common)
            require(0 < ratio <= BF16_COMM_TOL, f"bf16 comm: {ratio}")
    dist.destroy_process_group()


def dp_reference_phase():
    """The data-parallel modes over two ranks on the one card (gloo)
    against plain computations: a ``jit`` step against one step on the
    global batch, a ``shard_map`` step against its halves averaged, a K=1
    ``dispatch`` step against step-sync, bf16 communication against
    float32. Returns the seconds it took."""
    tic = time.perf_counter()
    rank_script("dp_reference_rank", 2)
    return time.perf_counter() - tic


def dp_equivalence(cfg, group):
    """One call of ``cfg``'s step at world size 1 through the data-parallel
    step and through the plain one, from the same seeded state, under
    deterministic algorithms; the plain call twice for its own run-to-run
    gap. Returns (DP vs plain gap, plain vs plain gap, ops that warned)."""
    import warnings
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    k, bs = cfg.train.steps_per_dispatch, cfg.train.batch_size
    gen = torch.Generator(device="cuda").manual_seed(5)
    batch = {"image": torch.randint(0, 256, (k, bs, CANVAS, CANVAS, 3),
                                    generator=gen, device="cuda",
                                    dtype=torch.uint8),
             "label": torch.randint(0, cfg.data.num_classes, (k, bs),
                                    generator=gen, device="cuda"),
             "dims": torch.full((k, bs, 4), CANVAS, dtype=torch.int32,
                                device="cuda")}
    jit = cfg.train.dp_mode == "jit"

    def call(dp):
        state = create_train_state(cfg, device="cuda",
                                   bn_group=group if dp and jit else None)
        step = make_train_step(augment_fn=make_augment_fn(cfg),
                               steps_per_dispatch=k,
                               group=group if dp else None,
                               dp_mode=cfg.train.dp_mode)
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        return state

    prev = torch.are_deterministic_algorithms_enabled()
    with deterministic_cudnn(), warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            plain = call(False)
            dp_gap = max(state_gap(call(True), plain).values())
            plain_gap = max(state_gap(call(False), plain).values())
        finally:
            torch.use_deterministic_algorithms(prev)
    ops = sorted({m.group(1) for m in (NONDETERMINISTIC.search(
        f"UserWarning: {x.message}") for x in w) if m})
    return dp_gap, plain_gap, ops


def allreduce_call_us(group, calls=200):
    """Host microseconds a call of the BatchNorm's all-reduce (two rows of
    256 channels, through ``all_reduce_sum``) takes, and of a clone of the
    same tensor beside it; both end with a synchronize."""
    from resnet_tpu_torch.parallel.dist import all_reduce_sum
    x = torch.zeros(2, 256, device="cuda")
    out = {}
    for name, fn in (("allreduce", lambda: all_reduce_sum(x, group)),
                     ("clone", lambda: x.clone())):
        fn()
        torch.cuda.synchronize()
        tic = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - tic) / calls * 1e6
    return out


def dp_path_rank(remat_img_s):
    """The body of ``dp_path``, one rank under the launcher, NCCL."""
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops.augment_fused import \
        fused_crop_mirror_normalize as k1
    from resnet_tpu_torch.ops.fused_convbn import matmul_with_stats as k2
    from resnet_tpu_torch.parallel.dist import (finalize_distributed,
                                                maybe_init_distributed,
                                                world_group)
    maybe_init_distributed()
    group = world_group()
    backend = torch.distributed.get_backend()
    require(backend == "nccl", f"the DP path runs on {backend}")
    out = {}
    for mode in ("shard_map", "jit"):
        cfg = dp_preset(dp_mode=mode)
        launches, img_s, gib = train_path(
            f"dp_path_{mode}", cfg, 2, {k1: 1}, model=f"resnet{DP_DEPTH}",
            group=group, dp_mode=mode, world_size=1, backend=backend,
            remat=True, remat_path_img_per_s=remat_img_s or "not run",
            note="imagenet_resnet152_dp through the launcher at its "
                 "per-replica width, --num-devices 1 --batch-size 128, "
                 f"depth {DP_DEPTH}")
        dp_gap, plain_gap, ops = dp_equivalence(cfg, group)
        emit(phase=f"dp_path_{mode}_vs_plain", dp_vs_plain_rel_gap=dp_gap,
             plain_run_to_run_rel_gap=plain_gap, bit_equal=dp_gap == 0,
             nondeterministic_ops=ops, card=nvidia_smi_line())
        # at world size 1 every reduction is over one rank and every weight
        # is exactly 1: bit-equal where the plain step repeats bit for bit;
        # else no further apart than two plain runs are
        require(dp_gap == 0 if plain_gap == 0 else dp_gap <= 2 * plain_gap,
                f"dp_path {mode}: {dp_gap} from the plain call, plain runs "
                f"{plain_gap} apart")
        out[mode] = dict(launches=launches[k1], img_per_s=img_s,
                         peak_gib=gib)
    # the fused paths under shard_map: K4f and K4b (chain), K2 (fused)
    paths = {}
    for name, switch, per_step in (
            ("chain", {"unit_chain": "pallas"},
             {k1: 1, fu.matmul_stats: 20, fu.norm_relu_matmul_stats: 16,
              fu.fused_backward: 36}),
            ("fused", {"fused_convbn": True}, {k1: 1, k2: 36})):
        cfg = imagenet_resnet50()
        cfg.train.bn_ema, cfg.train.dp_mode = False, "shard_map"
        for key, value in switch.items():
            setattr(cfg.train, key, value)
        launches, _, _ = train_path(f"dp_{name}_path", cfg, 1, per_step,
                                    group=group, dp_mode="shard_map",
                                    world_size=1, backend=backend)
        paths[f"{name}_launches"] = {w.__name__: n
                                     for w, n in launches.items()}
    emit(phase="dp_path_summary", **{f"{m}_{k}": v for m, d in out.items()
                                     for k, v in d.items()}, **paths,
         host_us_per_call=allreduce_call_us(group),
         remat_path_img_per_s=remat_img_s or "not run",
         card=nvidia_smi_line())
    finalize_distributed()


def dp_path_phase(remat_img_s):
    """``dp_preset`` (imagenet_resnet152_dp's per-replica width at depth
    ``DP_DEPTH``) through the port's launcher at world size 1 over NCCL,
    in both ``dp_mode``s, and
    the chain and fused paths under ``shard_map``. Returns the summary
    line."""
    lines = rank_script("dp_path_rank", 1,
                        ("--main-img-s", str(remat_img_s or 0.0)))
    return next(x for x in lines if x.get("phase") == "dp_path_summary")


def dryrun_phase():
    """``dryrun_multichip(1)``: one rank on the card, NCCL."""
    from resnet_tpu_torch.dryrun import dryrun_multichip
    tic = time.perf_counter()
    sys.stdout.flush()
    dryrun_multichip(1)
    emit(phase="dryrun", ranks=1, device="cuda", backend="nccl",
         seconds=time.perf_counter() - tic)


# ---------------------------------------------------------------------------
# The training-evidence tools (resnet_tpu_torch/tools/)
# ---------------------------------------------------------------------------

BENCH_INPUT_RUNS = (("sequential", ()), ("interleave_4", ("--interleave", "4")))


def bench_input_phase(k1):
    """``bench_input`` at its defaults (ResNet-50 bs64 224, bf16, 512 JPEGs
    of 256x256 in one shard, 4 decode threads), sequential legs and
    ``--interleave 4``: the record path (``RecordIter``, the host queue,
    ``prefetch_to_device``) feeding the train step, K1 counted. Nothing
    else runs beside it. Returns mode -> K1 launches."""
    from resnet_tpu_torch.tools import bench_input
    launches = {}
    for mode, extra in BENCH_INPUT_RUNS:
        args = bench_input.build_parser().parse_args(list(extra))
        k1.launches = 0
        tic = time.perf_counter()
        rec = bench_input.bench(args)
        seconds = time.perf_counter() - tic
        launches[mode] = k1.launches
        # 2 warm-up steps and 1 on the pool, then the timed steps of both
        # legs: an epoch (512 // 64) each, or at least 2 windows of 4
        steps = args.num_images // args.batch_size
        timed = 2 * (max(2, steps // args.interleave) * args.interleave
                     if args.interleave else steps)
        require(launches[mode] == 3 + timed, f"bench_input {mode}: K1 "
                f"launched {launches[mode]} times, expected {3 + timed}")
        require(rec["step_ms_device_data"] > 0
                and rec["step_ms_end_to_end"] > 0
                and math.isfinite(rec["input_overhead"]),
                f"bench_input {mode}: {rec}")
        emit(phase="bench_input", mode=mode, k1_launches=launches[mode],
             **rec, seconds=seconds, card=nvidia_smi_line(),
             device=torch.cuda.get_device_name(0))
    return launches


def convergence_phase():
    """``nightly_convergence`` at its defaults, plain and ``--bn-ema``:
    both must pass its bar (0.98)."""
    from resnet_tpu_torch.tools import nightly_convergence
    for extra in ([], ["--bn-ema"]):
        tic = time.perf_counter()
        rc, out = tool_run(nightly_convergence.main, extra)
        line = out.strip().splitlines()[-1]
        acc = float(re.search(r"val accuracy ([0-9.]+)", line).group(1))
        emit(phase="convergence", bn_ema=bool(extra), val_accuracy=acc,
             bar=0.98, result=line.split(":")[0],
             seconds=time.perf_counter() - tic)
        require(rc == 0 and line.startswith("convergence PASS"),
                f"convergence{' --bn-ema' if extra else ''}: {line}")


def device_parity_phase():
    """``device_parity`` at its defaults: ResNet-20 CIFAR, bs16, float32
    (TF32 off), the CPU against the card from one state and one stream of
    draws; all three gates must pass."""
    from resnet_tpu_torch.tools import device_parity
    tic = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        res = device_parity.parity(device_parity.build_parser().parse_args([]))
    emit(phase="device_parity", **res, seconds=time.perf_counter() - tic)
    require(res["ok"], f"device_parity: {res['gates']}")


EMA_PROBE_RUNS = (("defaults", ()),
                  ("preset_program", ("--clamp", "1", "--warmup", "-2")))
EMA_PROBE_SEEDS = (0, 1, 2, 3)


def ema_probe_phase(k1):
    """``ema_probe`` on the stripe tree built by the port's copy
    (``tools/stripes.py``): depth-18 ResNet, ImageNet stem, 32x32, the
    record pipeline decoding with Pillow on this machine, K1 on the card,
    through ``Solver.fit``. At its defaults (clamp 2, one warmup epoch)
    and at the preset's bn-ema program (clamp 1, two warmup epochs), each
    at seeds 0-3. The tool as a user runs the preset's program (seed 0)
    must beat chance (1/3); the defaults are a point of the JAX package's
    sweep that lands at chance in some seeds, so they are reported, not
    gated."""
    from resnet_tpu_torch.tools import ema_probe
    from resnet_tpu_torch.tools.stripes import build_stripe_tree
    with tempfile.TemporaryDirectory(prefix="stripes_") as root:
        build_stripe_tree(root)
        for run, extra in EMA_PROBE_RUNS:
            for seed in EMA_PROBE_SEEDS:
                args = ema_probe.build_parser().parse_args(
                    ["--data", root, "--seed", str(seed), *extra])
                k1.launches = 0
                tic = time.perf_counter()
                rec = ema_probe.probe(args)
                n = k1.launches
                # 120 records at bs24: 5 steps an epoch, one launch a step
                emit(phase="ema_probe", run=run, seed=seed, **rec,
                     k1_launches=n, seconds=time.perf_counter() - tic)
                require(n == 5 * args.epochs, f"ema_probe {run} seed "
                        f"{seed}: K1 launched {n} times, expected "
                        f"{5 * args.epochs}")
                if run == "preset_program" and seed == 0:
                    require(rec["val_accuracy"] > 1 / 3,
                            f"ema_probe {run}: at chance {rec}")


# the JAX CI rung's gates (tests/test_real_digits.py): seed 0, 10 epochs
EMA_EQUIVALENCE_ARGV = ("--seeds", "0", "--epochs", "10")
EMA_EQUIVALENCE_BAR = 0.8       # each mode's val accuracy, at least
EMA_EQUIVALENCE_DIFF = 0.06     # the two modes' accuracies, at most apart
EMA_EQUIVALENCE_GAP = 0.05      # bn-ema's eval-consistency gap, at most


def ema_equivalence_phase():
    """``ema_equivalence`` at the JAX CI rung (one seed, 10 epochs, both BN
    programs through the record pipeline), its digits built from the
    committed scans (no sklearn on this machine), in float32 with
    deterministic algorithms as the tool runs (so every run of this phase
    gives the same accuracies): each mode at least 0.8, the two within
    0.06, bn-ema's eval-consistency gap at most 0.05."""
    from resnet_tpu_torch.tools import ema_equivalence
    tic = time.perf_counter()
    rc, out = tool_run(ema_equivalence.main, list(EMA_EQUIVALENCE_ARGV))
    lines = [json.loads(line) for line in out.splitlines()
             if line.startswith("{")]
    rows = {r["mode"]: r for r in lines if "mode" in r}
    full, ema = rows["full_batch_bn"], rows["bn_ema"]
    diff = abs(ema["val_accuracy"] - full["val_accuracy"])
    emit(phase="ema_equivalence", rows=list(rows.values()),
         summary=lines[-1]["summary"], acc_diff=diff,
         gates=dict(bar=EMA_EQUIVALENCE_BAR, diff=EMA_EQUIVALENCE_DIFF,
                    ema_gap=EMA_EQUIVALENCE_GAP),
         digits=("sklearn" if importlib.util.find_spec("sklearn")
                 else "digits_8x8.npz"),
         backend=ema_equivalence.REPRODUCIBLE_OPTS,
         seconds=time.perf_counter() - tic)
    require(rc == 0 and full["val_accuracy"] >= EMA_EQUIVALENCE_BAR
            and ema["val_accuracy"] >= EMA_EQUIVALENCE_BAR, f"{rows}")
    require(diff <= EMA_EQUIVALENCE_DIFF, f"accuracies {diff} apart")
    require(ema["eval_consistency_gap"] <= EMA_EQUIVALENCE_GAP,
            f"bn-ema's eval gap {ema['eval_consistency_gap']}")


# ---------------------------------------------------------------------------
# The audit tools (resnet_tpu_torch/tools/, utils/op_count.py) and the
# compile-check entry (dryrun.entry)
# ---------------------------------------------------------------------------

# the card's bf16 forward against the CPU's from the same weights: each
# rounds every layer's output to bf16 with its own algorithms; bf16
# against float32 on the CPU parts the logits of this randomly initialised
# net by 0.4% of their largest magnitude
ENTRY_TOL = 2e-2
ENTRY_CHECK_BATCH = 2


def entry_phase():
    """``dryrun.entry()``: ResNet-50 bf16 in eval mode with zeros of
    (16, 224, 224, 3) on the card; its forward on them gives finite
    (16, 1000) logits, and on a random batch of ``ENTRY_CHECK_BATCH``
    equals the CPU forward of a copy of the model to ``ENTRY_TOL`` of the
    largest logit."""
    import numpy as np
    from resnet_tpu_torch.dryrun import entry
    tic = time.perf_counter()
    fn, (model, x) = entry()
    out = fn(model, x)
    x_rand = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (ENTRY_CHECK_BATCH, *x.shape[1:])).astype(np.float32))
    got = fn(model, x_rand.cuda()).cpu()
    want = fn(copy.deepcopy(model).cpu(), x_rand)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    emit(phase="entry", model="resnet50", dtype=str(model.dtype),
         training=model.training, x_shape=list(x.shape),
         x_device=str(x.device), logits_shape=list(out.shape),
         logits_dtype=str(out.dtype), check_batch=ENTRY_CHECK_BATCH,
         max_abs_err_vs_cpu=err, max_abs_logit=scale,
         tol_of_max=ENTRY_TOL, seconds=time.perf_counter() - tic)
    require(tuple(out.shape) == (16, 1000) and bool(out.isfinite().all())
            and x.device.type == "cuda" and not model.training,
            "entry's forward on the card")
    require(err <= ENTRY_TOL * max(1.0, scale),
            f"entry: card and CPU forwards {err} apart (largest {scale})")
    del model, x, out
    torch.cuda.empty_cache()


COST_VARIANTS = ("off", "xla", "pallas")
COST_FLOPS_TOL = 0.01


def cost_probe_phase():
    """``cost_probe`` at its defaults: one bs256 ResNet-50 bf16 step of
    each ``unit_chain`` variant with K1 as the augmenter, counted. The
    ``off`` variant's convolution and matmul FLOPs equal the network's
    analytic 2·MAC count, forward and backward, within 1%; the other two
    variants' FLOPs equal ``off``'s within 1% (the same math); K1 launches
    once in each, K4f 36 and K4b 36 times in ``pallas``. Returns the
    launches by variant and kernel."""
    from resnet_tpu_torch.tools import cost_probe
    recs = {}
    for variant in COST_VARIANTS:
        tic = time.perf_counter()
        rec, = cost_probe.probe(cost_probe.build_parser().parse_args(
            ["--variants", variant]))
        recs[variant] = rec
        emit(phase="cost_probe", **rec, card=nvidia_smi_line(),
             seconds=time.perf_counter() - tic)
        torch.cuda.empty_cache()
    off = recs["off"]
    require(abs(off["conv_mm_over_analytic"] - 1) <= COST_FLOPS_TOL,
            f"cost_probe off: conv/matmul FLOPs {off['conv_mm_flops']} "
            f"against the analytic {off['analytic_conv_mm_flops']}")
    for variant in ("xla", "pallas"):
        require(abs(recs[variant]["flops"] / off["flops"] - 1)
                <= COST_FLOPS_TOL, f"cost_probe {variant}: "
                f"{recs[variant]['flops']} FLOPs against off's "
                f"{off['flops']}")
    launches = {v: r["kernel_launches"] for v, r in recs.items()}
    require(all(ks.get("fused_crop_mirror_normalize") == 1
                for ks in launches.values()), f"K1: {launches}")
    pallas = launches["pallas"]
    require(pallas.get("matmul_stats", 0)
            + pallas.get("norm_relu_matmul_stats", 0) == 36
            and pallas.get("fused_backward") == 36, f"K4f/K4b: {pallas}")
    return launches


POD_WORLD, POD_ALLREDUCES_JIT = 16, 466
POD_RATIO_BAND = (0.9, 1.2)


def pod_probe_phase():
    """``pod_compile_probe`` at ``imagenet_resnet152_dp`` (ResNet-152,
    bf16, bn-ema, remat, s2d stem fed by K1), bs128 a rank, as rank 0 of a
    16-rank fake group, one step a call, in both DP modes: the peak GiB a
    card, the all-reduces and their bytes. ``shard_map``'s all-reduce
    bytes over the parameters' lie in 0.9-1.2 (the JAX test's band); under
    ``jit`` the all-reduce calls a step are the 466 that ``dp_path``
    counted at depth 152 on an H100. Returns mode -> K1 launches."""
    from resnet_tpu_torch.tools import pod_compile_probe
    out = {}
    for mode in ("shard_map", "jit"):
        tic = time.perf_counter()
        rec = pod_compile_probe.probe(pod_compile_probe.build_parser()
                                      .parse_args([
            "--preset", "imagenet_resnet152_dp", "--world-size",
            str(POD_WORLD), "--spd", "1", "--dp-mode", mode]))
        rec.pop("not_applicable")
        buckets = rec.pop("allreduce_bucket_bytes")
        emit(phase="pod_probe", **rec, largest_buckets=buckets[:8],
             card=nvidia_smi_line(), seconds=time.perf_counter() - tic)
        require(rec["depth"] == 152 and rec["remat"], f"pod_probe {mode}")
        if mode == "shard_map":
            lo, hi = POD_RATIO_BAND
            require(lo <= rec["allreduce_bytes_over_param_bytes"] <= hi,
                    f"shard_map all-reduce bytes over param bytes "
                    f"{rec['allreduce_bytes_over_param_bytes']}")
        else:
            require(rec["n_allreduce_buckets"] == POD_ALLREDUCES_JIT,
                    f"jit: {rec['n_allreduce_buckets']} all-reduces a step, "
                    f"not {POD_ALLREDUCES_JIT}")
        out[mode] = rec["kernel_launches"].get("fused_crop_mirror_normalize",
                                               0)
        require(out[mode] == 1, f"pod_probe {mode}: K1 {out[mode]}")
        torch.cuda.empty_cache()
    return out


def serving_pod_probe_phase(tmp):
    """``serving_pod_probe`` on the two-device artifact ``serve`` exported
    from fit_path's checkpoint (ResNet-50 at the preset): no collective in
    its graph; one copy's peak GiB and FLOPs on this card at the serving
    batch (128)."""
    import os
    from resnet_tpu_torch.tools import serving_pod_probe
    tic = time.perf_counter()
    art = os.path.join(tmp, "artifacts", "two")
    rec = serving_pod_probe.probe(serving_pod_probe.build_parser()
                                  .parse_args(["--artifact", art]))
    emit(phase="serving_pod_probe", **rec, card=nvidia_smi_line(),
         seconds=time.perf_counter() - tic)
    require(rec["num_devices"] == 2, f"serving_pod_probe {rec}")
    require(rec["collective_free"], f"collectives {rec}")
    require(rec["finite_logits"] and rec["logits_shape"] == [128, 1000],
            f"serving_pod_probe logits {rec['logits_shape']}")


def quant_probe_phase():
    """``quant_probe`` at its defaults: int8 against bf16 on the three
    ResNet-50 serving shapes, 3 windows of 30 calls; every int8 result
    exact on its sampled block."""
    from resnet_tpu_torch.tools import quant_probe
    tic = time.perf_counter()
    recs = quant_probe.probe(quant_probe.build_parser().parse_args([]))
    card = nvidia_smi_line()
    for rec in recs:
        emit(phase="quant_probe", **rec, card=card)
    emit(phase="quant_probe_summary", cases=len(recs),
         seconds=time.perf_counter() - tic)
    require(all(r["int8_exact"] for r in recs), "an int8 result is not "
            "exact")
    torch.cuda.empty_cache()


def aug_fusion_probe_phase(k1):
    """``aug_fusion_probe`` at its defaults (bs128, 50 calls after 5): the
    fused K1 + the s2d stem, K1's split launch alone, the plain version +
    the stem; the kernels and ops between the augmenter and the stem's
    convolution. Returns K1's launches."""
    from resnet_tpu_torch.tools import aug_fusion_probe
    tic = time.perf_counter()
    k1.launches = 0
    rec = aug_fusion_probe.probe(aug_fusion_probe.build_parser().parse_args(
        []))
    launches = k1.launches
    emit(phase="aug_fusion_probe", **rec, k1_launches=launches,
         card=nvidia_smi_line(), seconds=time.perf_counter() - tic)
    for name in ("A_fused_aug_plus_s2d_stem", "C_plain_aug_plus_s2d_stem"):
        require(rec[name]["stem_conv_found"]
                and rec[name]["n_kernels_between"] > 0,
                f"{name}: no stem conv, or no kernel before it, in the trace")
    # A and B: 5 + 50 timed calls each, and A's counted and traced calls
    require(launches == 2 * 55 + 2, f"aug_fusion_probe: K1 {launches}")
    torch.cuda.empty_cache()
    return launches


def build_phase():
    from resnet_tpu_torch import _build
    tic = time.perf_counter()
    libs = _build.build_all()
    seconds = time.perf_counter() - tic
    usage = {}
    for name in libs:
        log = _build.build_log(name)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        usage[name] = dict(kernels=len(regs), max_registers=max(regs, default=None),
                           spill_store_bytes=sum(spills))
    emit(phase="build", seconds=seconds,
         libraries=sorted(p.name for p in libs.values()), ptxas=usage)
    # the matrix kernels run 384 threads, one block an SM, so ptxas gives a
    # thread at most 168 registers (65,536 / 384; the consumers' 64-128
    # accumulators and their epilogue live in those); a spill would put
    # accumulators or epilogue values through local memory
    for name in ("matmul_stats", "matmul_stats_bwd"):
        require(usage[name]["kernels"] > 0 and
                usage[name]["spill_store_bytes"] == 0,
                f"{name}: {usage[name]} (spill stores in the build log)")


FIT_PHASES = ("fit", "serve", "serving_pod_probe")
# the probes that time the card, in a process of their own with nothing
# beside it: in this script's process, after the profiled calls above,
# aug_fusion_probe's trace lost the links from the stem's kernels to their
# ops on an H100, as mm_timing's windows lost kernels
PROBE_CHILD = ("quant_probe", "aug_fusion_probe")
# what the training-evidence tools report is agreement and accuracy, not
# speed: child processes beside the untimed block, of about equal length
# (one would outlast the block)
EVIDENCE_CHILDREN = (("convergence",), ("device_parity", "ema_probe"),
                     ("ema_equivalence",))


def child_phases(phases, main_img_s=None):
    """Run ``phases`` in a fresh process of this script, relay its output,
    and return the JSON objects it printed.

    ``mm_timing`` and the entry point's phases run last, each in a process
    of its own. In four full runs of this script in one process on the
    card, ``mm_timing``'s profiled windows lost kernels every time, with or
    without the fit phases before it; alone, or right after the trace
    probe, it passed. And after ``mm_timing`` a process's host is slower
    (``main``'s comment on it), which the fit loop's img/s would read."""
    cmd = [sys.executable, "-u", __file__, "--only", ",".join(phases),
           "--child", "--main-img-s", str(main_img_s or 0.0)]
    sys.stdout.flush()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            write_out(line)
            lines.append(line)
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    sys.stdout.flush()
    require(rc == 0, f"the phases {phases} failed (exit {rc})")
    return [json.loads(line) for line in lines if line.startswith("{")]


def run_child(only, main_img_s):
    """The body of a ``child_phases`` process, or of one rank of
    ``rank_script`` (``main_img_s`` is then remat_path's img/s)."""
    if "dp_reference_rank" in only:
        dp_reference_rank()
        return 0
    if "dp_path_rank" in only:
        dp_path_rank(main_img_s)
        return 0
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.ops.augment_fused import \
        fused_crop_mirror_normalize as k1
    if "convergence" in only:
        CLOCK.begin("convergence")
        convergence_phase()
    if "device_parity" in only:
        CLOCK.begin("device_parity")
        device_parity_phase()
    if "ema_probe" in only:
        CLOCK.begin("ema_probe")
        ema_probe_phase(k1)
    if "ema_equivalence" in only:
        CLOCK.begin("ema_equivalence")
        ema_equivalence_phase()
    if "quant_probe" in only:
        CLOCK.begin("quant_probe")
        quant_probe_phase()
    if "aug_fusion_probe" in only:
        CLOCK.begin("aug_fusion_probe")
        aug_fusion_probe_phase(k1)
    if "mm_timing" in only:
        CLOCK.begin("mm_timing")
        full = imagenet_resnet50()
        full.train.bn_ema = False
        ops_a, ops_b, _ = r50_op_shapes(get_model(full), BATCH, OUT)
        emit(phase="mm_step_ms", step_ms=time_matmul_kernels(ops_a, ops_b))
    require("serve" not in only or "fit" in only,
            "serve reads fit's checkpoint: run --only fit,serve")
    require("serving_pod_probe" not in only or "serve" in only,
            "serving_pod_probe reads serve's artifact: run --only "
            "fit,serve,serving_pod_probe")
    if "fit" in only:
        # serve reads fit's checkpoints from the directory they share
        with trace_dir() as tmp:
            CLOCK.begin("fit")
            fit_path_phase(main_img_s, tmp)
            if "serve" in only:
                CLOCK.begin("serve")
                serve_phase(tmp)
            if "serving_pod_probe" in only:
                CLOCK.begin("serving_pod_probe")
                serving_pod_probe_phase(tmp)
    CLOCK.begin("end")
    emit(phase="child_timing", seconds_by_phase=CLOCK.totals,
         seconds=sum(CLOCK.totals.values()))
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--deterministic-train"]:
        # fit_resume's CLI processes: the training entry point itself
        return deterministic_train(argv[1:])
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="comma-separated phases "
                        "to run after the build (default: all)")
    # a process of child_phases
    parser.add_argument("--child", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--main-img-s", type=float, default=0.0,
                        help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    only = set(filter(None, args.only.split(",")))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    if args.child:
        return run_child(only, args.main_img_s)
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops.augment_fused import \
        fused_crop_mirror_normalize as k1
    from resnet_tpu_torch.ops.fused_chain import \
        normalized_matmul_with_stats as k3
    from resnet_tpu_torch.ops.fused_convbn import matmul_with_stats as k2

    def selected(phase):
        return not only or phase in only

    def on(phase):
        """Whether ``phase`` runs; if it does, its clock starts."""
        if selected(phase):
            CLOCK.begin(phase)
            return True
        return False

    CLOCK.begin("card")
    card = nvidia_smi_line()
    print(card, flush=True)
    sms, mhz, rate = lane_ops_per_s()
    emit(phase="card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, sms=sms, sm_clock_max_mhz=mhz,
         float32_lane_ops_per_s=rate)
    CLOCK.begin("build")
    build_phase()
    CLOCK.begin("r50_shapes")

    cfg = imagenet_resnet50()                      # the preset: bn-ema
    full = imagenet_resnet50()                     # full-batch BN
    full.train.bn_ema = False
    chain, fused = copy.deepcopy(full), copy.deepcopy(full)
    chain.train.unit_chain = "pallas"
    fused.train.fused_convbn = True
    ops_a, ops_b, _ = r50_op_shapes(get_model(full), BATCH, OUT)
    emit(phase="r50_shapes", op_a=len(ops_a), op_b=len(ops_b),
         distinct_a=sorted(set(ops_a), reverse=True),
         distinct_b=sorted(set(ops_b), reverse=True))
    require((len(ops_a), len(ops_b)) == (20, 16), "ResNet-50 has 20 op-A "
            "and 16 op-B 1x1 convs")

    if on("k1"):
        k1_worst = check_augment_kernel(cfg)
        k1_time = augment_timing(cfg)
    if on("k1_split"):
        augment_split(cfg)
    if on("mm_check"):
        with full_float32():
            fwd_worst = check_forward_kernels(ops_a, ops_b)
            bwd_worst = check_backward_kernel(ops_a, ops_b)
    if on("k3_path"):
        k3_launches = k3_path(ops_b)
    if on("k5_check"):
        k5_worst = check_k5()
    if on("reduce_probe"):
        k5_probe = reduce_probe_phase()
    if on("rotate_check"):
        rotate_check_phase(cfg)
    main_img_s = None
    if on("main"):
        main_l, main_img_s, _ = train_path("main_path", cfg, 3, {k1: 1},
                                           eval_after=True)
    if on("chain"):
        chain_l, _, _ = train_path("chain_path", chain, 3, {
            k1: 1, fu.matmul_stats: 20, fu.norm_relu_matmul_stats: 16,
            fu.fused_backward: 36})
    if on("fused"):
        fused_l, _, _ = train_path("fused_path", fused, 3, {k1: 1, k2: 36})
    if on("fullbatch"):
        train_path("fullbatch_path", full, 2, {k1: 1})
    # the rest of the model family: ResNeXt-50 32x4d at the preset (the
    # grouped 3x3s block-diagonal, two groups a block) and through cuDNN's
    # grouped convolution, CIFAR ResNet-18 (no kernel), the
    # imagenet_resnet152_dp share at DP_DEPTH with and without remat
    if on("resnext"):
        resnext_l, _, _ = train_path("resnext_path", resnext_cfg(), 3,
                                     {k1: 1}, eval_after=True,
                                     model="resnext50_32x4d",
                                     grouped_dense=True, grouped_merge=2)
    if on("resnext_grouped"):
        train_path("resnext_grouped_path", resnext_cfg(False), 2, {k1: 1},
                   model="resnext50_32x4d", grouped_dense=False)
    if on("cifar"):
        from resnet_tpu_torch.config import cifar10_resnet18
        train_path("cifar_path", cifar10_resnet18(), 20, {}, eval_after=True,
                   model="cifar_resnet18", absent=(k1,))
    remat_img_s = None
    if on("remat"):
        remat_img_s = remat_path_phase(k1)
    if on("k1_split_mode"):
        split_time = k1_split_mode_phase(cfg)
        split_cfg = copy.deepcopy(cfg)
        split_cfg.data.augment_impl = "pallas-split"
        split_l, _, _ = train_path(
            "split_path", split_cfg, 2, {k1: 1}, augment_impl="pallas-split",
            main_path_img_per_s=main_img_s)
    if on("trace_probe"):
        trace_probe_phase()
    if on("bench_input"):
        bench_input_launches = bench_input_phase(k1)
    # data parallelism, each in processes of its own: the
    # imagenet_resnet152_dp path at world size 1 over NCCL, two gloo ranks
    # on the card, the dry run
    if on("dp_path"):
        dp = dp_path_phase(remat_img_s)
    # the untimed phases, side by side: fit_resume's CLI processes, the
    # rank processes of dp_reference and dryrun, and the child processes of
    # the training-evidence tools from threads, the float32 reference steps
    # and prefetch_check in this one. Nothing here is timed, and each line
    # carries its own seconds (the children's phases: their child_timing
    # lines);
    # the timing line counts the block as the phases of this thread and
    # "untimed_wait"
    side = ThreadPoolExecutor(6)
    untimed = {name: side.submit(fn) for name, fn in (
        ("fit_resume", fit_resume_phase), ("dp_reference", dp_reference_phase),
        ("dryrun", dryrun_phase)) if selected(name)}
    for phases in EVIDENCE_CHILDREN:
        phases = [p for p in phases if selected(p)]
        if phases:
            untimed[phases[-1]] = side.submit(child_phases, phases)
    if on("reference"):
        reference_check("reference_check")
    if on("chain_reference"):
        reference_check("chain_reference_check", bn_ema=False,
                        unit_chain="pallas")
    if on("fused_reference"):
        reference_check("fused_reference_check", bn_ema=False,
                        fused_convbn=True)
    # 16 images: the statistics of bn_subsample=8 come from two of them
    if on("subsample_reference"):
        reference_check("subsample_reference_check", n=16, bn_ema=False,
                        bn_subsample=8)
    if on("grouped_reference"):
        reference_check("grouped_reference_check", n=16, bn_ema=False,
                        bn_subsample=8, bn_grouped=True)
    if on("resnext_reference"):
        reference_check("resnext_reference", preset="imagenet_resnext50")
    if on("v2_reference"):
        reference_check("v2_reference", model_overrides=dict(version=2),
                        aug_s2d=False)
    if on("cifar_reference"):
        reference_check("cifar_reference", preset="cifar10_resnet18",
                        data_overrides=dict(image_shape=(32, 32, 3)))
    if on("mask_pool_reference"):
        reference_check("mask_pool_reference", pool_grad="mask")
    if on("remat_reference"):
        remat_reference_phase()
    if on("prefetch"):
        prefetch_check_phase(cfg)
    # what the audit tools count does not depend on the time it takes
    if on("entry"):
        entry_phase()
    if on("cost_probe"):
        cost_launches = cost_probe_phase()
    if on("pod_probe"):
        pod_launches = pod_probe_phase()
    CLOCK.begin("untimed_wait")
    try:
        done = {name: fut.result() for name, fut in untimed.items()}
    finally:
        side.shutdown()
    # last, in processes of their own (child_phases): mm_timing's
    # per-shape profiled windows leave the host slower for the rest of the
    # process (the bn-ema path's calls took 0.87 s instead of 0.67 after
    # them, on the card), which the paths' wall times above would read
    if on("mm_timing"):
        step_ms = next(line["step_ms"] for line in child_phases(["mm_timing"])
                       if line.get("phase") == "mm_step_ms")
    probes = [p for p in PROBE_CHILD if selected(p)]
    if probes:
        CLOCK.begin("probe_child")
        aug_fusion_launches = next(
            (line["k1_launches"] for line in child_phases(probes)
             if line.get("phase") == "aug_fusion_probe"), 0)
    fit_phases = [p for p in FIT_PHASES if selected(p)]
    if fit_phases:
        CLOCK.begin("fit_child")
        child_phases(fit_phases, main_img_s)
    CLOCK.begin("end")
    emit(phase="timing", seconds_by_phase=CLOCK.totals,
         seconds=sum(CLOCK.totals.values()))

    if not only:
        def mm_kernel(name, source, replaces, launches, err, t):
            return dict(name=name, route="cuda",
                        source=f"resnet_tpu_torch/csrc/{source}",
                        replaces=replaces, launches=launches,
                        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                        library_ms=None)
        kernels = [
            # launches, max_abs_err, ms, plain_ms and bound_ms: the main
            # path's fused mode; the launches on resnext_path (the same
            # mode) and in split mode (identity normalization, float32,
            # the split_path), and split mode's error in raw 0-255 pixel
            # units, in fields of their own
            dict(name="fused_crop_mirror_normalize", route="cuda",
                 source="resnet_tpu_torch/csrc/augment.cu",
                 replaces="resnet_tpu/ops/augment_pallas.py:105",
                 launches=main_l[k1], max_abs_err=k1_worst,
                 ms=k1_time["ms"],
                 plain_ms=k1_time["plain_ms"], bound_ms=k1_time["bound_ms"],
                 bound_by=k1_time["bound_by"], library_ms=None,
                 resnext_path_launches=resnext_l[k1],
                 split_mode_launches=split_l[k1],
                 dp_path_launches={m: dp[f"{m}_launches"]
                                   for m in ("shard_map", "jit")},
                 bench_input_launches=bench_input_launches,
                 ema_probe_launches={
                     line["run"]: line["k1_launches"]
                     for line in done["ema_probe"]
                     if line.get("phase") == "ema_probe"
                     and line["seed"] == 0},
                 cost_probe_launches={
                     v: ks["fused_crop_mirror_normalize"]
                     for v, ks in cost_launches.items()},
                 pod_probe_launches=pod_launches,
                 aug_fusion_probe_launches=aug_fusion_launches,
                 split_mode_max_abs_err=split_time["max_abs_err"]),
            # ms, plain_ms and bound_ms of the next four: sums over the
            # launches of one ResNet-50 step at batch 128, bf16
            dict(mm_kernel("matmul_with_stats", "matmul_stats.cu",
                           "resnet_tpu/ops/fused_convbn.py:33", fused_l[k2],
                           fwd_worst["k2"], step_ms["k2"]),
                 dp_fused_path_launches=dp["fused_launches"][
                     "matmul_with_stats"]),
            mm_kernel("normalized_matmul_with_stats", "matmul_stats.cu",
                      "resnet_tpu/ops/fused_chain.py:33", k3_launches,
                      fwd_worst["k3"], step_ms["k3"]),
            dict(mm_kernel("matmul_stats+norm_relu_matmul_stats",
                           "matmul_stats.cu",
                           "resnet_tpu/ops/fused_unit.py:71",
                           chain_l[fu.matmul_stats]
                           + chain_l[fu.norm_relu_matmul_stats],
                           fwd_worst["k4f"], step_ms["k4f"]),
                 dp_chain_path_launches=(
                     dp["chain_launches"]["matmul_stats"]
                     + dp["chain_launches"]["norm_relu_matmul_stats"]),
                 cost_probe_launches=(
                     cost_launches["pallas"]["matmul_stats"]
                     + cost_launches["pallas"]["norm_relu_matmul_stats"])),
            dict(mm_kernel("fused_backward", "matmul_stats_bwd.cu",
                           "resnet_tpu/ops/fused_unit.py:138",
                           chain_l[fu.fused_backward], bwd_worst,
                           step_ms["k4b"]),
                 dp_chain_path_launches=dp["chain_launches"][
                     "fused_backward"],
                 cost_probe_launches=cost_launches["pallas"][
                     "fused_backward"]),
            # ms, plain_ms, bound_ms and library_ms: sums over the reduce
            # probe's 8 shapes, bf16
            dict(name="cuda_sums", route="cuda",
                 source="resnet_tpu_torch/csrc/bn_sums.cu",
                 replaces="tools/reduce_probe.py:62",
                 launches=k5_probe["launches"], max_abs_err=k5_worst,
                 ms=k5_probe["ms"], plain_ms=k5_probe["plain_ms"],
                 bound_ms=k5_probe["bound_ms"], bound_by="bytes",
                 library_ms=k5_probe["library_ms"]),
        ]
        require(all(kern["launches"] > 0 for kern in kernels),
                "a kernel of the paths was launched no time")
        print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
