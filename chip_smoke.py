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
last the fused 1x1-conv kernels' timings at every ResNet-50 shape, with
each kernel apart from the wrapper's partial sums from a profiled window
a shape. Each
phase prints one JSON line; a failed check raises and the script exits
non-zero. The last lines are the kernels line, the card's ``nvidia-smi``
name and power limit, and ``{"ok": true, "device": {...}}``. Imports
nothing of JAX or of the JAX package.

``--only PHASE[,PHASE...]`` runs a subset after the build (for work on one
kernel); with no arguments every phase runs.
"""

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import tempfile
import time

import torch

CANVAS, OUT, BATCH = 256, 224, 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
BF16_OPS_PER_S = 989e12            # H100 SXM, dense bf16 on the tensor cores
# float32 operations per output pixel of the augmentation kernel with HSL
# on, counted from csrc/augment.cu (each add, multiply, divide, min, max,
# abs, floor, compare and floor-mod one): coordinates 18 + 21, the 2x2
# interpolation of three channels 27, the HSL round-trip 79, normalize 6
AUG_OPS_PER_PIXEL = 151
# tolerances of the kernel against its plain version (HSL on): the CPU
# tests' bar, atol 5e-2 / rtol 1e-4 in float32; in bf16 one bf16 ulp more
# (2^-7 relative), since the two may round on either side of a boundary
TOL = {torch.float32: (5e-2, 1e-4), torch.bfloat16: (5e-2, 2.0 ** -7)}


def emit(**fields):
    print(json.dumps(fields), flush=True)


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
               out=OUT):
    """Canvases (a third letterboxed, zero beyond their extent) and the
    (n, 12) rows the port's samplers draw for them."""
    from resnet_tpu_torch.ops.augment import sample_boxes_canvas
    from resnet_tpu_torch.ops.augment_fused import (augment_rows,
                                                    sample_photometric)
    dev = gen.device
    dims = torch.full((n, 4), canvas_side, dtype=torch.int32, device=dev)
    lb = torch.arange(n, device=dev) % 3 == 0
    orig = torch.randint(160, 640, (n, 2), generator=gen, device=dev)
    scale = canvas_side / orig.max(dim=1).values.float()
    eff = torch.round(orig.float() * scale[:, None]).clamp_max(canvas_side)
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
    rows = augment_rows(boxes, flip, (dims[:, 2], dims[:, 3]), ph, n,
                        (canvas_side, canvas_side), device=dev)
    return canvas, rows, data


def touched_canvas_bytes(rows, sh, sw, oh, ow):
    """Canvas bytes the kernel must read for these rows: per image, the
    source rows times the source columns that carry a non-zero tap weight
    (the kernel's own coordinate arithmetic), three bytes a pixel."""
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
    r = taps(rows[:, 0], rows[:, 2], rows[:, 5], oh, sh)
    c = taps(rows[:, 1], rows[:, 3], rows[:, 6], ow, sw)
    return int((r * c).sum()) * 3


def check_augment_kernel(cfg):
    """K1 against its plain version at the training shapes."""
    from resnet_tpu_torch.ops.augment import space_to_depth
    from resnet_tpu_torch.ops.augment_fused import (
        fused_crop_mirror_normalize as k1,
        fused_crop_mirror_normalize_reference as k1_plain)
    from resnet_tpu_torch.utils.profiler import cuda_median_ms
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    for contrast_illum in (False, True):
        canvas, rows, data = aug_inputs(cfg.data, gen, BATCH, contrast_illum)
        flags = dict(hsl=True, contrast=contrast_illum, illum=contrast_illum)
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
                emit(phase="k1_check", dtype=str(dtype), s2d=s2d,
                     contrast_illum=contrast_illum, max_abs_diff=err,
                     atol=atol, rtol=rtol, out_of_tolerance=bad)
                require(bad == 0, "augmentation kernel disagrees with its "
                        "plain version")
                worst = max(worst, err)
                outs[s2d] = got
            require(torch.equal(outs[True], space_to_depth(outs[False])),
                    "s2d output is not a bitwise regroup of the standard")
            emit(phase="k1_s2d_regroup", dtype=str(dtype),
                 contrast_illum=contrast_illum, bitwise=True)

    # time at the main path's setting: bf16, s2d, HSL on, no contrast
    canvas, rows, data = aug_inputs(cfg.data, gen, BATCH, False)
    args = (canvas, rows, (OUT, OUT), data.mean_rgb, data.std_rgb,
            torch.bfloat16)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda").zero_
    ms = cuda_median_ms(lambda: k1(*args, s2d=True, hsl=True), flush=flush)
    plain_ms = cuda_median_ms(lambda: k1_plain(*args, s2d=True, hsl=True),
                              flush=flush)
    read = touched_canvas_bytes(rows, CANVAS, CANVAS, OUT, OUT)
    moved = read + rows.numel() * 4 + BATCH * OUT * OUT * 3 * 2
    ops = AUG_OPS_PER_PIXEL * BATCH * OUT * OUT
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                  bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                  bytes=moved, canvas_bytes_read=read,
                  full_canvas_bytes=canvas.numel(), operations=ops,
                  bytes_bound_ms=bytes_ms, ops_bound_ms=ops_ms)
    emit(phase="k1_timing", runs=25, **timing)
    return worst, timing


def reference_check(phase, n=8, **train_overrides):
    """One float32 train step of full-width ResNet-50 on a small input
    (``n`` images), on the card (through the kernels) and on the CPU
    (through their plain versions) from the same weights and rows: the CPU
    path is the one the tests hold against the JAX package.
    ``train_overrides`` set fields of ``cfg.train`` (the execution-path and
    BatchNorm switches)."""
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    cfg = imagenet_resnet50()
    cfg.train.dtype = "float32"
    cfg.data.image_shape = (96, 96, 3)
    for name, value in train_overrides.items():
        setattr(cfg.train, name, value)
    gen = torch.Generator(device="cuda").manual_seed(1)
    canvas, rows, _ = aug_inputs(cfg.data, gen, n, False, canvas_side=112,
                                 out=96)
    batch = {"image": canvas,
             "label": torch.randint(0, 1000, (n,), generator=gen,
                                    device="cuda"),
             "rows": rows}
    results = {}
    with full_float32():
        for dev in ("cpu", "cuda"):
            state = create_train_state(cfg, device=dev)
            step = make_train_step(augment_fn=make_augment_fn(cfg))
            state, m = step(state, {k: v.to(dev) for k, v in batch.items()})
            results[dev] = (float(m["loss_sum"]), state)
    (loss_cpu, st_cpu), (loss_gpu, st_gpu) = results["cpu"], results["cuda"]

    def rel(xs, ys):
        """||x - y|| / ||y|| over all tensors of a list together."""
        num = den = 0.0
        for x, y in zip(xs, ys):
            x, y = x.detach().double().cpu(), y.detach().double().cpu()
            num += float((x - y).norm() ** 2)
            den += float(y.norm() ** 2)
        return (num / den) ** 0.5

    mom_err = rel(st_gpu.momentum, st_cpu.momentum)
    head = [i for i, p in enumerate(st_cpu.model.parameters())
            if p is st_cpu.model.fc.weight]
    head_err = rel([st_gpu.momentum[i] for i in head],
                   [st_cpu.momentum[i] for i in head])
    stats_err = rel(list(st_gpu.model.buffers()), list(st_cpu.model.buffers()))
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    emit(phase=phase, model="resnet50 f32", batch=n,
         image=list(cfg.data.image_shape), switches=train_overrides,
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


def time_matmul_kernels(ops_a, ops_b):
    """Each distinct ResNet-50 shape, forward and backward, bf16: the
    kernel, its plain version, the bound, and ``torch.mm`` on the bare
    product(s) as context; and from one profiled window each, the forward
    kernel apart from the wrapper's ``psum.sum`` and the backward's dx
    kernel, dW kernel and partial sums apart. Returns per-step sums by
    kernel."""
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
                        ops_ms=0.0)
    step = {"k2": zero(), "k3": zero(), "k4f": zero(), "k4b": zero()}
    parts = dict(fwd_kernel_ms=0.0, fwd_sums_ms=0.0, dx_kernel_ms=0.0,
                 dw_kernel_ms=0.0, bwd_sums_ms=0.0)

    def add(key, times, ms, plain_ms, bound, by):
        step[key]["ms"] += times * ms
        step[key]["plain_ms"] += times * plain_ms
        step[key]["bound_ms"] += times * bound
        step[key]["bytes_ms" if by == "bytes" else "ops_ms"] += times * bound

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
                add("k3", times, k3_ms, plain_ms, bound, by)
                # K2 runs conv3 too, without the prologue
                k2_ms = med(lambda: cb.matmul_with_stats(x, w))
                k2_plain = med(lambda: mk.forward_plain(x, w))
            else:
                ms = med(lambda: fu.matmul_stats(x, w, "pallas"))
                k2_ms, k2_plain = med(lambda: cb.matmul_with_stats(x, w)), \
                    plain_ms
            add("k4f", times, ms, plain_ms, bound, by)
            add("k2", times, k2_ms, k2_plain, bound, by)
            split, fwd_traced = kernel_ms_by_group(
                (lambda: fu.norm_relu_matmul_stats(
                    x, w, *bn.values(), 2e-5, True, "pallas")) if prologue
                else (lambda: fu.matmul_stats(x, w, "pallas")), flush,
                want=("matmul_stats_kernel",))
            kernel_ms = split["matmul_stats_kernel"]
            sums_ms = split.get("reduce_kernel", 0.0)
            parts["fwd_kernel_ms"] += times * kernel_ms
            parts["fwd_sums_ms"] += times * sums_ms
            emit(phase="k4f_timing", shape=shape, per_step=times,
                 normalize=prologue, relu=prologue, runs=25, ms=ms,
                 plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                 share_of_bound=bound / ms, torch_mm_ms=mm_ms, k2_ms=k2_ms,
                 k3_ms=k3_ms if prologue else None,
                 tile=mk.tile_plan(shape[0], shape[2])[0],
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
            add("k4b", times, ms, plain_ms, bound, by)
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
                 dx_tile=mk.tile_plan(shape[0], shape[1])[0],
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


def profile_call(phase, step, state, batch, images, untraced_ms):
    """One more train call under torch.profiler: device time by kernel
    group, and the device's busy share of an untraced call (device time
    over the untraced calls' median wall time; the traced call's own wall
    time carries the tracer's overhead). The per-kernel sums are the
    profiler module's reading of the exported chrome trace; device time
    counts kernels and the copy engines' copies and fills, as the
    profiler's CUDA events did before, and the copies' share is reported
    apart."""
    from resnet_tpu_torch.utils.profiler import (DEVICE_CATEGORIES,
                                                 kernel_times, load_trace,
                                                 maybe_trace, newest_trace)
    torch.cuda.synchronize()
    with trace_dir() as logdir:
        with maybe_trace(logdir):
            tic = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - tic) * 1e3
        trace = load_trace(newest_trace(logdir))
    total_us, _ = kernel_times(trace, DEVICE_CATEGORIES)
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
         top_kernels=[{"name": n[:90], "ms": ms} for n, ms in top])


def train_path(phase, cfg, timed_calls, per_step, eval_after=False):
    """One full-width train path: ResNet-50, batch 128, bf16, 6 steps a
    call; 1 warm-up call and ``timed_calls`` timed ones. ``per_step`` maps
    each kernel wrapper on this path to its expected launches per step; the
    counts are set to 0 just before the path is driven and read just after.
    Returns wrapper -> launches."""
    from resnet_tpu_torch.ops.augment import eval_center_crop
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import eval_step, make_train_step
    torch.backends.cudnn.benchmark = True
    k = cfg.train.steps_per_dispatch
    bs = cfg.train.batch_size
    state = create_train_state(cfg, device="cuda")
    step = make_train_step(label_smooth=cfg.train.label_smooth,
                           augment_fn=make_augment_fn(cfg),
                           steps_per_dispatch=k)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pool = [{
        "image": torch.randint(0, 256, (k, bs, CANVAS, CANVAS, 3),
                               generator=gen, device="cuda",
                               dtype=torch.uint8),
        "label": torch.randint(0, cfg.data.num_classes, (k, bs),
                               generator=gen, device="cuda"),
        # full-canvas dims: orig == eff == canvas
        "dims": torch.full((k, bs, 4), CANVAS, dtype=torch.int32,
                           device="cuda"),
    } for _ in range(2)]
    # the shapes this file times are derived from the model's structure:
    # hold them against what the running model's units really receive
    seen = []
    hooks = [u.register_forward_pre_hook(
        lambda mod, args: seen.append(tuple(args[0].shape)))
        for u in state.model.units()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for wrapper in per_step:
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
    require(state.step == steps, "step count")
    want_inputs = r50_op_shapes(state.model, bs, OUT)[2]
    require(seen == want_inputs * k, f"{phase}: the units saw {seen[:3]}..., "
            f"the shape table assumes {want_inputs[:3]}...")
    call_s = statistics.median(times)
    emit(phase=phase, model="resnet50", batch=bs, steps_per_call=k,
         calls=calls, warmup_calls=1, losses=losses, call_seconds=times,
         median_call_seconds=call_s, img_per_s=k * bs / call_s,
         bn_ema=cfg.train.bn_ema, unit_chain=cfg.train.unit_chain,
         fused_convbn=cfg.train.fused_convbn,
         launches={w.__name__: n for w, n in launches.items()},
         launches_per_step={w.__name__: n for w, n in per_step.items()},
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=nvidia_smi_line(), device=torch.cuda.get_device_name(0))
    profile_call(phase, step, state, pool[0], k * bs, call_s * 1e3)
    if eval_after:
        metrics = eval_step(state, {"image": pool[0]["image"][0],
                                    "label": pool[0]["label"][0]},
                            preprocess_fn=lambda im: eval_center_crop(
                                im, cfg.data, (OUT, OUT), torch.bfloat16))
        ev = {name: float(v) for name, v in metrics.items()}
        require(ev["count"] == bs and all(map(math.isfinite, ev.values())),
                f"eval metrics {ev}")
        emit(phase="eval_step", **ev)
    del state, step, pool
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
    # the matrix kernels are laid out for at most 128 registers a thread;
    # a spill would put their fragments through local memory
    for name in ("matmul_stats", "matmul_stats_bwd"):
        require(usage[name]["kernels"] > 0 and
                usage[name]["spill_store_bytes"] == 0,
                f"{name}: {usage[name]} (spill stores in the build log)")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only", default="", help="comma-separated phases "
                        "to run after the build (default: all)")
    only = set(filter(None, parser.parse_args(argv).only.split(",")))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops.augment_fused import \
        fused_crop_mirror_normalize as k1
    from resnet_tpu_torch.ops.fused_chain import \
        normalized_matmul_with_stats as k3
    from resnet_tpu_torch.ops.fused_convbn import matmul_with_stats as k2

    def on(phase):
        return not only or phase in only

    card = nvidia_smi_line()
    print(card, flush=True)
    emit(phase="card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    build_phase()

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
        k1_worst, k1_time = check_augment_kernel(cfg)
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
    if on("main"):
        main_l = train_path("main_path", cfg, 3, {k1: 1}, eval_after=True)
    if on("chain"):
        chain_l = train_path("chain_path", chain, 3, {
            k1: 1, fu.matmul_stats: 20, fu.norm_relu_matmul_stats: 16,
            fu.fused_backward: 36})
    if on("fused"):
        fused_l = train_path("fused_path", fused, 3, {k1: 1, k2: 36})
    if on("fullbatch"):
        train_path("fullbatch_path", full, 2, {k1: 1})
    if on("trace_probe"):
        trace_probe_phase()
    # last: its per-shape profiled windows leave the host slower for the
    # rest of the process (the bn-ema path's calls took 0.87 s instead of
    # 0.67 after them, on the card), which the paths' wall times above
    # would read
    if on("mm_timing"):
        step_ms = time_matmul_kernels(ops_a, ops_b)

    if not only:
        def mm_kernel(name, source, replaces, launches, err, t):
            return dict(name=name, route="cuda",
                        source=f"resnet_tpu_torch/csrc/{source}",
                        replaces=replaces, launches=launches,
                        max_abs_err=err, ms=t["ms"], plain_ms=t["plain_ms"],
                        bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                        library_ms=None)
        kernels = [
            dict(name="fused_crop_mirror_normalize", route="cuda",
                 source="resnet_tpu_torch/csrc/augment.cu",
                 replaces="resnet_tpu/ops/augment_pallas.py:105",
                 launches=main_l[k1], max_abs_err=k1_worst, ms=k1_time["ms"],
                 plain_ms=k1_time["plain_ms"], bound_ms=k1_time["bound_ms"],
                 bound_by=k1_time["bound_by"], library_ms=None),
            # ms, plain_ms and bound_ms of the next four: sums over the
            # launches of one ResNet-50 step at batch 128, bf16
            mm_kernel("matmul_with_stats", "matmul_stats.cu",
                      "resnet_tpu/ops/fused_convbn.py:33", fused_l[k2],
                      fwd_worst["k2"], step_ms["k2"]),
            mm_kernel("normalized_matmul_with_stats", "matmul_stats.cu",
                      "resnet_tpu/ops/fused_chain.py:33", k3_launches,
                      fwd_worst["k3"], step_ms["k3"]),
            mm_kernel("matmul_stats+norm_relu_matmul_stats",
                      "matmul_stats.cu", "resnet_tpu/ops/fused_unit.py:71",
                      chain_l[fu.matmul_stats]
                      + chain_l[fu.norm_relu_matmul_stats],
                      fwd_worst["k4f"], step_ms["k4f"]),
            mm_kernel("fused_backward", "matmul_stats_bwd.cu",
                      "resnet_tpu/ops/fused_unit.py:138",
                      chain_l[fu.fused_backward], bwd_worst, step_ms["k4b"]),
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
