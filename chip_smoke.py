#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``resnet_tpu_torch/csrc``, holds each
against its plain PyTorch version on the card at the training shapes,
drives the ``imagenet_resnet50`` training step at full width (ResNet-50,
batch 128, bf16, six steps per call) through the port's entry points,
checks that step against the port's CPU path on a small input, and runs
one eval step. Each phase prints one JSON line; a failed check raises and
the script exits non-zero. The last lines are the kernels line, the
card's ``nvidia-smi`` name and power limit, and
``{"ok": true, "device": {...}}``. Imports nothing of JAX or of the JAX
package.
"""

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time

import torch

CANVAS, OUT, BATCH = 256, 224, 128
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
FP32_OPS_PER_S = 67e12             # H100 SXM, float32 outside tensor cores
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


def cuda_median_ms(fn, runs=25, flush=None):
    """Median of ``runs`` CUDA-event timings of ``fn()``; ``flush`` is
    written before each run so that its inputs come from HBM, not L2."""
    times = []
    for _ in range(runs):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
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


def small_reference_check():
    """One float32 train step of full-width ResNet-50 on a small input, on
    the card and on the CPU from the same weights and rows: the CPU path
    is the one the tests hold against the JAX package."""
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    from resnet_tpu_torch.utils.device import set_tf32
    cfg = imagenet_resnet50()
    cfg.train.dtype = "float32"
    cfg.data.image_shape = (96, 96, 3)
    n = 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    canvas, rows, _ = aug_inputs(cfg.data, gen, n, False, canvas_side=112,
                                 out=96)
    batch = {"image": canvas,
             "label": torch.randint(0, 1000, (n,), generator=gen,
                                    device="cuda"),
             "rows": rows}
    set_tf32(False)
    results = {}
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
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    emit(phase="reference_check", model="resnet50 f32", batch=n,
         image=list(cfg.data.image_shape), loss_cuda=loss_gpu,
         loss_cpu=loss_cpu, loss_rel_err=loss_err, momentum_rel_err=mom_err,
         fc_momentum_rel_err=head_err)
    require(loss_err < 1e-4, "loss differs from the CPU path")
    # the momentum is the update, -lr * (gradient + wd * w). ResNet-50's
    # backward at init amplifies rounding from the head down: two float32
    # paths that sum in other orders agree on the whole update to about
    # 2-2.5% here, on the fc head's to far better; a wrong path on neither
    require(head_err < 1e-3, "the fc update differs from the CPU path")
    require(mom_err < 1e-1, "the update differs from the CPU path")
    set_tf32(True)


# device-time categories of the traced call, matched on kernel names in
# this order
KERNEL_GROUPS = (
    ("augment kernel", ("fused_crop_mirror_normalize",)),
    ("conv and matmul", ("conv", "gemm", "xmma", "cudnn", "cutlass", "sm90",
                         "wgrad", "dgrad", "implicit")),
    ("optimizer (foreach)", ("multi_tensor", "foreach")),
    ("reductions", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def profile_call(step, state, batch, images, untraced_ms):
    """One more train call under torch.profiler: device time by kernel
    group, and the device's busy share of an untraced call (device time
    over the untraced calls' median wall time; the traced call's own wall
    time carries the tracer's overhead)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    tic = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - tic) * 1e3
    by_kernel = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[evt.name] = (by_kernel.get(evt.name, 0.0)
                                   + evt.time_range.elapsed_us() / 1e3)
    groups = {}
    for name, ms in by_kernel.items():
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(key in name.lower() for key in keys)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    busy_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    emit(phase="profile", images=images, traced_wall_ms=wall_ms,
         untraced_call_ms=untraced_ms,
         device_busy_ms=busy_ms if busy_ms else "not measured",
         device_busy_share=(busy_ms / untraced_ms if busy_ms
                            else "not measured"),
         device_ms_by_group=groups,
         top_kernels=[{"name": n[:90], "ms": ms} for n, ms in top])


def main_path(cfg):
    """The imagenet_resnet50 train call at full width: 1 warm-up call and
    3 timed calls of 6 steps at batch 128, then one eval step."""
    from resnet_tpu_torch.ops.augment import eval_center_crop
    from resnet_tpu_torch.ops.augment_fused import (
        fused_crop_mirror_normalize, make_augment_fn)
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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    fused_crop_mirror_normalize.launches = 0
    calls, times, losses = 4, [], []
    for c in range(calls):
        tic = time.perf_counter()
        state, m = step(state, pool[c % 2])
        torch.cuda.synchronize()
        if c:                                   # call 0 is the warm-up
            times.append(time.perf_counter() - tic)
        losses.append(float(m["loss_sum"] / m["count"]))
    launches = fused_crop_mirror_normalize.launches
    require(all(map(math.isfinite, losses)), f"non-finite loss {losses}")
    require(launches == calls * k, f"augmentation kernel launched "
            f"{launches} times in {calls * k} steps")
    require(state.step == calls * k, "step count")
    call_s = statistics.median(times)
    emit(phase="main_path", model="resnet50", batch=bs,
         steps_per_call=k, calls=calls, warmup_calls=1, losses=losses,
         call_seconds=times, median_call_seconds=call_s,
         img_per_s=k * bs / call_s, aug_kernel_launches=launches,
         peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
         card=nvidia_smi_line(), device=torch.cuda.get_device_name(0))
    profile_call(step, state, pool[0], k * bs, call_s * 1e3)

    metrics = eval_step(state, {"image": pool[0]["image"][0],
                                "label": pool[0]["label"][0]},
                        preprocess_fn=lambda im: eval_center_crop(
                            im, cfg.data, (OUT, OUT), torch.bfloat16))
    ev = {name: float(v) for name, v in metrics.items()}
    require(ev["count"] == bs and all(map(math.isfinite, ev.values())),
            f"eval metrics {ev}")
    emit(phase="eval_step", **ev)
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from resnet_tpu_torch import _build
    from resnet_tpu_torch.config import imagenet_resnet50

    card = nvidia_smi_line()
    print(card, flush=True)
    emit(phase="card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    tic = time.perf_counter()
    libs = _build.build_all()
    emit(phase="build", seconds=time.perf_counter() - tic,
         libraries=sorted(p.name for p in libs.values()))

    cfg = imagenet_resnet50()
    worst, timing = check_augment_kernel(cfg)
    small_reference_check()
    launches = main_path(cfg)

    kernel = dict(name="fused_crop_mirror_normalize", route="cuda",
                  source="resnet_tpu_torch/csrc/augment.cu",
                  replaces="resnet_tpu/ops/augment_pallas.py:105",
                  launches=launches, max_abs_err=worst, ms=timing["ms"],
                  plain_ms=timing["plain_ms"], bound_ms=timing["bound_ms"],
                  bound_by=timing["bound_by"], library_ms=None)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
