"""Input-pipeline benchmark: decode throughput and the measured end-to-end
overhead. Port of ``tools/bench_input.py``.

Builds a RecordIO shard of real JPEGs (smooth noise, 256x256, quality
90), then times the same train step two ways:

  A) device-only: pre-staged device-resident batches (the compute
     ceiling);
  B) end to end: ``RecordIter`` (the record loader training uses) ->
     the host queue -> ``prefetch_to_device`` (pinned memory, side-stream
     copy) -> the step;

and reports ``overhead = t_B / t_A - 1`` (``utils/profiler.
input_overhead``), the record loader's decode rate (img/s and img/s per
core) and its ``decoder``: ``native`` (the C++ pool over libjpeg) or
``python`` (Pillow, where the pool does not build). The step is the
training step the Solver builds: ``make_train_step`` with
``make_augment_fn(device_augment_config(cfg))``, so on the card the
augmentation is the CUDA kernel (K1). ``cores_needed_for_device_rate`` is
the device-only leg's img/s over the per-core decode rate: the cores the
host needs to keep the card fed. Every timed window ends on
``torch.cuda.synchronize()`` (on the CPU: the metric read).

    python -m resnet_tpu_torch.tools.bench_input [--num-images 512] \\
        [--threads 4] [--interleave 4]
    python -m resnet_tpu_torch.tools.bench_input --quick --device cpu

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import tempfile
import time
from typing import Tuple

import numpy as np
import torch


def build_dataset(root: str, n: int, hw: int = 256) -> str:
    """``n`` JPEG records in ``root/bench.rec`` (+ ``.idx``); returns the
    prefix."""
    from PIL import Image

    from resnet_tpu_torch.data.recordio import RecordIOWriter, \
        pack_image_record
    rng = np.random.default_rng(0)
    prefix = os.path.join(root, "bench")
    with RecordIOWriter(prefix + ".rec", prefix + ".idx") as w:
        for i in range(n):
            # realistic JPEG entropy: smooth noise
            arr = rng.integers(0, 256, (hw // 8, hw // 8, 3), np.uint8)
            img = Image.fromarray(arr).resize((hw, hw), Image.BILINEAR)
            buf = io.BytesIO()
            img.save(buf, format="JPEG", quality=90)
            w.write(pack_image_record(buf.getvalue(), float(i % 10),
                                      rec_id=i), key=i)
    return prefix


def measure_decode(prefix: str, threads: int, batch_size: int,
                   canvas: int) -> Tuple[float, str]:
    """(img/s, decoder kind) of one epoch through the record loader, after
    one warm batch."""
    from resnet_tpu_torch.data.native import make_record_loader
    loader = make_record_loader(prefix + ".rec", prefix + ".idx",
                                (canvas, canvas), threads=threads)
    try:
        loader.begin_epoch(0, True, 0)
        loader.next_batch(batch_size)  # warm
        loader.begin_epoch(1, True, 0)
        tic = time.perf_counter()
        total = 0
        while True:
            imgs, _, _ = loader.next_batch(batch_size)
            total += len(imgs)
            if len(imgs) < batch_size:
                break
        dt = time.perf_counter() - tic
    finally:
        loader.close()
    return total / dt, loader.kind


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--num-images", type=int, default=512)
    p.add_argument("--threads", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--steps", type=int, default=0,
                   help="timed steps per leg (0 = one epoch's worth)")
    p.add_argument("--dtype", choices=["auto", "float32", "bfloat16"],
                   default="auto",
                   help="compute dtype (auto: bfloat16 on the card, "
                        "float32 on the CPU)")
    p.add_argument("--quick", action="store_true",
                   help="tiny model/shapes for a smoke test")
    p.add_argument("--decode-only", action="store_true",
                   help="skip the train-step legs (no device work)")
    p.add_argument("--interleave", type=int, default=0,
                   help="N>0: alternate device-only/end-to-end windows of "
                        "N steps instead of sequential legs, so that the "
                        "machine's drift from phase to phase cancels")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def _sync(device, metrics) -> None:
    """End a timed window: wait for the card (the metric read waits for
    the CPU's work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    float(metrics["count"])


def _step_legs(args, device, tmp: str, per_core: float) -> dict:
    """Both legs of the train step; their result fields, with the cores
    that decode at ``per_core`` img/s each would need to feed the
    device-only rate."""
    from resnet_tpu_torch.config import Config
    from resnet_tpu_torch.data.loader import make_train_iter
    from resnet_tpu_torch.data.prefetch import prefetch_to_device
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.solver import device_augment_config
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    from resnet_tpu_torch.utils.profiler import input_overhead
    from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                                 compiler_options)

    cfg = Config()
    cfg.model.depth = args.depth
    cfg.data.data_dir = tmp
    cfg.data.train_rec = "bench.rec"
    cfg.data.num_classes = 10
    cfg.data.image_shape = (args.image_size, args.image_size, 3)
    cfg.data.preprocess_threads = args.threads
    cfg.train.batch_size = args.batch_size
    cfg.train.dtype = args.dtype if args.dtype != "auto" else (
        "bfloat16" if device.type == "cuda" else "float32")
    # the training entry point's switches (cudnn.benchmark on the card)
    apply_backend_options(compiler_options(None, device.type))
    state = create_train_state(cfg, device=device)
    step_fn = make_train_step(
        augment_fn=make_augment_fn(device_augment_config(cfg)))

    train_iter = make_train_iter(cfg)
    steps = args.steps or train_iter.steps_per_epoch

    def pipeline(epoch):
        return prefetch_to_device(train_iter.epoch_iter(epoch), size=2,
                                  device=device)

    def run_epoch_through_pipeline(epoch: int, nsteps: int) -> int:
        nonlocal state
        n = 0
        for batch in pipeline(epoch):
            state, metrics = step_fn(state, batch)
            n += 1
            if n >= nsteps:
                break
        _sync(device, metrics)
        return n

    # warm both legs (cuDNN's algorithm search, the kernel's build)
    run_epoch_through_pipeline(0, 2)

    # leg A's pool: device-resident batches, rotated
    pool = []
    for i, b in enumerate(train_iter.epoch_iter(1)):
        pool.append({k: torch.from_numpy(np.asarray(v)).to(device)
                     for k, v in b.items()})
        if i >= 3:
            break
    state, metrics = step_fn(state, pool[0])
    _sync(device, metrics)

    if args.interleave:
        # alternating windows: the same machine phase times both legs
        win = args.interleave
        n_win = max(2, steps // win)

        def pipeline_windows():
            epoch = 2
            while True:
                yield from pipeline(epoch)
                epoch += 1

        gen = pipeline_windows()
        next(gen)  # prime the producer
        t_device = t_e2e = 0.0
        for _ in range(n_win):
            tic = time.perf_counter()
            for i in range(win):
                state, metrics = step_fn(state, pool[i % len(pool)])
            _sync(device, metrics)
            t_device += time.perf_counter() - tic
            tic = time.perf_counter()
            for i in range(win):
                state, metrics = step_fn(state, next(gen))
            _sync(device, metrics)
            t_e2e += time.perf_counter() - tic
        gen.close()
        t_device /= n_win * win
        t_e2e /= n_win * win
    else:
        # sequential legs (subject to phase drift)
        tic = time.perf_counter()
        for i in range(steps):
            state, metrics = step_fn(state, pool[i % len(pool)])
        _sync(device, metrics)
        t_device = (time.perf_counter() - tic) / steps
        # leg B: decode -> queue -> H2D -> step
        tic = time.perf_counter()
        n = run_epoch_through_pipeline(2, steps)
        t_e2e = (time.perf_counter() - tic) / max(n, 1)

    return {
        "step_ms_device_data": round(t_device * 1e3, 2),
        "step_ms_end_to_end": round(t_e2e * 1e3, 2),
        "input_overhead": round(input_overhead(t_e2e, t_device), 4),
        "input_overhead_target": 0.05,
        "host_fed_imgs_per_sec": round(args.batch_size / t_e2e, 1),
        "cores_needed_for_device_rate": round(
            args.batch_size / t_device / max(per_core, 1e-9), 2),
    }


def bench(args) -> dict:
    """The benchmark for parsed ``args``; the JSON line's fields."""
    from resnet_tpu_torch.utils.cache import enable_compile_cache
    from resnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)   # no card: raise before the data
    enable_compile_cache()
    if args.quick:
        args.num_images = min(args.num_images, 128)
        args.batch_size = 16
        args.depth = 18
        args.image_size = 64

    with tempfile.TemporaryDirectory(prefix="bench_input_") as tmp:
        prefix = build_dataset(tmp, args.num_images,
                               max(args.image_size, 64))
        canvas = (args.image_size * 8 + 6) // 7 if args.image_size > 64 \
            else args.image_size
        # 1) raw decode throughput (the host-side ceiling)
        decode_rate, kind = measure_decode(prefix, args.threads,
                                           args.batch_size, canvas)
        ncpu = os.cpu_count() or 1
        per_core = decode_rate / max(1, min(args.threads, ncpu))
        result = {
            "decoder": kind,
            "decode_imgs_per_sec": round(decode_rate, 1),
            "decode_imgs_per_sec_per_core": round(per_core, 1),
            "host_cores": ncpu,
            "threads": args.threads,
        }
        if not args.decode_only:
            result.update(_step_legs(args, device, tmp, per_core))
    return result


def main(argv=None):
    print(json.dumps(bench(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
