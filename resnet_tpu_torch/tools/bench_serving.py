"""Serving-artifact throughput: the exported program against the live
model. Port of ``tools/bench_serving.py``.

It clocks the same inference program two ways on the same pre-staged
uint8 device batches:

  1. live:     the eager ``make_serving_fn`` module under
               ``torch.inference_mode``;
  2. artifact: ``load_serving`` on a freshly saved ``torch.export`` file;

and prints one JSON line: img/s of both (the live rate under the JAX
tool's key ``live_jit``), their ratio, the artifact's size, the export and
load seconds, and the peak device memory. Each rate is the median of
``--windows`` windows of ``--steps`` calls, each window ended by
``torch.cuda.synchronize``. The weights are random, from the preset's
seed.

    python -m resnet_tpu_torch.tools.bench_serving          # the card
    python -m resnet_tpu_torch.tools.bench_serving --quick --device cpu

Without a card and without ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import torch

from resnet_tpu_torch.config import imagenet_resnet50, imagenet_resnext50
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.serving import (export_serving, load_serving,
                                            make_serving_fn)


def main(argv=None):
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--quick", action="store_true",
                   help="tiny shapes for a smoke test")
    p.add_argument("--network", choices=["resnet", "resnext"],
                   default="resnet")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=256,
                   help="serving batch")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--windows", type=int, default=3)
    p.add_argument("--warmup", type=int, default=5)
    p.add_argument("--pool", type=int, default=4)
    p.add_argument("--symbolic-batch", action="store_true",
                   help="export a symbolic-batch artifact (the shipping "
                        "default) instead of pinning --batch-size")
    p.add_argument("--keep", default=None,
                   help="write the artifact under this prefix instead of "
                        "a temp dir")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = (imagenet_resnext50() if args.network == "resnext"
           else imagenet_resnet50())
    cfg.model.network = args.network
    cfg.model.depth = args.depth
    if args.quick:
        # resnext has no basic-block depths: its smallest net is 50
        cfg.model.depth = 50 if args.network == "resnext" else 18
        cfg.data.image_shape = (64, 64, 3)
        args.batch_size = 8
        if args.steps == 50:
            args.steps, args.warmup, args.windows = 4, 2, 2
    bs = args.batch_size
    cuda = device.type == "cuda"
    if cuda:
        torch.backends.cudnn.benchmark = True
        torch.cuda.reset_peak_memory_stats(device)

    state = create_train_state(cfg, device=device)
    live = make_serving_fn(cfg, state.model)

    with tempfile.TemporaryDirectory(prefix="bench_serving_") as tmp:
        prefix = args.keep or os.path.join(tmp, "artifact")
        tic = time.perf_counter()
        export_serving(cfg, state.model, prefix,
                       batch_size=None if args.symbolic_batch else bs,
                       platforms=(device.type,))
        export_s = time.perf_counter() - tic
        tic = time.perf_counter()
        served, _ = load_serving(prefix, device=device)
        load_s = time.perf_counter() - tic
        art_mb = os.path.getsize(prefix + ".pt2") / 2 ** 20

    h, w, c = cfg.data.image_shape
    gen = torch.Generator(device=device).manual_seed(0)
    pool = [torch.randint(0, 256, (bs, h, w, c), generator=gen,
                          dtype=torch.uint8, device=device)
            for _ in range(args.pool)]

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    @torch.inference_mode()
    def clock(fn, label):
        for i in range(args.warmup):
            fn(pool[i % args.pool])
        sync()
        rates = []
        for wdw in range(max(1, args.windows)):
            tic = time.perf_counter()
            for i in range(args.steps):
                fn(pool[(wdw * args.steps + i) % args.pool])
            sync()
            rates.append(args.steps * bs / (time.perf_counter() - tic))
        rates.sort()
        med = rates[len(rates) // 2]
        print(f"# {label}: {med:.1f} img/s, windows {rates}",
              file=sys.stderr)
        return med

    live_rate = clock(live, "live eager")
    art_rate = clock(served, "artifact")

    name = f"{cfg.model.network}{cfg.model.depth}_serving_artifact"
    if args.symbolic_batch:
        name += "_symb"
    if args.quick:
        name += "_quick"
    print(json.dumps({
        "metric": name,
        "value": art_rate,
        "unit": "images/sec/chip",
        "live_jit": live_rate,
        "artifact_vs_live": art_rate / live_rate,
        "artifact_mb": art_mb,
        "export_s": export_s,
        "load_s": load_s,
        "batch": bs,
        "platform": "gpu" if cuda else device.type,
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2 ** 30
                     if cuda else "not measured"),
        "dtype": cfg.train.dtype,
        "image_shape": list(cfg.data.image_shape),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
