"""Trace the train step on the card and print device time by kernel. Port
of ``tools/trace_probe.py``.

    python -m resnet_tpu_torch.tools.trace_probe [--steps 5] [--warmup 3]
        [--batch-size 256] [--bn-subsample 8] [--bn-ema] [--stem-s2d]
        [--depth 50] [--logdir DIR] [--top 25] [--parse-only]

The program is the JAX tool's: a default ``Config`` at bf16 with the given
depth, batch, BatchNorm and stem flags, the fused augmentation kernel in
the standard (non-s2d) layout, one step per call, fed a uint8
``(batch, 224, 224, 3)`` batch made from numpy seed 0. After ``--warmup``
untraced steps, ``--steps`` steps run under ``torch.profiler`` and the
chrome trace lands under ``--logdir`` (default ``trace_probe`` in the
temporary directory). ``parse_trace`` then reads the newest trace there:
the card's kernel events, summed by name, printed as ms/step in total, by
group (the name without return type, namespaces, template arguments,
argument list and trailing digits) and as the top events.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import tempfile
import time
from collections import defaultdict
from typing import Optional

import numpy as np
import torch

from resnet_tpu_torch.utils.profiler import (kernel_group, kernel_times,
                                             load_trace, maybe_trace,
                                             newest_trace)

DEFAULT_LOGDIR = os.path.join(tempfile.gettempdir(), "trace_probe")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trace_train_step(steps: int = 5, warmup: int = 3, batch_size: int = 256,
                     bn_subsample: int = 8, bn_ema: bool = False,
                     stem_s2d: bool = False, depth: int = 50,
                     logdir: str = DEFAULT_LOGDIR, device=None,
                     image_side: int = 224) -> dict:
    """Build the probe's program, run ``warmup`` untraced steps and trace
    ``steps`` more into ``logdir``. ``device=None`` means the card;
    ``image_side`` below 224 makes a small program for a CPU run. Returns
    the untraced steps' median wall ms (the first excluded) and the traced
    steps' wall ms."""
    from resnet_tpu_torch.config import Config
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    from resnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    if device.type == "cuda":
        # cuDNN picks its algorithms by timing them, as XLA's autotuner
        # does for the JAX tool's program
        torch.backends.cudnn.benchmark = True
    cfg = Config()
    cfg.model.depth = depth
    cfg.train.dtype = "bfloat16"
    cfg.train.batch_size = batch_size
    cfg.train.bn_subsample = bn_subsample
    cfg.train.bn_ema = bn_ema
    cfg.train.stem_s2d = stem_s2d
    cfg.data.image_shape = (image_side, image_side, 3)
    state = create_train_state(cfg, device=device)
    step = make_train_step(augment_fn=make_augment_fn(cfg))
    h, w, c = cfg.data.image_shape
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(
            0, 256, (batch_size, h, w, c), dtype=np.uint8)).to(device),
        "label": torch.from_numpy(rng.integers(
            0, cfg.data.num_classes, (batch_size,))).to(device),
    }
    untraced = []
    for _ in range(warmup):
        tic = time.perf_counter()
        state, m = step(state, batch)
        _sync(device)
        untraced.append((time.perf_counter() - tic) * 1e3)
    with maybe_trace(logdir):
        tic = time.perf_counter()
        for _ in range(steps):
            state, m = step(state, batch)
        _sync(device)
        traced_ms = (time.perf_counter() - tic) * 1e3
    return dict(untraced_step_ms=(statistics.median(untraced[1:])
                                  if len(untraced) > 1 else None),
                traced_wall_ms=traced_ms, loss=float(m["loss_sum"]
                                                     / m["count"]))


def parse_trace(logdir: str, top: int, steps: int) -> Optional[dict]:
    """Print the device time by kernel of the newest chrome trace under
    ``logdir``: ms/step in total, by group and the top events. Returns
    ``{"ms_per_step", "groups", "top"}`` (ms/step), or None when there is
    no trace or it holds no kernel events."""
    path = newest_trace(logdir)
    if path is None:
        print("no trace found under", logdir)
        return None
    trace = load_trace(path)
    tot, count = kernel_times(trace)
    if not tot:
        cats = sorted({str(e.get("cat")) for e in trace.get("traceEvents", [])
                       if e.get("ph") == "X"})
        print(f"no device kernel events in {path}; event categories seen:",
              cats[:20])
        return None
    per = max(steps, 1)
    total_ms = sum(tot.values()) / 1e3
    print(f"device event time {total_ms:.1f} ms over {steps} steps "
          f"= {total_ms / per:.1f} ms/step")
    by_group = defaultdict(float)
    for name, us in tot.items():
        by_group[kernel_group(name)] += us
    groups = sorted(by_group.items(), key=lambda kv: -kv[1])[:top]
    print("-- grouped (ms/step) --")
    for key, us in groups:
        print(f"  {us / 1e3 / per:9.2f}  {key}")
    print("-- top events (ms/step total, count) --")
    events = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    for name, us in events:
        print(f"  {us / 1e3 / per:9.2f} x{count[name]:5d}  {name[:90]}")
    return dict(ms_per_step=total_ms / per,
                groups={k: us / 1e3 / per for k, us in groups},
                top=[dict(name=n[:90], ms_per_step=us / 1e3 / per,
                          count=count[n]) for n, us in events])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--bn-subsample", type=int, default=8)
    p.add_argument("--bn-ema", action="store_true",
                   help="trace the bn-ema program (the imagenet_resnet50 "
                        "mode); pair with --bn-subsample 1 for its "
                        "full-batch EMA refresh")
    p.add_argument("--stem-s2d", action="store_true",
                   help="trace the space-to-depth stem lowering")
    p.add_argument("--depth", type=int, default=50)
    p.add_argument("--logdir", default=DEFAULT_LOGDIR)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--parse-only", action="store_true")
    args = p.parse_args(argv)
    if not args.parse_only:
        trace_train_step(steps=args.steps, warmup=args.warmup,
                         batch_size=args.batch_size,
                         bn_subsample=args.bn_subsample, bn_ema=args.bn_ema,
                         stem_s2d=args.stem_s2d, depth=args.depth,
                         logdir=args.logdir)
    parse_trace(args.logdir, args.top, args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
