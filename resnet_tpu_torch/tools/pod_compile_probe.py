"""The data-parallel train step's collectives, FLOPs and memory on one
rank of N. Port of ``tools/pod_compile_probe.py``.

The JAX tool compiles the data-parallel step for a named TPU topology
without the chips and audits the scheduled program: the gradient
all-reduces (count, bucket bytes, total bytes against the parameters'),
where they sit among the backward's fusions, the per-device HBM and the
FLOPs. The port compiles nothing, so it runs the step instead, as rank 0
of a ``--world-size``-rank group of torch's ``fake`` backend (collectives
that move nothing; ``utils/op_count.py``), on the card or on the CPU, and
counts what the step dispatches (``OpCounter``): every collective where
it is called (``train/steps.py``'s ``all_reduce_`` and ``sum_metrics``,
``sync_state``, the differentiable all-reduces of ``BatchNorm(group=)``
under ``dp_mode="jit"``) with the bytes of its tensors, and its place
among the step's ops. ``count_dp_step`` takes any group: under a real
one (gloo over N processes) it counts what the fake group's rank 0 counts.

The report keeps ``audit_hlo``'s keys where the quantity exists:
``collective_op_counts``, ``n_allreduce_buckets`` (here: calls),
``allreduce_bucket_bytes``, ``allreduce_total_bytes``,
``allreduce_bytes_over_param_bytes``, ``overlap_pct`` (the share of the
step's ops dispatched after the first all-reduce), ``schedule_tail``,
``flops_per_dispatch`` and ``hbm_per_device_gb`` (the peak of
``torch.cuda.max_memory_allocated`` over the step). What only a TPU
compiler produces is left out, and the JSON says so under
``not_applicable``. A fake reduction leaves every value local, so the
step's numbers are not the N-rank run's; its collectives, FLOPs and
memory are.

    python -m resnet_tpu_torch.tools.pod_compile_probe --quick --device cpu
    python -m resnet_tpu_torch.tools.pod_compile_probe \\
        --preset imagenet_resnet152_dp --world-size 16 [--dp-mode shard_map]

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist

from resnet_tpu_torch import config as C
from resnet_tpu_torch.config import DTYPES, Config
from resnet_tpu_torch.data.pipeline import canvas_size
from resnet_tpu_torch.ops.augment_fused import make_augment_fn
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.train.steps import make_train_step
from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.op_count import (OpCounter, fake_process_group,
                                             is_all_reduce, schedule)

PRESETS = ("imagenet_resnet50", "imagenet_resnet152_dp", "cifar10_resnet18")
GIB = 1 << 30
NOT_APPLICABLE = {
    key: "TPU compiler only: the port reduces in one collective over the "
         "whole group, with no slices, DCN transfers or reduce-scatter stage"
    for key in ("megascale_transfer_counts", "megascale_targets",
                "megascale_allreduce_send_bytes",
                "reduce_scatter_input_bytes",
                "reduced_bytes_over_param_bytes",
                "allreduce_replica_group_shapes")}


def rank_batch(cfg: Config, n: int, k: int, device, seed: int = 0) -> dict:
    """A rank's block of ``n`` images (``k`` of them stacked when k > 1):
    random uint8 canvases at the train canvas size from ``seed``, random
    labels, and full-canvas ``dims`` where the canvas is not the image."""
    h, w, c = cfg.data.image_shape
    ch, cw = canvas_size((h, w), cfg.data.canvas_size)
    rng = np.random.default_rng(seed)
    lead = (k, n) if k > 1 else (n,)
    batch = {"image": torch.from_numpy(
        rng.integers(0, 256, lead + (ch, cw, c), dtype=np.uint8)),
        "label": torch.from_numpy(
            rng.integers(0, cfg.data.num_classes, lead))}
    if (ch, cw) != (h, w):
        batch["dims"] = torch.tensor([ch, cw, ch, cw],
                                     dtype=torch.int32).expand(lead + (4,))
    return {name: v.contiguous().to(device) for name, v in batch.items()}


def count_dp_step(cfg: Config, group, device
                  ) -> Tuple[OpCounter, torch.nn.Module]:
    """One call (``steps_per_dispatch`` steps) of the data-parallel train
    step of ``cfg`` (its ``dp_mode``, ``dp_sync`` and ``dp_comm_dtype``)
    on this rank of ``group``, its block of the global ``batch_size``,
    under an ``OpCounter``. Returns the counter and the model."""
    t = cfg.train
    world = dist.get_world_size(group)
    spd = max(1, t.steps_per_dispatch)
    state = create_train_state(
        cfg, device=device, bn_group=group if t.dp_mode == "jit" else None)
    step = make_train_step(
        augment_fn=make_augment_fn(cfg), steps_per_dispatch=spd, group=group,
        dp_mode=t.dp_mode, dp_sync=t.dp_sync,
        comm_dtype=DTYPES[t.dp_comm_dtype] if t.dp_comm_dtype == "bfloat16"
        else None)
    batch = rank_batch(cfg, t.batch_size // world, spd, device)
    with OpCounter() as counter:
        step(state, batch)
    return counter, state.model


def audit(counter: OpCounter, param_bytes: int) -> dict:
    """``audit_hlo``'s keys from a counted call (module docstring)."""
    ars = [e for e in counter.collectives() if is_all_reduce(e.op)]
    total = sum(e.bytes for e in ars)
    return {
        "collective_op_counts": dict(Counter(
            e.op for e in counter.collectives())),
        "n_allreduce_buckets": len(ars),
        "allreduce_bucket_bytes": sorted((e.bytes for e in ars),
                                         reverse=True),
        "allreduce_total_bytes": total,
        **schedule(counter),
        "flops_per_dispatch": counter.flops,
        "param_bytes": param_bytes,
        "allreduce_bytes_over_param_bytes": total / max(1, param_bytes),
    }


def probe_config(args) -> Config:
    """The preset at ``--world-size`` ranks with the overrides applied."""
    cfg = getattr(C, args.preset)()
    n = args.world_size
    if args.quick:
        cfg = C.cifar10_resnet18()
        cfg.model.depth = 20
        per_rank = 8
    else:
        per_rank = args.batch_per_chip or max(
            1, cfg.train.batch_size // max(1, cfg.train.num_devices))
    cfg.train.batch_size = per_rank * n
    cfg.train.num_devices = n
    for key in ("dp_mode", "dp_sync", "dp_comm_dtype", "remat"):
        value = getattr(args, key)
        if value is not None:
            setattr(cfg.train, key, value)
    if args.spd is not None:
        cfg.train.steps_per_dispatch = args.spd
    return cfg


def probe(args) -> dict:
    """Run the counted call as the probe's flags say, as rank 0 of a fake
    group; returns the report."""
    device = resolve_device(args.device)
    cfg = probe_config(args)
    with fake_process_group(args.world_size):
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        counter, model = count_dp_step(cfg, dist.group.WORLD, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        param_bytes = sum(p.numel() * p.element_size()
                          for p in model.parameters())
        state_bytes = 2 * param_bytes + sum(
            b.numel() * b.element_size() for b in model.buffers())
        report = {
            "preset": ("cifar10_resnet18(quick)" if args.quick
                       else args.preset),
            "depth": cfg.model.depth,
            "group": "fake",
            "n_devices": args.world_size,
            "device": str(device),
            "dp_mode": cfg.train.dp_mode,
            "global_batch": cfg.train.batch_size,
            "per_chip_batch": cfg.train.batch_size // args.world_size,
            "steps_per_dispatch": max(1, cfg.train.steps_per_dispatch),
            "remat": cfg.train.remat,
            "dtype": cfg.train.dtype,
            "dp_comm_dtype": cfg.train.dp_comm_dtype,
            "dp_sync": cfg.train.dp_sync,
            **audit(counter, param_bytes),
            "kernel_launches": counter.kernel_launches(),
            "hbm_per_device_gb": ({
                "peak_allocated": torch.cuda.max_memory_allocated(device)
                / GIB,
                "params_momentum_buffers": state_bytes / GIB}
                if device.type == "cuda" else "not measured (cpu)"),
            "not_applicable": NOT_APPLICABLE,
        }
    return report


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="imagenet_resnet50", choices=PRESETS)
    p.add_argument("--world-size", type=int, default=8,
                   help="ranks of the group (8: the device count of the "
                        "JAX tool's default v5e:2x4 topology)")
    p.add_argument("--batch-per-chip", type=int, default=0,
                   help="0 = the preset's per-device batch")
    p.add_argument("--dp-mode", choices=["jit", "shard_map"], default=None)
    p.add_argument("--spd", type=int, default=None,
                   help="steps_per_dispatch override (default: preset)")
    p.add_argument("--dp-comm-dtype", choices=["float32", "bfloat16"],
                   default=None)
    p.add_argument("--dp-sync", choices=["step", "dispatch"], default=None)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--quick", action="store_true",
                   help="CIFAR ResNet-20, 8 images a rank")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None) -> int:
    print(json.dumps(probe(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
