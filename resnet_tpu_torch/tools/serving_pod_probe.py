"""The N-device serving artifact: no collective, and its memory and FLOPs
a card. Port of ``tools/serving_pod_probe.py``.

The JAX tool compiles the batch-sharded inference program for a named
TPU topology and audits it for what makes batch-parallel serving scale:
no cross-device collective anywhere in the program, the per-device HBM at
the serving batch and the per-device FLOPs. The port's N-device artifact
(``utils/serving.py::export_serving(num_devices=N)``, the ``serve_export
--serve-devices N`` file) is one program that each card runs on its own
block of the batch, so the audit reads that program:

  - ``collective_free``: no op of any c10d namespace (``c10d``,
    ``_c10d_functional``, ...: the namespace, not a list of names, so
    that async-wrapped and all-to-all forms count too) in the exported
    graph or in any graph nested in it; ``collective_op_counts`` lists
    what was found;
  - ``hbm_per_device_gb``: the peak of ``torch.cuda.max_memory_allocated``
    while one card runs its copy of the program (``move_to_device_pass``,
    as ``load_serving`` places it) on ``--batch-per-chip`` images;
  - ``flops_per_device_per_batch``: what that call dispatches, counted by
    ``utils/op_count.py``'s ``OpCounter``.

Without ``--artifact`` it exports one first, with random weights from the
preset's seed and a symbolic batch.

    python -m resnet_tpu_torch.tools.serving_pod_probe [--serve-devices 8]
        [--batch-per-chip 128] [--artifact PREFIX]
    python -m resnet_tpu_torch.tools.serving_pod_probe --quick --device cpu

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from collections import Counter
from typing import Dict

import torch

from resnet_tpu_torch import config as C
from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.op_count import OpCounter, is_collective

PRESETS = ("imagenet_resnet50", "imagenet_resnext50", "cifar10_resnet18")
GIB = 1 << 30


def collective_ops(exported: torch.export.ExportedProgram) -> Dict[str, int]:
    """Every call of an op in a c10d namespace, by op, in the exported
    graph and in the graphs nested in it (the branches and bodies of
    control-flow operators)."""
    found: Counter = Counter()
    for gm in exported.graph_module.modules():
        if not isinstance(gm, torch.fx.GraphModule):
            continue
        for node in gm.graph.nodes:
            ns = getattr(node.target, "namespace", None)
            if node.op == "call_function" and ns and is_collective(ns):
                found[str(node.target)] += 1
    return dict(found)


def audit_artifact(prefix: str, device, batch: int) -> dict:
    """The audit (module docstring) of the artifact at ``prefix``, one
    copy of its program run on ``device`` at ``batch`` images."""
    from torch.export.passes import move_to_device_pass
    extra = {"num_devices": ""}
    exported = torch.export.load(prefix + ".pt2", extra_files=extra)
    found = collective_ops(exported)
    with open(prefix + ".json") as f:
        manifest = json.load(f)
    h, w, c = manifest["input"]["shape"][1:]
    program = move_to_device_pass(exported, device).module()
    images = torch.zeros((batch, h, w, c), dtype=torch.uint8, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    with torch.inference_mode(), OpCounter() as counter:
        logits = program(images)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return {
        "network": [manifest["network"], manifest["depth"],
                    manifest["num_classes"]],
        "num_devices": int(extra["num_devices"] or 1),
        "input_shape": manifest["input"]["shape"],
        "per_chip_batch": batch,
        "collective_op_counts": found,
        "collective_free": not found,
        "ops_dispatched": len(counter.device_ops()),
        "flops_per_device_per_batch": counter.flops,
        "hbm_per_device_gb": (
            torch.cuda.max_memory_allocated(device) / GIB
            if device.type == "cuda" else "not measured (cpu)"),
        "logits_shape": list(logits.shape),
        "finite_logits": bool(torch.isfinite(logits).all()),
        "device": str(device),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="imagenet_resnet50", choices=PRESETS)
    p.add_argument("--serve-devices", type=int, default=8,
                   help="devices of the exported artifact (8: the device "
                        "count of the JAX tool's default v5e:2x4)")
    p.add_argument("--batch-per-chip", type=int, default=128,
                   help="serving batch a card")
    p.add_argument("--artifact", default="",
                   help="audit this exported artifact (PREFIX.pt2 and "
                        "PREFIX.json) instead of exporting one")
    p.add_argument("--quick", action="store_true",
                   help="CIFAR ResNet-20, 8 images a card")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def probe(args) -> dict:
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.utils.serving import export_serving
    device = resolve_device(args.device)
    cfg = getattr(C, args.preset)()
    batch = args.batch_per_chip
    if args.quick:
        cfg = C.cifar10_resnet18()
        cfg.model.depth = 20
        batch = min(batch, 8)
    with tempfile.TemporaryDirectory(prefix="serving_pod_") as tmp:
        prefix = args.artifact
        if not prefix:
            prefix = os.path.join(tmp, "serve")
            export_serving(cfg, get_model(cfg), prefix,
                           num_devices=args.serve_devices)
        report = audit_artifact(prefix, device, batch)
    source = "cifar10_resnet18(quick)" if args.quick else args.preset
    report["artifact"] = (args.artifact
                          or f"exported from {source} (random weights)")
    return report


def main(argv=None) -> int:
    print(json.dumps(probe(build_parser().parse_args(argv))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
