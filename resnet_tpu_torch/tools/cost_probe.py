"""FLOPs and bytes of one train step, by variant. Port of
``tools/cost_probe.py``.

The JAX tool asks XLA's ``cost_analysis()`` of the compiled train step of
``Config()`` (ResNet-50, bf16) for its FLOPs and bytes accessed, for each
``unit_chain`` variant (``off``, ``xla``, ``pallas``), and prints the HBM
roof those bytes set. The port compiles no program: it runs one step of
``train/steps.py::make_train_step`` per variant under
``utils/op_count.py``'s ``OpCounter`` and reports

  - ``flops`` (the aten conv/matmul formulas plus the hand-written matrix
    kernels' products) and ``conv_mm_flops``, beside
    ``analytic_conv_mm_flops``: ``2·MAC`` of every convolution and the
    fc from the network's shapes, forward, the weight gradient, and the
    input gradient of every layer but the first;
  - two byte counts kept apart: ``eager_bytes``, what the dispatched aten
    ops read and write, and ``kernel_bytes``, the bound bytes of the
    hand-written kernels' launches (K1 on the card, K4f and K4b in the
    ``pallas`` variant). A fusing compiler keeps much of the eager
    traffic on chip; the difference is the eager path's cost;
  - ``roof_ms``: their sum over the H100's 3.35 TB/s (data sheet), the
    least time the step's traffic takes on the card.

One JSON line a variant. The augmenter is the train step's own
(``make_augment_fn``: K1 on the card) unless ``--no-augment``.

    python -m resnet_tpu_torch.tools.cost_probe [--variants off,xla,pallas]
        [--batch 256] [--bn-subsample 1] [--remat-policy none]
        [--xla-opts cudnn_benchmark=0] [--no-augment]
    python -m resnet_tpu_torch.tools.cost_probe --device cpu --batch 2

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from typing import Dict, List, Optional

import torch

from resnet_tpu_torch.config import Config
from resnet_tpu_torch.ops.augment_fused import make_augment_fn
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.train.steps import make_train_step
from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.op_count import OpCounter

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3, data sheet
VARIANTS = ("off", "xla", "pallas")


def zero_batch(cfg: Config, n: int, device) -> Dict[str, torch.Tensor]:
    """``n`` zero uint8 images at ``image_shape`` and zero labels, the JAX
    tool's batch."""
    h, w, c = cfg.data.image_shape
    return {"image": torch.zeros((n, h, w, c), dtype=torch.uint8,
                                 device=device),
            "label": torch.zeros((n,), dtype=torch.int64, device=device)}


def analytic_conv_mm_flops(cfg: Config) -> int:
    """``2·MAC`` of a train step's convolutions and fc at ``cfg``'s batch,
    from the shapes one CPU forward of a single image through the
    network (its ``unit_chain="off"`` form) shows: the forward, the
    weight gradient, and the input gradient of every layer but the first
    (whose input needs none)."""
    from resnet_tpu_torch.models.registry import get_model
    off = copy.deepcopy(cfg)
    off.train.unit_chain, off.train.fused_convbn = "off", False
    model = get_model(off).eval()
    macs = []

    def hook(mod, inputs, out):
        w = getattr(mod, "weight", None)
        if isinstance(w, torch.Tensor) and w.ndim in (2, 4):
            macs.append(out.numel() * w[0].numel())

    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        with torch.no_grad():
            model(torch.zeros((1, *cfg.data.image_shape), dtype=torch.uint8))
    finally:
        for h in handles:
            h.remove()
    return cfg.train.batch_size * 2 * (3 * sum(macs) - macs[0])


def count_step(cfg: Config, device, augment: bool = True,
               model: Optional[torch.nn.Module] = None) -> dict:
    """One train step of ``cfg`` on ``device`` under an ``OpCounter``, from
    a state with ``model``'s weights (default: initialised from
    ``cfg.train.seed``); returns the report."""
    device = resolve_device(device)
    state = create_train_state(cfg, device=device, model=model)
    n = cfg.train.batch_size
    step = make_train_step(augment_fn=make_augment_fn(cfg) if augment
                           else None)
    batch = zero_batch(cfg, n, device)
    with OpCounter() as c:
        _, metrics = step(state, batch)
    loss = float(metrics["loss_sum"] / metrics["count"])
    analytic = analytic_conv_mm_flops(cfg)
    flops, conv_mm = c.flops, c.conv_mm_flops()
    eager, kernel = c.eager_bytes(), c.kernel_bytes()
    return {
        "variant": cfg.train.unit_chain, "batch": n,
        "dtype": cfg.train.dtype, "device": str(device),
        "flops": flops, "conv_mm_flops": conv_mm,
        "analytic_conv_mm_flops": analytic,
        "conv_mm_over_analytic": conv_mm / analytic,
        "flops_by_op": c.flops_by_op(),
        "eager_bytes": eager, "kernel_bytes": kernel,
        "bytes": eager + kernel,
        "roof_ms": (eager + kernel) / HBM_BYTES_PER_S * 1e3,
        "roof_bytes_per_s": HBM_BYTES_PER_S,
        "kernel_launches": c.kernel_launches(),
        "ops_dispatched": len(c.device_ops()),
        "loss": loss,
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--variants", default=",".join(VARIANTS))
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--bn-subsample", type=int, default=1)
    p.add_argument("--remat-policy", default="none")
    p.add_argument("--xla-opts", default="",
                   help="the port's backend switches, comma list k=v "
                        "(utils/xla_opts.py), or 'off'")
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def probe(args) -> List[dict]:
    """One record a variant of ``--variants`` (``count_step`` of
    ``Config()`` at the flags), with the backend switches of
    ``--xla-opts`` set for the count and put back after."""
    from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                                 compiler_options)
    device = resolve_device(args.device)
    variants = args.variants.split(",")
    bad = [v for v in variants if v not in VARIANTS]
    if bad:
        raise ValueError(f"unknown variants {bad}; choose from {VARIANTS}")
    restore = apply_backend_options(
        compiler_options(args.xla_opts or None, backend=device.type))
    recs = []
    try:
        for variant in variants:
            cfg = Config()
            cfg.train.dtype = "bfloat16"
            cfg.train.batch_size = args.batch
            cfg.train.unit_chain = variant
            cfg.train.bn_subsample = args.bn_subsample
            cfg.train.remat_policy = args.remat_policy
            rec = count_step(cfg, device, augment=not args.no_augment)
            if device.type == "cuda":
                rec["device_name"] = torch.cuda.get_device_name(device)
            recs.append(rec)
    finally:
        restore()
    return recs


def main(argv=None) -> int:
    for rec in probe(build_parser().parse_args(argv)):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
