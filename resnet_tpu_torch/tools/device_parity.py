"""Cross-device parity check, port of ``tools/device_parity.py``: the same
fixed-seed training on the CPU and on the card, compared.

What is compared and why:
  - the first step's loss (``--loss-atol``): the forward path;
  - the first step's parameter deltas, pointwise (per parameter, the max
    abs difference over the CPU delta's largest entry, ``--delta-rtol``):
    the backward pass and the optimizer, before chaos can compound;
  - after ``--steps`` SGD steps both devices must have brought the loss
    below ``--learn-frac`` of the first (tail-averaged).
Multi-step trajectories are not compared pointwise: through ReLU kinks a
1e-6 perturbation of the start on one device parts them as far as the two
devices do (the JAX tool's measurement).

Both legs start from one state, initialised once on the CPU and copied to
the card, and see the same CIFAR pad-crop draws: each step's draws come
from a CPU generator seeded with the step's index and are moved to the
device as the augmenter's per-image rows. ``--precision float32`` turns
TF32 off (``utils/device.set_tf32``), so the card computes in float32 as
the CPU does; ``default`` leaves cuDNN's TF32 on.

    python -m resnet_tpu_torch.tools.device_parity [--depth 20] [--steps 60]

With no card it prints "only CPU present" and exits 0. Exit 0 iff every
gate passes.
"""

from __future__ import annotations

import argparse
import copy
import sys
from typing import Dict, List, Tuple

import numpy as np
import torch

from resnet_tpu_torch.config import Config

Deltas = Dict[str, np.ndarray]


def make_cfg(depth: int = 20, batch: int = 16) -> Config:
    """The parity run's configuration (the JAX tool's, field for field)."""
    cfg = Config()
    cfg.model.depth = depth
    cfg.model.dataset = "cifar10"
    cfg.data.num_classes = 10
    cfg.data.num_examples = batch * 4
    cfg.data.image_shape = (32, 32, 3)
    cfg.train.batch_size = batch
    cfg.train.lr = 0.05
    return cfg


def make_batches(batch: int) -> List[dict]:
    """Four host batches of ``synthetic_cifar`` (seed 0)."""
    from resnet_tpu_torch.data.loader import synthetic_cifar
    images, labels = synthetic_cifar(batch * 4, 10, (32, 32, 3), seed=0)
    return [{"image": images[i * batch:(i + 1) * batch],
             "label": labels[i * batch:(i + 1) * batch]} for i in range(4)]


def run_leg(cfg: Config, model: torch.nn.Module, batches: List[dict],
            steps: int, device) -> Tuple[List[float], Deltas]:
    """``steps`` SGD steps on ``device`` from a copy of ``model`` (a CPU
    module); returns the losses and the first step's parameter deltas."""
    from resnet_tpu_torch.ops.augment import sample_cifar_rows
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step

    state = create_train_state(cfg, device=device,
                               model=copy.deepcopy(model))
    before = {n: p.detach().cpu().numpy().copy()
              for n, p in state.model.named_parameters()}
    step = make_train_step(augment_fn=make_augment_fn(cfg))
    losses, deltas = [], {}
    for i in range(steps):
        host = batches[i % len(batches)]
        rows = sample_cifar_rows(torch.Generator().manual_seed(i), cfg.data,
                                 len(host["label"]))
        batch = {"image": torch.from_numpy(host["image"]).to(device),
                 "label": torch.from_numpy(host["label"]).to(device),
                 "rows": rows.to(device)}
        state, metrics = step(state, batch)
        if i == 0:
            deltas = {n: p.detach().cpu().numpy() - before[n]
                      for n, p in state.model.named_parameters()}
        losses.append(float(metrics["loss_sum"]) / float(metrics["count"]))
    return losses, deltas


def worst_delta(cpu: Deltas, other: Deltas) -> Tuple[float, str]:
    """max over parameters of max|d_cpu - d_other| / max|d_cpu|, and the
    parameter where it is reached (0.0 and "" when they are equal)."""
    worst, where = 0.0, ""
    for name, dc in cpu.items():
        scale = np.abs(dc).max() + 1e-12
        rel = float(np.abs(dc - other[name]).max() / scale)
        if rel > worst:
            worst, where = rel, name
    return worst, where


def parity(args) -> dict:
    """Both legs and the three gates; the result as a dict."""
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.utils.xla_opts import apply_backend_options

    cfg = make_cfg(args.depth, args.batch)
    batches = make_batches(args.batch)
    model = get_model(cfg)   # initialised once, on the CPU
    results, deltas = {}, {}
    restore = apply_backend_options(
        {"tf32": "0"} if args.precision == "float32" else None)
    try:
        for name in ("cpu", "cuda"):
            results[name], deltas[name] = run_leg(cfg, model, batches,
                                                  args.steps, name)
            print(f"{name}: first-step loss {results[name][0]:.6f}, after "
                  f"{args.steps} steps {results[name][-1]:.6f}")
    finally:
        restore()
    c, t = results["cpu"], results["cuda"]
    first_diff = abs(c[0] - t[0])
    worst, worst_name = worst_delta(deltas["cpu"], deltas["cuda"])
    tail = max(1, args.steps // 5)   # damp batch-to-batch noise
    c_end, t_end = sum(c[-tail:]) / tail, sum(t[-tail:]) / tail
    gates = {
        "first_step_loss": first_diff < args.loss_atol,
        "param_delta": worst < args.delta_rtol,
        "learns": (c_end < args.learn_frac * c[0]
                   and t_end < args.learn_frac * t[0]),
    }
    print(f"one-step param-delta max rel diff {worst:.2e} at {worst_name} "
          f"(gate {args.delta_rtol})")
    ok = all(gates.values())
    print(f"parity {'PASS' if ok else 'FAIL'}: first-step diff "
          f"{first_diff:.2e} (atol {args.loss_atol}); delta gate "
          f"{'ok' if gates['param_delta'] else 'FAIL'}; tail loss cpu "
          f"{c_end:.3f} / cuda {t_end:.3f} (must be < {args.learn_frac} x "
          f"initial {c[0]:.3f})")
    return dict(ok=ok, gates=gates, first_step_loss_diff=first_diff,
                worst_delta_rel=worst, worst_delta_param=worst_name,
                first_loss={"cpu": c[0], "cuda": t[0]},
                tail_loss={"cpu": c_end, "cuda": t_end},
                precision=args.precision, steps=args.steps)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--depth", type=int, default=20)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--loss-atol", type=float, default=5e-3)
    p.add_argument("--delta-rtol", type=float, default=5e-2,
                   help="gate on max |d_cpu - d_card| / max|d_cpu| per "
                        "parameter, d = the first step's parameter delta")
    p.add_argument("--precision", choices=["float32", "default"],
                   default="float32",
                   help="float32: TF32 off on the card, so both devices "
                        "compute in float32; default: cuDNN's TF32 on")
    p.add_argument("--learn-frac", type=float, default=0.5,
                   help="final loss must be below this fraction of initial")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not torch.cuda.is_available():
        print("only CPU present — nothing to compare")
        return 0
    return 0 if parity(args)["ok"] else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
