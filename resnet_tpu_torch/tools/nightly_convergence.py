"""Convergence nightly, port of ``tools/nightly_convergence.py``: trains
CIFAR ResNet-18 on the separable synthetic dataset (10240 in-memory
examples, batch 256, lr 0.1 stepped at 1/2 and 3/4 of the epochs) and
fails unless validation accuracy crosses the bar.

    python -m resnet_tpu_torch.tools.nightly_convergence [--epochs 10] \\
        [--bar 0.98] [--bn-ema]
    python -m resnet_tpu_torch.tools.nightly_convergence --device cpu

Runs on the card unless ``--device cpu``; without a card it raises.
Exit code 0 iff converged.
"""

from __future__ import annotations

import argparse
import sys

from resnet_tpu_torch.config import Config, cifar10_resnet18


def make_cfg(epochs: int = 10, depth: int = 18,
             bn_ema: bool = False) -> Config:
    """The nightly's configuration (the JAX tool's, field for field)."""
    cfg = cifar10_resnet18()
    cfg.model.depth = depth
    cfg.data.num_examples = 10240
    cfg.train.batch_size = 256
    cfg.train.num_epochs = epochs
    cfg.train.lr = 0.1
    cfg.train.lr_steps = (epochs // 2, 3 * epochs // 4)
    cfg.train.frequent = 20
    cfg.train.model_prefix = ""
    cfg.train.bn_ema = bn_ema
    return cfg


def converge(cfg: Config, device=None) -> dict:
    """Fit ``cfg`` and return the last epoch's validation metrics."""
    from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
    from resnet_tpu_torch.train.solver import Solver

    solver = Solver(cfg, device=device)
    state = solver.fit(make_train_iter(cfg), None)
    return solver.validate(state, make_val_iter(cfg),
                           cfg.train.num_epochs - 1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--bar", type=float, default=0.98)
    p.add_argument("--depth", type=int, default=18)
    p.add_argument("--bn-ema", action="store_true",
                   help="run the shipped bn-ema program (2-epoch "
                        "batch-stats warmup + frozen-variance switch)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    m = converge(make_cfg(args.epochs, args.depth, args.bn_ema), args.device)
    ok = m["accuracy"] >= args.bar
    print(f"convergence {'PASS' if ok else 'FAIL'}: "
          f"val accuracy {m['accuracy']:.4f} (bar {args.bar})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
