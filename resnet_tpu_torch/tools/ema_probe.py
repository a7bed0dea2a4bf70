"""Probe: the bn-ema convergence configuration (clamp / warmup /
projection), port of ``tools/ema_probe.py``.

Trains depth-18 ResNet with the ImageNet stem at 32x32 on the 3-class
stripe dataset (``tools/stripes.py``) through the record pipeline and
``Solver.fit``, with one bn-ema variant, and prints one JSON line: the
validation accuracy and cross-entropy. The record pipeline decodes with
the C++ pool where it builds, else with Pillow (``data/native.py`` logs
which); on the card the augmentation runs in K1.

    python -m resnet_tpu_torch.tools.ema_probe [--clamp 2] [--warmup -1] \\
        [--no-project] [--epochs 6] [--data DIR] [--seed 0]
    python -m resnet_tpu_torch.tools.ema_probe --device cpu

Runs on the card unless ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from resnet_tpu_torch.config import Config


def make_cfg(root: str, epochs: int = 6, clamp: float = 2.0,
             warmup: int = -1, project: bool = True, seed: int = 0) -> Config:
    """The probe's configuration (the JAX tool's, field for field, at
    ``seed=0``)."""
    cfg = Config()
    cfg.model.depth = 18
    cfg.model.dataset = "imagenet"
    cfg.model.bn_mom = 0.5
    cfg.data.num_classes = 3
    cfg.data.num_examples = 120
    cfg.data.image_shape = (32, 32, 3)
    cfg.data.data_dir = str(root)
    cfg.data.train_rec = "train"
    cfg.data.val_rec = "val.rec"
    cfg.data.pipeline = "record"
    cfg.data.preprocess_threads = 2
    cfg.data.min_random_area = 0.5
    cfg.train.batch_size = 24
    cfg.train.num_epochs = epochs
    cfg.train.lr = 0.05
    cfg.train.lr_steps = (4, 5)
    cfg.train.frequent = 5
    cfg.train.model_prefix = ""
    cfg.train.bn_ema = True
    cfg.train.bn_ema_clamp = clamp
    cfg.train.bn_ema_warmup = warmup
    cfg.train.bn_ema_project = project
    cfg.train.seed = seed
    return cfg


def probe(args) -> dict:
    """Build the data unless ``args.data`` names it, fit, validate; the
    JSON line's fields."""
    from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
    from resnet_tpu_torch.tools.stripes import build_stripe_tree
    from resnet_tpu_torch.train.solver import Solver
    from resnet_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)   # no card: raise before the data
    root = args.data or build_stripe_tree(tempfile.mkdtemp(prefix="conv"))
    cfg = make_cfg(root, args.epochs, args.clamp, args.warmup, args.project,
                   args.seed)
    solver = Solver(cfg, device=device)
    state = solver.fit(make_train_iter(cfg), None)
    m = solver.validate(state, make_val_iter(cfg), cfg.train.num_epochs - 1)
    return {
        "clamp": args.clamp, "warmup": args.warmup,
        "project": args.project, "epochs": args.epochs,
        "val_accuracy": round(float(m["accuracy"]), 4),
        "val_ce": round(float(m.get("cross-entropy", float("nan"))), 4),
        "data": str(root),
    }


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clamp", type=float, default=2.0)
    p.add_argument("--warmup", type=int, default=-1)
    p.add_argument("--project", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--epochs", type=int, default=6)
    p.add_argument("--data", default="",
                   help="existing shard tree (default: build a fresh one)")
    p.add_argument("--seed", type=int, default=0,
                   help="init and augmentation seed (the JAX tool runs 0)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None):
    print(json.dumps(probe(build_parser().parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
