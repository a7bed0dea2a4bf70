"""Training entry point, port of ``train_resnet.py``.

Parse the command line (the JAX package's flags over its presets), set up
logging, build the train and val iterators and the Solver, and fit. Runs
on the CUDA card unless ``--device cpu`` asks for the CPU; without a card
it raises.

Examples:
    python -m resnet_tpu_torch.train_resnet --preset imagenet_resnet50 \\
        --pipeline record --data-dir /data/imagenet
    python -m resnet_tpu_torch.train_resnet --preset imagenet_resnet50 \\
        --pipeline record --data-dir /data/imagenet --auto-resume
"""

from __future__ import annotations

import sys

import torch

from resnet_tpu_torch.config import build_parser, config_from_args
from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
from resnet_tpu_torch.train.solver import Solver


def main(argv=None):
    """Train as the command line says; returns the final train state.
    SIGTERM saves a mid-epoch checkpoint and exits with code 143."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    t = cfg.train
    solver = Solver(cfg, device=args.device,
                    log_file=f"{t.model_prefix}.log" if t.model_prefix
                    else None)
    solver.log.info("config: %s", cfg)
    if solver.device.type == "cuda":
        # every call has the same shapes: let cuDNN time its algorithms once
        torch.backends.cudnn.benchmark = True
    return solver.fit(make_train_iter(cfg), make_val_iter(cfg))


if __name__ == "__main__":
    main(sys.argv[1:])
