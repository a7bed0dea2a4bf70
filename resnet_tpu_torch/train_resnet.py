"""Training entry point, port of ``train_resnet.py``.

Parse the command line (the JAX package's flags over its presets), join
the process group when the launcher started this process, build this
rank's share of the train and val iterators and the Solver, fit, and
leave the group. Runs on the CUDA card (NCCL between ranks) unless
``--device cpu`` asks for the CPU (gloo); without a card it raises.
``--xla-opts`` sets the backend switches (``utils/xla_opts.py``); by
default on the card cuDNN times its algorithms once per shape
(``cudnn.benchmark``) unless the caller turned on
``torch.use_deterministic_algorithms``, and ``--xla-opts off`` leaves it
off.

Examples:
    python -m resnet_tpu_torch.train_resnet --preset imagenet_resnet50 \\
        --pipeline record --data-dir /data/imagenet
    python -m resnet_tpu_torch.train_resnet --preset imagenet_resnet50 \\
        --pipeline record --data-dir /data/imagenet --auto-resume
    python -m resnet_tpu_torch.tools.launch -n 8 -- \\
        python -m resnet_tpu_torch.train_resnet \\
        --preset imagenet_resnet152_dp --num-devices 8 --batch-size 1024 \\
        --pipeline record --data-dir /data/imagenet
"""

from __future__ import annotations

import sys

from resnet_tpu_torch.config import build_parser, config_from_args
from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
from resnet_tpu_torch.parallel.dist import (finalize_distributed,
                                            maybe_init_distributed,
                                            proc_info)
from resnet_tpu_torch.train.solver import Solver
from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                             compiler_options)


def main(argv=None):
    """Train as the command line says; returns the final train state.
    SIGTERM saves a mid-epoch checkpoint and exits with code 143."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    t = cfg.train
    maybe_init_distributed(args.device)
    num_parts, part_index = proc_info()
    solver = Solver(cfg, device=args.device,
                    log_file=f"{t.model_prefix}.log" if t.model_prefix
                    else None)
    solver.log.info("config: %s", cfg)
    # the switches belong to the process: set once, before any step
    apply_backend_options(compiler_options(t.xla_opts or None,
                                           solver.device.type))
    state = solver.fit(make_train_iter(cfg, num_parts, part_index),
                       make_val_iter(cfg, num_parts, part_index))
    # ranks finish at different times: leave the group together
    finalize_distributed()
    return state


if __name__ == "__main__":
    main(sys.argv[1:])
