"""What the deployment tools share: the command line (the training flags,
``--device`` among them) and the loading rule of a trained checkpoint."""

from __future__ import annotations

import os
import sys
from typing import Sequence, Tuple

import torch

from resnet_tpu_torch.config import (Config, build_parser, config_from_args,
                                     require_ported)
from resnet_tpu_torch.train import checkpoint as ckpt
from resnet_tpu_torch.train.state import TrainState, create_train_state
from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.export import load_mxnet_checkpoint
from resnet_tpu_torch.utils.symbol_export import config_from_symbol


def tool_config(argv: Sequence[str]) -> Tuple[Config, torch.device]:
    """The training flags -> (config, device). The device is the CUDA card
    unless ``--device cpu`` asks for the CPU; without a card this
    raises."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    require_ported(cfg)
    return cfg, resolve_device(args.device)


def load_trained(cfg: Config, device, use_symbol: bool = True
                 ) -> Tuple[Config, TrainState]:
    """The train state of ``--model-prefix`` at ``--load-epoch``.

    ``{prefix}-symbol.json``, where it exists and ``use_symbol`` is set,
    gives the network (``mx.model.load_checkpoint`` returns the symbol
    with the weights, so the user does not name the network again). The
    weights come from the port's checkpoint of that epoch, else from
    ``{prefix}-NNNN.params`` where only that exists."""
    t = cfg.train
    sym_json = f"{t.model_prefix}-symbol.json"
    if use_symbol and os.path.exists(sym_json):
        cfg = config_from_symbol(cfg, sym_json)
        print(f"# model config from {sym_json}: "
              f"{cfg.model.network}-{cfg.model.depth} v{cfg.model.version} "
              f"classes={cfg.data.num_classes}", file=sys.stderr)
    state = create_train_state(cfg, device=device)
    mx_params = f"{t.model_prefix}-{t.load_epoch:04d}.params"
    if (not ckpt.has_epoch(t.model_prefix, t.load_epoch)
            and os.path.exists(mx_params)):
        load_mxnet_checkpoint(t.model_prefix, t.load_epoch, state)
    else:
        ckpt.load_checkpoint(t.model_prefix, t.load_epoch, state)
    return cfg, state
