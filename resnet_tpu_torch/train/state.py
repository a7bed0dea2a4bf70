"""Train state: the model (params and BN running stats), the step count,
the momentum buffers, the seed and the optimizer. Port of
``resnet_tpu/train/state.py``; unlike the JAX state it is updated in
place."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch

from resnet_tpu_torch.config import Config
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.models.resnet import ResNet
from resnet_tpu_torch.train.optim import MXNetSGD
from resnet_tpu_torch.train.schedule import schedule_from_config
from resnet_tpu_torch.utils.device import resolve_device


@dataclass
class TrainState:
    model: ResNet
    step: int
    momentum: List[torch.Tensor]   # one buffer per model.parameters() entry
    seed: int                      # per-step generators derive from it
    tx: MXNetSGD

    def apply_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """One optimizer update in place; advances ``step``."""
        self.tx.update_(list(self.model.parameters()), list(grads),
                        self.momentum, self.step)
        self.step += 1


def create_train_state(cfg: Config, device=None,
                       model: Optional[ResNet] = None) -> TrainState:
    """Build the model (MSRA init from ``cfg.train.seed``, or ``model`` as
    given), move it to ``device`` in ``channels_last`` memory, and set up
    MXNet SGD with the configured schedule; bn-ema adds the radial
    projection. ``device=None`` means the CUDA card."""
    device = resolve_device(device)
    if model is None:
        model = get_model(cfg)
    model = model.to(device=device, memory_format=torch.channels_last)
    t = cfg.train
    tx = MXNetSGD(schedule_from_config(cfg), momentum=t.mom,
                  weight_decay=t.wd, nesterov=t.optimizer == "nag",
                  project=t.bn_ema and t.bn_ema_project)
    return TrainState(model=model, step=0,
                      momentum=[torch.zeros_like(p)
                                for p in model.parameters()],
                      seed=t.seed, tx=tx)
