"""LR schedules: multi-factor step decay with linear warmup, port of
``resnet_tpu/train/schedule.py`` (ref:core/scheduler.py
``WarmupMultiFactorScheduler``), in the iteration domain.

The schedule is evaluated on the host, once per step; it rounds as the JAX
schedule does, in float32, so both frameworks feed the optimizer the same
learning rate.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from resnet_tpu_torch.config import Config


def warmup_multifactor(base_lr: float, steps: Sequence[int],
                       factor: float = 0.1, warmup: bool = False,
                       warmup_lr: float = 0.0, warmup_steps: int = 0
                       ) -> Callable[[int], float]:
    """step -> lr. ``steps`` are absolute iteration numbers: lr =
    base_lr·factor^(#steps passed); during warmup a linear ramp from
    warmup_lr to base_lr over warmup_steps."""
    steps = list(steps)
    f32 = np.float32

    def schedule(count: int) -> float:
        n_passed = sum(count >= s for s in steps)
        lr = f32(base_lr) * f32(factor) ** f32(n_passed)
        if warmup and warmup_steps > 0 and count < warmup_steps:
            frac = min(f32(count) / f32(warmup_steps), f32(1.0))
            lr = f32(warmup_lr) + f32(base_lr - warmup_lr) * frac
        return float(lr)

    return schedule


def schedule_from_config(cfg: Config) -> Callable[[int], float]:
    """Epoch-domain config -> iteration-domain schedule
    (ref:train_resnet.py: steps = [e * num_examples // batch_size])."""
    t, d = cfg.train, cfg.data
    steps_per_epoch = max(d.num_examples // t.batch_size, 1)
    steps = [e * steps_per_epoch for e in t.lr_steps]
    return warmup_multifactor(
        base_lr=t.lr, steps=steps, factor=t.lr_factor, warmup=t.warmup,
        warmup_lr=t.warmup_lr, warmup_steps=t.warmup_epochs * steps_per_epoch)
