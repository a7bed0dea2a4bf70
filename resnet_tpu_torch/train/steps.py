"""Train and eval steps, port of ``resnet_tpu/train/steps.py`` for one
device.

The JAX package compiles a step into one XLA program; here a step runs
eagerly: augmentation (the fused kernel), forward, autograd backward, the
in-place optimizer update and the metric sums, all left on the device.
``make_train_step(steps_per_dispatch=k)`` runs exactly k such steps in
sequence per call over batches stacked on a leading k axis and adds up
their metric sums, as the JAX K-step scan does.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, Optional

import numpy as np
import torch

from resnet_tpu_torch.ops.metrics import cross_entropy_loss, metric_sums
from resnet_tpu_torch.train.state import TrainState


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The augmentation generator of one step, seeded from (seed, step), so
    a resumed run replays the same augmentation stream."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               label_smooth: float = 0.0,
               augment_fn: Optional[Callable] = None):
    """One SGD step on ``batch`` (``image``, ``label``, optional ``dims``,
    and optional ``rows``, the augmenter's per-image values). Updates
    ``state`` in place; returns ``(state, metric sums)``."""
    images, labels = batch["image"], batch["label"]
    if augment_fn is not None:
        gen = step_generator(state.seed, state.step, images.device)
        images = augment_fn(images, gen, batch.get("dims"), batch.get("rows"))
    model = state.model
    model.train()
    logits = model(images)
    loss = cross_entropy_loss(logits, labels, label_smooth)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    state.apply_gradients(grads)
    with torch.no_grad():
        metrics = metric_sums(logits, labels, loss)
    return state, metrics


@torch.no_grad()
def eval_step(state: TrainState, batch: Dict[str, torch.Tensor],
              preprocess_fn: Optional[Callable] = None):
    """Validation forward with running-stats BN, and the metric sums;
    ``mask`` (N,) excludes padding examples."""
    images, labels = batch["image"], batch["label"]
    mask = batch.get("mask")
    if preprocess_fn is not None:
        images = preprocess_fn(images)
    state.model.eval()
    logits = state.model(images)
    loss = cross_entropy_loss(logits, labels, mask=mask)
    return metric_sums(logits, labels, loss, mask=mask)


def make_train_step(label_smooth: float = 0.0,
                    augment_fn: Optional[Callable] = None,
                    steps_per_dispatch: int = 1) -> Callable:
    """``f(state, batch) -> (state, metrics)``; with
    ``steps_per_dispatch=k > 1``, ``f(state, batches)`` where every batch
    entry has a leading k axis, running k steps in order and returning
    their summed metrics."""
    k = steps_per_dispatch
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    step = partial(train_step, label_smooth=label_smooth,
                   augment_fn=augment_fn)
    if k == 1:
        return step

    def multi(state, batches):
        for name, v in batches.items():
            if v.shape[0] != k:
                raise ValueError(f"batch entry {name!r} has leading size "
                                 f"{v.shape[0]}, expected {k}")
        total = None
        for i in range(k):
            state, m = step(state, {name: v[i] for name, v in batches.items()})
            total = m if total is None else {
                name: total[name] + m[name] for name in m}
        return state, total

    return multi
