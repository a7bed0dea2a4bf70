"""Train and eval steps, port of ``resnet_tpu/train/steps.py``.

The JAX package compiles a step into one XLA program; here a step runs
eagerly: augmentation (the fused kernel), forward, autograd backward, the
in-place optimizer update and the metric sums, all left on the device.
``make_train_step(steps_per_dispatch=k)`` runs exactly k such steps in
sequence per call over batches stacked on a leading k axis and adds up
their metric sums, as the JAX K-step scan does. While a profiler records,
a call runs inside the ``train.call`` span and each step's five phases
inside ``train.augment``, ``train.forward``, ``train.backward``,
``train.optimizer`` and ``train.metrics`` (``utils/profiler.py``).

Data parallelism: one process per device, ``group`` the
``torch.distributed`` process group of the replicas, each holding a
contiguous block of the global batch (``parallel/mesh.py``). Without a
group a step is the single-device step. With one, the JAX package's modes:

  - ``dp_mode="shard_map"``: per-replica BatchNorm; the gradients are
    averaged over the group (in ``comm_dtype`` when given, bf16 say: cast,
    sum and divide in it, cast back), then the new BN running statistics,
    and the metric sums are summed; then the update.
  - ``dp_mode="jit"`` (GSPMD, ``sync_bn``): the model's BatchNorms take
    global-batch statistics (their ``group``, set when the model is
    built); the gradients are averaged (the global loss is the mean of
    the replicas' equal-sized local means) and the metric sums summed.
  - ``dp_sync="dispatch"`` (shard_map only): the k steps of a call run
    without any reduction, then ``sync_state`` averages every float
    tensor of params, momentum and BN running statistics, and the metric
    sums are summed once. The update is linear in the gradient, so k=1
    equals step-sync.

Augmentation randomness: the generator of a step derives from (seed,
step); under ``shard_map`` each replica folds in its rank, under ``jit``
every replica draws the global batch's values and keeps its block, as the
JAX package samples the sharded global batch once.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from resnet_tpu_torch.ops.metrics import cross_entropy_loss, metric_sums
from resnet_tpu_torch.train.state import TrainState
from resnet_tpu_torch.utils.profiler import span

DP_MODES = ("shard_map", "jit")


def step_generator(seed: int, step: int, device,
                   rank: Optional[int] = None) -> torch.Generator:
    """The augmentation generator of one step, seeded from (seed, step),
    so a resumed run replays the same augmentation stream; ``rank`` folds
    in the replica (``shard_map``). Rank 0's stream is the one-device
    stream: ``SeedSequence`` pads its entropy with zeros."""
    entropy = [seed, step] if rank is None else [seed, step, rank]
    mixed = np.random.SeedSequence(entropy).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0]) >> 1)


def all_reduce_(tensors: Sequence[torch.Tensor], group,
                comm_dtype: Optional[torch.dtype] = None) -> None:
    """Average ``tensors`` over ``group`` in place, in one collective over
    a flat buffer of ``comm_dtype`` (default their own dtype): the sum,
    then the division in that dtype, as ``lax.pmean`` does."""
    tensors = list(tensors)
    if not tensors:
        return
    dtype = comm_dtype or tensors[0].dtype
    flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()


def sum_metrics(metrics: Dict[str, torch.Tensor],
                group) -> Dict[str, torch.Tensor]:
    """Metric sums added up over ``group`` (a new dict)."""
    names = list(metrics)
    both = torch.stack([metrics[k].float() for k in names])
    dist.all_reduce(both, group=group)
    return dict(zip(names, both.unbind(0)))


def _float_buffers(model: torch.nn.Module) -> List[torch.Tensor]:
    return [b for b in model.buffers() if b.is_floating_point()]


@torch.no_grad()
def sync_state(state: TrainState, group) -> TrainState:
    """Average every float tensor of params, momentum and BN running
    statistics over ``group``, in float32 (``dp_sync="dispatch"``'s one
    state reduction a call). The step count is an int on every replica
    and passes through."""
    params = [p.detach() for p in state.model.parameters()]
    all_reduce_(params + list(state.momentum)
                + _float_buffers(state.model), group)
    return state


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               label_smooth: float = 0.0,
               augment_fn: Optional[Callable] = None,
               group=None, dp_mode: str = "shard_map",
               comm_dtype: Optional[torch.dtype] = None,
               grad_sync: bool = True):
    """One SGD step on ``batch`` (``image``, ``label``, optional ``dims``,
    and optional ``rows``, the augmenter's per-image values). Updates
    ``state`` in place; returns ``(state, metric sums)``. With ``group``,
    the data-parallel step of ``dp_mode`` (module docstring);
    ``grad_sync=False`` leaves out every reduction (``dp_sync="dispatch"``
    makes them at the end of the call)."""
    images, labels = batch["image"], batch["label"]
    if augment_fn is not None:
        with span("train.augment"):
            replica, rank = None, None
            if group is not None:
                if dp_mode == "jit":
                    replica = (dist.get_rank(group),
                               dist.get_world_size(group))
                else:
                    rank = dist.get_rank(group)
            gen = step_generator(state.seed, state.step, images.device, rank)
            kw = {} if replica is None else {"replica": replica}
            images = augment_fn(images, gen, batch.get("dims"),
                                batch.get("rows"), **kw)
    model = state.model
    model.train()
    with span("train.forward"):
        logits = model(images)
        loss = cross_entropy_loss(logits, labels, label_smooth)
    with span("train.backward"):
        grads = torch.autograd.grad(loss, list(model.parameters()))
    sync = group is not None and grad_sync
    if sync:
        all_reduce_(grads, group, comm_dtype=comm_dtype)
        if dp_mode == "shard_map":
            # per-replica statistics refreshed per-replica running stats:
            # keep the replicas' copies equal
            with torch.no_grad():
                all_reduce_(_float_buffers(model), group)
    with span("train.optimizer"):
        state.apply_gradients(grads)
    with torch.no_grad(), span("train.metrics"):
        metrics = metric_sums(logits, labels, loss)
        if sync:
            metrics = sum_metrics(metrics, group)
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
                    steps_per_dispatch: int = 1, group=None,
                    dp_mode: str = "shard_map",
                    comm_dtype: Optional[torch.dtype] = None,
                    dp_sync: str = "step") -> Callable:
    """``f(state, batch) -> (state, metrics)``; with
    ``steps_per_dispatch=k > 1``, ``f(state, batches)`` where every batch
    entry has a leading k axis, running k steps in order and returning
    their summed metrics. ``group``, ``dp_mode``, ``comm_dtype`` and
    ``dp_sync`` select the data-parallel step (module docstring)."""
    k = steps_per_dispatch
    if k < 1:
        raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
    if dp_sync not in ("step", "dispatch"):
        raise ValueError(f"unknown dp_sync {dp_sync!r}")
    if dp_mode not in DP_MODES:
        raise ValueError(f"unknown dp_mode {dp_mode!r}")
    dispatch_sync = group is not None and dp_sync == "dispatch"
    if dispatch_sync and dp_mode != "shard_map":
        # global-batch BatchNorm reduces inside every step: there is no
        # "skip the gradient reduce, average the state later" schedule
        raise ValueError("dp_sync='dispatch' requires --dp-mode shard_map")
    step = partial(train_step, label_smooth=label_smooth,
                   augment_fn=augment_fn, group=group, dp_mode=dp_mode,
                   comm_dtype=comm_dtype, grad_sync=not dispatch_sync)

    def multi(state, batches):
        if k == 1:
            state, total = step(state, batches)
        else:
            for name, v in batches.items():
                if v.shape[0] != k:
                    raise ValueError(f"batch entry {name!r} has leading "
                                     f"size {v.shape[0]}, expected {k}")
            total = None
            for i in range(k):
                state, m = step(state, {name: v[i]
                                        for name, v in batches.items()})
                total = m if total is None else {
                    name: total[name] + m[name] for name in m}
        if dispatch_sync:
            # k local steps, then one state reduction and the deferred
            # metric sum
            state = sync_state(state, group)
            total = sum_metrics(total, group)
        return state, total

    run = step if k == 1 and not dispatch_sync else multi

    def call(state, batches):
        with span("train.call"):
            return run(state, batches)

    return call
