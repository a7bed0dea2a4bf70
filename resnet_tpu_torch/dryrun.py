"""The compile-check entry and the multi-rank dry run of the
data-parallel training step, port of ``__graft_entry__.py``'s ``entry``
and ``dryrun_multichip``.

    python -m resnet_tpu_torch.dryrun entry [--device cpu]
    python -m resnet_tpu_torch.dryrun N [--device cpu]

``entry()`` returns ``(forward, (model, x))``: the ResNet-50 bf16 eval
forward of ``Config()``, its model in eval mode on the card (or where
``device`` says) and ``x``, zeros of shape ``(16, 224, 224, 3)`` float32,
NHWC as the model takes it; ``forward(model, x)`` gives the float32
logits.

``dryrun_multichip(n)`` starts ``n`` ranks of one process group, each on a
card of its own over NCCL (it raises when there are fewer than ``n``
cards), or with ``device="cpu"`` over gloo on the CPU, and each rank runs
one step (or one K-step call) of every leg on its block of a global batch:

  1. ``shard_map``: per-replica BN, averaged gradients and statistics;
  2. ``jit``: global-batch BN;
  3. bn-ema (the ``imagenet_resnet50`` preset's BN mode) under ``jit``;
  4. two steps a call under ``jit``;
  5. ``shard_map`` with the fused augmentation kernel on canvases;
  6. ``shard_map`` with ``dp_sync="dispatch"``, two local steps a call and
     one state average;
  7. the ``imagenet_resnet152_dp`` preset's mode (``jit``, bf16, remat,
     bn-ema, s2d stem fed by the kernel) at depth 50 (the same bottleneck
     units and remat, a third of them, as the JAX dry run cuts it) on
     32x32 images.

Legs 1-6 train the CIFAR ResNet of depth 8 (the smallest 6n+2 net) on
32x32 images, batch 4 a rank. Every leg checks finite metrics over the
whole global batch and replicas that hold the same parameters bit for
bit; rank 0 prints one line a leg. Any failure raises.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

from resnet_tpu_torch.config import ENV_COORD, Config

TIMEOUT_S = 900


def eval_forward(model: torch.nn.Module, images: torch.Tensor
                 ) -> torch.Tensor:
    """The model's eval-mode forward, without autograd."""
    with torch.no_grad():
        return model(images)


def forward_entry(cfg: Config, batch: int, device=None):
    """``(eval_forward, (model, x))`` for ``cfg``'s network (weights from
    ``cfg.train.seed``) in eval mode, in ``channels_last`` on ``device``
    (default: the card, raising without one), and ``x`` zeros of shape
    ``(batch, *image_shape)`` float32."""
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.utils.device import resolve_device
    device = resolve_device(device)
    model = get_model(cfg).to(device=device,
                              memory_format=torch.channels_last).eval()
    x = torch.zeros((batch, *cfg.data.image_shape), dtype=torch.float32,
                    device=device)
    return eval_forward, (model, x)


def entry(device=None):
    """(forward, example args): the ResNet-50 bf16 eval forward at batch
    16, the JAX entry's flagship (module docstring)."""
    cfg = Config()
    cfg.model.depth = 50
    cfg.train.dtype = "bfloat16"
    return forward_entry(cfg, 16, device)


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     timeout_s: float = TIMEOUT_S) -> None:
    """Run the legs over ``n_devices`` ranks (module docstring) on
    ``device``, ``"cuda"`` (one card a rank) or ``"cpu"``; raises if there
    are fewer cards than ranks, a rank fails or the run outlasts
    ``timeout_s``."""
    from resnet_tpu_torch.tools.launch import free_port, start, wait_all
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and n_devices > torch.cuda.device_count():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) needs {n_devices} CUDA devices, "
            f"found {torch.cuda.device_count()}; pass device='cpu' to run "
            f"the ranks on the CPU")
    procs = start([sys.executable, "-m", "resnet_tpu_torch.dryrun", "--rank",
                   "--device", device], n_devices,
                  f"127.0.0.1:{free_port()}")
    rc = wait_all(procs, timeout=timeout_s)
    if rc:
        raise RuntimeError(f"dryrun_multichip({n_devices}) on {device}: "
                           f"a rank exited {rc}")


def _batch(rng, n, hw, classes, canvas=None):
    side = canvas or hw
    b = {"image": torch.from_numpy(rng.integers(0, 256, (n, side, side, 3),
                                                dtype=np.uint8)),
         "label": torch.from_numpy(rng.integers(0, classes, (n,)))}
    if canvas:
        b["dims"] = torch.full((n, 4), canvas, dtype=torch.int32)
    return b


def _replicas_agree(state, group) -> bool:
    """True when every rank holds the same parameters: per-tensor sums and
    sums of squares, in float64, equal at their max and min over ranks."""
    import torch.distributed as dist
    sig = torch.stack([torch.stack([p.double().sum(),
                                    p.double().square().sum()])
                       for p in state.model.parameters()])
    hi, lo = sig.clone(), -sig
    dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=group)
    dist.all_reduce(lo, op=dist.ReduceOp.MAX, group=group)
    return bool(torch.equal(hi, -lo))


def _run_rank(device: str) -> None:
    from resnet_tpu_torch.config import cifar10_resnet18, imagenet_resnet152_dp
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.parallel.dist import (finalize_distributed,
                                                local_device,
                                                maybe_init_distributed,
                                                proc_info, world_group)
    from resnet_tpu_torch.parallel.mesh import shard_batch
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step

    maybe_init_distributed(device)
    world, rank = proc_info()
    dev = local_device(device)
    group = world_group()
    backend = torch.distributed.get_backend()
    rng = np.random.default_rng(0)

    def leg(name, cfg, dp_mode, k=1, dp_sync="step", canvas=None):
        n = cfg.train.batch_size
        hw = cfg.data.image_shape[0]
        batches = [_batch(rng, n, hw, cfg.data.num_classes, canvas)
                   for _ in range(k)]
        glob = batches[0] if k == 1 else {
            name: torch.stack([b[name] for b in batches]) for name in
            batches[0]}
        mine = {name: v.to(dev) for name, v in
                shard_batch(glob, rank, world, stacked=k > 1).items()}
        state = create_train_state(
            cfg, device=dev, bn_group=group if dp_mode == "jit" else None)
        step = make_train_step(augment_fn=make_augment_fn(cfg),
                               steps_per_dispatch=k, group=group,
                               dp_mode=dp_mode, dp_sync=dp_sync)
        state, metrics = step(state, mine)
        m = {key: float(v) for key, v in metrics.items()}
        if not all(map(np.isfinite, m.values())) or m["count"] != n * k:
            raise AssertionError(f"leg {name}: metrics {m}")
        if state.step != k or not _replicas_agree(state, group):
            raise AssertionError(f"leg {name}: replicas disagree")
        if rank == 0:
            print(f"dryrun_multichip ok ({name}, {world} ranks, {backend}):",
                  m, flush=True)

    cifar = cifar10_resnet18()
    cifar.model.depth = 8
    cifar.train.batch_size = 4 * world
    ema = cifar.replace(train=dataclasses.replace(cifar.train, bn_ema=True))
    canvas_cfg = cifar.replace(
        model=dataclasses.replace(cifar.model, dataset="imagenet", depth=18),
        data=dataclasses.replace(cifar.data, image_shape=(32, 32, 3),
                                 random_h=36, random_s=50, random_l=50))
    leg("shard_map", cifar, "shard_map")
    leg("jit", cifar, "jit")
    leg("bn-ema, jit", ema, "jit")
    leg("steps_per_dispatch=2, jit", cifar, "jit", k=2)
    leg("shard_map + augmentation kernel", canvas_cfg, "shard_map",
        canvas=40)
    leg("shard_map, dp_sync=dispatch, K=2", cifar, "shard_map", k=2,
        dp_sync="dispatch")
    pod = imagenet_resnet152_dp()
    pod.model.depth = 50
    pod.data.image_shape = (32, 32, 3)
    pod.data.num_classes = 16
    pod.train.batch_size = 2 * world
    pod.train.num_devices = world
    leg(f"pod preset imagenet_resnet152_dp @ depth {pod.model.depth}, "
        f"dp_mode={pod.train.dp_mode}, remat={pod.train.remat}, "
        f"dtype={pod.train.dtype}", pod, pod.train.dp_mode, canvas=40)
    finalize_distributed()


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n", nargs="?", default="2",
                        help="ranks (default 2), or 'entry' to run entry()")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    parser.add_argument("--rank", action="store_true",
                        help=argparse.SUPPRESS)
    a = parser.parse_args()
    if a.rank:
        if ENV_COORD not in os.environ:
            sys.exit("--rank runs inside dryrun_multichip")
        _run_rank(a.device)
    elif a.n == "entry":
        fn, fn_args = entry(a.device)
        out = fn(*fn_args)
        print("entry ok:", tuple(out.shape), out.dtype)
    else:
        dryrun_multichip(int(a.n), device=a.device)
