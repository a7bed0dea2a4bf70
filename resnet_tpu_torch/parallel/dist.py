"""Process-group init for multi-process data parallelism, port of
``resnet_tpu/parallel/dist.py``.

One process drives one device. Every rank reads the launcher's
rendezvous from the environment (``tools/launch.py`` sets it):

    RESNET_TPU_COORDINATOR   host:port of rank 0's store
    RESNET_TPU_NUM_PROCS     total processes (the world size)
    RESNET_TPU_PROC_ID       this process's rank

and joins one ``torch.distributed`` process group over ``tcp://``: NCCL
when the process runs on the card, rank r on ``cuda:{r % device_count}``,
gloo on the CPU. A failed init raises; nothing falls back to another
backend or device.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from resnet_tpu_torch.config import ENV_COORD
from resnet_tpu_torch.utils.device import resolve_device

ENV_NPROC = "RESNET_TPU_NUM_PROCS"
ENV_RANK = "RESNET_TPU_PROC_ID"
TIMEOUT_S = 600


def maybe_init_distributed(device=None, timeout_s: float = TIMEOUT_S) -> bool:
    """Join the process group iff the launcher's environment is present;
    returns whether this process is part of one. ``device=None`` means
    the CUDA card (NCCL); ``"cpu"`` selects gloo."""
    if ENV_COORD not in os.environ:
        return False
    if dist.is_initialized():
        return True
    world = int(os.environ.get(ENV_NPROC, "1"))
    rank = int(os.environ.get(ENV_RANK, "0"))
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend, kw["device_id"] = "nccl", dev
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{os.environ[ENV_COORD]}",
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return True


def local_device(device=None) -> torch.device:
    """This rank's device: under NCCL the card ``maybe_init_distributed``
    pinned, else ``device`` as given."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dist.is_initialized() \
            and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def barrier(name: str, timeout_s: float = TIMEOUT_S) -> None:
    """Wait until every rank arrives here. Under gloo a rank that does not
    arrive within ``timeout_s`` raises on rank 0, naming it; NCCL's
    barrier is bounded by the group's timeout."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    if dist.get_backend() == "gloo":
        try:
            dist.monitored_barrier(
                timeout=datetime.timedelta(seconds=timeout_s))
        except RuntimeError as e:
            raise RuntimeError(f"barrier {name!r}: {e}") from e
    else:
        dist.barrier(device_ids=[torch.cuda.current_device()])


class _AllReduceSum(torch.autograd.Function):
    """Sum over a group whose backward sums the gradients over it too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=ctx.group)
        return out, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, differentiably: every rank's loss
    depends on every rank's ``x``, so the backward sums each rank's
    gradient of the sum. Each rank must run the backward as well."""
    return _AllReduceSum.apply(x, group)


def check_equal(value: int, what: str, device) -> None:
    """Raise unless every rank holds the same ``value``: ranks that would
    run different numbers of collectives hang instead of failing."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    both = torch.tensor([value, -value], dtype=torch.int64, device=device)
    dist.all_reduce(both, op=dist.ReduceOp.MAX)
    hi, lo = int(both[0]), -int(both[1])
    if hi != lo:
        raise ValueError(f"ranks disagree on {what}: {lo} to {hi}")


def finalize_distributed() -> None:
    """Leave the group together: ranks reach the end of a run at different
    times, so barrier first, then destroy the group."""
    if dist.is_initialized():
        barrier("resnet_tpu:exit")
        dist.destroy_process_group()


def proc_info() -> Tuple[int, int]:
    """(num_parts, part_index) for input sharding: the world size and this
    rank, (1, 0) outside a process group. The reference's
    ``ImageRecordIter(num_parts=kv.num_workers, part_index=kv.rank)``."""
    if not dist.is_initialized():
        return 1, 0
    return dist.get_world_size(), dist.get_rank()


def is_primary() -> bool:
    """Rank 0 (the reference checkpoints and logs on rank 0 only)."""
    return proc_info()[1] == 0


def world_group() -> Optional[dist.ProcessGroup]:
    """The default group when this process is in one, else None (the
    single-device path)."""
    return dist.group.WORLD if dist.is_initialized() else None
