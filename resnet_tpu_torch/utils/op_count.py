"""What a step dispatches, counted: FLOPs, bytes, the ordered op events and
the collectives.

The JAX package asks the compiler what a program costs
(``compiled.cost_analysis()``, ``memory_analysis()``, the scheduled HLO).
The port compiles no program, so :class:`OpCounter`, a
``TorchDispatchMode``, watches every aten op a block dispatches instead,
on the CPU and on the card, the backward's included:

  - FLOPs: the formulas of ``torch.utils.flop_counter`` (the ones
    ``FlopCounterMode`` applies: convolutions, their backward and the
    matrix products; elementwise work counts none). An op without a
    formula is decomposed first where it can be, as ``FlopCounterMode``
    does, so that a composite op counts as its parts;
  - bytes: every tensor an op reads plus every tensor it writes, each
    counted once an op. Views and allocations move nothing and count
    nothing. This is eager traffic: what a fusing compiler keeps in
    registers between ops counts here every time;
  - events: every op in dispatch order, with its FLOPs and bytes;
    collectives (any op in a c10d namespace, ``c10d.allreduce_``,
    ``_c10d_functional.all_reduce``, ...) are flagged, with the bytes of
    the tensors they reduce, and count no memory bytes.

The hand-written CUDA kernels are bound through ``ctypes`` and never reach
the dispatcher: only the allocation of their outputs would show. Their
wrappers therefore call :func:`report_kernel` where they launch, with the
products' FLOPs and the bytes of their bound (each input read once, each
output written once), which the active counter records as a kernel
event. On the CPU the wrappers run their plain versions, whose aten ops
the counter sees like any others.

:func:`fake_process_group` joins a process group whose collectives move
nothing (torch's ``fake`` backend): one process plays rank ``r`` of
``world``, so a data-parallel step can be counted without the other
ranks. Its reductions leave every value local.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Dict, Iterator, List

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# ops that only describe a tensor: FlopCounterMode leaves them alone too
_METADATA = {torch.ops.aten.sym_is_contiguous.default,
             torch.ops.aten.is_contiguous.default,
             torch.ops.aten.is_contiguous.memory_format,
             torch.ops.aten.is_strides_like_format.default,
             torch.ops.aten.is_non_overlapping_and_dense.default,
             torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
             torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
             torch.ops.aten.storage_offset.default,
             torch.ops.aten.sym_storage_offset.default,
             torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
             torch.ops.aten.dim.default, torch.ops.prim.layout.default,
             torch.ops.prim.device.default}
# the conv and matrix-product families: the FLOPs a network's shapes give
CONV_MM_OPS = ("convolution", "_convolution", "convolution_backward",
               "cudnn_convolution", "convolution_overrideable",
               "_slow_conv2d_forward", "mm", "addmm", "bmm", "baddbmm")


def is_collective(namespace: str) -> bool:
    """Whether an op of ``namespace`` is a collective: ``c10d``,
    ``_c10d_functional``, ``c10d_functional``, ... (the namespace, not a
    list of names, so that async and all-to-all forms count too)."""
    return namespace.lstrip("_").startswith("c10d")


def is_all_reduce(op: str) -> bool:
    """Whether the collective ``op`` (``namespace.name``) is an all-reduce:
    ``c10d.allreduce_``, ``_c10d_functional.all_reduce``, ..."""
    return "allreduce" in op.replace("_", "")


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(tensors) -> int:
    seen, total = set(), 0
    for t in tensors:
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


@dataclasses.dataclass
class Event:
    """One dispatched op, or one launch a kernel wrapper reported."""
    op: str
    flops: int = 0
    bytes: int = 0
    collective: bool = False
    kernel: bool = False       # a hand-written kernel's report


class OpCounter(TorchDispatchMode):
    """Records an :class:`Event` for every aten op dispatched inside the
    ``with`` block (module docstring); ``events`` in dispatch order."""

    def __init__(self):
        super().__init__()
        self.events: List[Event] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _METADATA:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func._opname}"
        if is_collective(func.namespace):
            self.events.append(Event(name, bytes=_nbytes(_tensors(
                (args, kwargs))), collective=True))
            return out
        flops = (int(flop_registry[packet](*args, **kwargs, out_val=out))
                 if packet in flop_registry else 0)
        moved = 0
        if not (func.is_view or func._opname.startswith(
                ("empty", "new_empty", "_local_scalar_dense"))):
            moved = _nbytes(_tensors((args, kwargs))) + _nbytes(_tensors(out))
        self.events.append(Event(name, flops, moved))
        return out

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        self.events.append(Event(name, int(flops), int(nbytes), kernel=True))

    # -- totals -----------------------------------------------------------

    @property
    def flops(self) -> int:
        return sum(e.flops for e in self.events)

    def conv_mm_flops(self) -> int:
        """FLOPs of the convolutions and matrix products: the aten families
        and the hand-written matrix kernels' reports."""
        return sum(e.flops for e in self.events
                   if e.kernel or e.op.split(".", 1)[-1] in CONV_MM_OPS)

    def eager_bytes(self) -> int:
        return sum(e.bytes for e in self.events
                   if not (e.kernel or e.collective))

    def kernel_bytes(self) -> int:
        return sum(e.bytes for e in self.events if e.kernel)

    def flops_by_op(self) -> Dict[str, int]:
        by: Counter = Counter()
        for e in self.events:
            if e.flops:
                by[e.op] += e.flops
        return dict(by.most_common())

    def kernel_launches(self) -> Dict[str, int]:
        return dict(Counter(e.op for e in self.events if e.kernel))

    def collectives(self) -> List[Event]:
        return [e for e in self.events if e.collective]

    def device_ops(self) -> List[Event]:
        """The events that are device work: every op that moves bytes or
        computes, every collective and every kernel launch."""
        return [e for e in self.events
                if e.bytes or e.flops or e.collective or e.kernel]


def report_kernel(name: str, flops: int, nbytes: int) -> None:
    """Record one launch of the hand-written kernel ``name`` (``flops`` of
    its products, ``nbytes`` of its bound) in the innermost
    :class:`OpCounter` of this thread's dispatch modes (the autograd
    engine's threads carry the caller's); nothing when none is active.
    Its wrapper calls this where it launches the kernel."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            mode.add_kernel(name, flops, nbytes)
            return


def schedule(counter: OpCounter) -> Dict[str, object]:
    """Where the collectives sit among the device ops, the JAX
    ``audit_hlo``'s reading of a scheduled program: ``overlap_pct`` is the
    share of the ops (collectives aside) dispatched after the first
    all-reduce, ``schedule_tail`` the last 40 as ``F`` (an op), ``AR`` (an
    all-reduce) and ``C`` (another collective)."""
    order = [("AR" if is_all_reduce(e.op) else "C") if e.collective
             else "F" for e in counter.device_ops()]
    n_f = order.count("F")
    first = order.index("AR") if "AR" in order else -1
    after = order[first:].count("F") if first >= 0 else 0
    return {"n_ops_dispatched": n_f, "ops_after_first_allreduce": after,
            "overlap_pct": round(100.0 * after / n_f, 1) if n_f else 0.0,
            "schedule_tail": "".join(order[-40:])}


@contextlib.contextmanager
def fake_process_group(world: int, rank: int = 0) -> Iterator[None]:
    """This process as rank ``rank`` of a ``world``-rank group of torch's
    ``fake`` backend, whose collectives return at once and leave every
    value local; the group is destroyed on the way out. Raises if the
    process is in a group already."""
    # importing the module registers the backend with torch.distributed
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("this process is in a process group already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()
