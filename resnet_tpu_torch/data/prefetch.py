"""Host-to-device prefetch: the pipeline's boundary with the card. Port of
``resnet_tpu/data/prefetch.py``.

Up to ``size`` batches are in flight. On the card every host array is
copied into pinned host memory and then to the device with a
``non_blocking`` copy on a side stream, so the copy of batch N+1 runs
under the compute of batch N. When a batch is handed out, the consuming
(current) stream waits for its copy's event, and every tensor of it is
``record_stream``-ed onto that stream, so the caching allocator does not
give its memory to a later copy while a step still reads it. The pinned
buffers come from PyTorch's caching host allocator, which records an
event with each non-blocking copy from one and does not hand the buffer
out again until that copy has finished. On the CPU the batches become
CPU tensors and no stream is used.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

from resnet_tpu_torch.utils.device import resolve_device

Batch = Dict[str, torch.Tensor]


class _Uploader:
    """Host batches -> device batches, on a side stream on the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)

    def put(self, group: List[dict], stack: bool):
        """One batch (``stack=False``, a group of one) or the group stacked
        on a leading axis -> (device batch, copy event or None)."""
        if self.stream is None:
            if stack:
                return {k: torch.from_numpy(np.stack([b[k] for b in group]))
                        for k in group[0]}, None
            return {k: torch.from_numpy(np.asarray(v))
                    for k, v in group[0].items()}, None
        out = {}
        with torch.cuda.stream(self.stream):
            for k in group[0]:
                arrs = [torch.from_numpy(np.asarray(b[k])) for b in group]
                shape = ((len(arrs),) if stack else ()) + arrs[0].shape
                host = torch.empty(shape, dtype=arrs[0].dtype,
                                   pin_memory=True)
                if stack:
                    for i, a in enumerate(arrs):
                        host[i].copy_(a)
                else:
                    host.copy_(arrs[0])
                out[k] = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def ready(self, item) -> Batch:
        """Make the current stream wait for the batch's copy, and tie its
        tensors' memory to that stream."""
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for t in batch.values():
                t.record_stream(consumer)
        return batch


def prefetch_to_device(iterator: Iterator[dict], size: int = 2,
                       device=None) -> Iterator[Batch]:
    """Yield device batches, keeping ``size`` in flight. ``device=None``
    means the CUDA card."""
    up = _Uploader(resolve_device(device))
    queue = collections.deque()
    for batch in iterator:
        queue.append(up.put([batch], stack=False))
        if len(queue) >= size:
            yield up.ready(queue.popleft())
    while queue:
        yield up.ready(queue.popleft())


def prefetch_grouped(iterator: Iterator[dict], k: int, size: int = 2,
                     device=None) -> Iterator[Tuple[Batch, int]]:
    """Group ``k`` host batches into one stacked device batch for the
    K-step call (``make_train_step(steps_per_dispatch=k)``).

    Yields ``(batch, n)``: full groups stacked on a leading ``k`` axis with
    ``n = k``; an epoch tail shorter than ``k`` as single batches with
    ``n = 1``, for the caller's one-step call, so every batch of the epoch
    is trained with exact single-step semantics.
    """
    up = _Uploader(resolve_device(device))
    queue = collections.deque()
    group: List[dict] = []
    for batch in iterator:
        group.append(batch)
        if len(group) == k:
            queue.append((up.put(group, stack=True), k))
            group = []
            if len(queue) >= size:
                item, n = queue.popleft()
                yield up.ready(item), n
    for batch in group:   # epoch tail < k
        queue.append((up.put([batch], stack=False), 1))
    while queue:
        item, n = queue.popleft()
        yield up.ready(item), n
