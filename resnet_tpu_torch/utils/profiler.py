"""Profiling hooks and device time by kernel, port of
``resnet_tpu/utils/profiler.py``.

``maybe_trace`` traces a block with ``torch.profiler`` (host ops, plus the
card's kernels where there is a card) into a chrome trace under a log
directory, given as an argument or by ``RESNET_TPU_PROFILE=<logdir>``, the
JAX package's switch. The trace opens in Perfetto or ``chrome://tracing``;
``newest_trace``, ``load_trace`` and ``kernel_times`` read it back without
either: the device's kernel events, summed by name. That is the port's one
reading of "device time by kernel" (``tools/trace_probe.py`` and
``chip_smoke.py`` both use it).

``time_fn`` and ``input_overhead`` are the JAX module's step-time helpers;
``cuda_median_ms`` times one function on the card with CUDA events.
"""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import socket
import statistics
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional, Tuple

import torch

TRACE_SUFFIX = ".pt.trace.json.gz"
# chrome-trace categories of the card's own work: kernels, and the copies
# and fills the copy engines run
KERNEL_CATEGORIES = ("kernel",)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def maybe_trace(logdir: Optional[str] = None) -> Iterator[Optional[object]]:
    """Trace this block into ``<logdir>/<host>_<pid>.<ns>.pt.trace.json.gz``
    if a logdir is given (or set in ``RESNET_TPU_PROFILE``); yields the
    ``torch.profiler.profile`` object, or None when not tracing."""
    logdir = logdir or os.environ.get("RESNET_TPU_PROFILE")
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    name = f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}"
    prof.export_chrome_trace(os.path.join(logdir, name + TRACE_SUFFIX))


def newest_trace(logdir: str) -> Optional[Path]:
    """The most recently written chrome trace under ``logdir`` (any depth,
    ``*.trace.json`` or ``*.trace.json.gz``), or None."""
    paths = [p for pattern in ("*.trace.json", "*.trace.json.gz")
             for p in Path(logdir).rglob(pattern)]
    return max(paths, key=lambda p: p.stat().st_mtime_ns, default=None)


def load_trace(path) -> dict:
    """A chrome trace as a dict; gzip is recognised by its magic bytes, not
    by the file's name."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw)


def kernel_times(trace: dict, categories: Tuple[str, ...] = KERNEL_CATEGORIES
                 ) -> Tuple[Dict[str, float], Dict[str, int]]:
    """Device time by kernel name: ``(microseconds, launches)``, each a dict
    keyed by the full kernel name. Counts the complete (``"ph": "X"``)
    events that torch's trace files under ``categories``: by default one
    per kernel the card ran, host events and memory copies excluded;
    ``DEVICE_CATEGORIES`` adds the copies and fills."""
    total: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for ev in trace.get("traceEvents", []):
        if ev.get("ph") == "X" and str(ev.get("cat", "")).lower() in categories:
            total[ev["name"]] += float(ev.get("dur", 0.0))
            count[ev["name"]] += 1
    return dict(total), dict(count)


def _mangled_name(name: str) -> str:
    """The function's own identifier in an Itanium-mangled name (some
    library kernels reach the trace undemangled): the last ``<length><id>``
    of ``_ZN...`` before its template arguments, or the one of ``_Z...``."""
    pos = 3 if name.startswith("_ZN") else 2
    ident = name
    while pos < len(name) and name[pos].isdigit():
        digits = re.match(r"\d+", name[pos:]).group()
        pos += len(digits)
        ident = name[pos:pos + int(digits)]
        pos += int(digits)
    return ident


def kernel_group(name: str) -> str:
    """A kernel's group key: its demangled name without the return type,
    namespaces, template arguments, argument list and trailing digits, so
    that ``void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)``
    groups as ``vectorized_elementwise_kernel``."""
    key = _mangled_name(name) if name.startswith("_Z") else name
    key = key.replace("(anonymous namespace)", "anonymous")
    prev = None
    while prev != key:                     # innermost <...> first
        prev, key = key, re.sub(r"<[^<>]*>", "", key)
    key = key.split("(", 1)[0].strip()     # the argument list
    key = key.split()[-1] if key.split() else key    # the return type
    key = key.rsplit("::", 1)[-1]          # namespaces
    key = re.sub(r"\d+$", "", key)
    return key or name[:60]


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 5) -> float:
    """Mean steady-state seconds per call, host clock, with the card
    synchronized before and after the timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    tic = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - tic) / iters


def input_overhead(step_time_with_pipeline: float,
                   step_time_device_data: float) -> float:
    """Fractional input-pipeline overhead (north-star target: < 0.05)."""
    if step_time_device_data <= 0:
        return 0.0
    return max(0.0, step_time_with_pipeline / step_time_device_data - 1.0)


# device cycles of a spin kernel put in front of every timed run (about
# 0.2 ms): while the card spins, the host enqueues the start event, the
# launches of ``fn`` and the end event, so that the events bracket device
# work and not the host's launch gaps, which vary with the host's load
SPIN_CYCLES = 400_000


def cuda_median_ms(fn: Callable, runs: int = 25,
                   flush: Optional[Callable] = None) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn()`` on the current
    card; ``flush()`` runs before each, so that ``fn``'s inputs come from
    device memory and not from L2."""
    times = []
    for _ in range(runs):
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)
