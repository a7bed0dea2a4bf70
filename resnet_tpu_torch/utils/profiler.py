"""Profiling hooks, the program's spans, and device time by kernel, port
of ``resnet_tpu/utils/profiler.py``.

``maybe_trace`` traces a block with ``torch.profiler`` (host ops, plus the
card's kernels where there is a card) into a chrome trace under a log
directory, given as an argument or by ``RESNET_TPU_PROFILE=<logdir>``, the
JAX package's switch. The trace opens in Perfetto or ``chrome://tracing``;
``newest_trace``, ``load_trace``, ``kernel_times`` and
``kernel_sequence`` read it back without either: the device's kernel
events, summed by name, or in order with the host ops that launched them.
That is the port's one reading of "device time by kernel"
(``tools/trace_probe.py``, ``tools/aug_fusion_probe.py`` and
``chip_smoke.py`` use it).

Spans name the program's layers inside such a trace. ``span(name)`` and
``region(name, fn, x)`` (a forward span, and ``<name>.backward`` around
its backward) do nothing but one check while no profiler records, and
nothing while ``torch.export`` or ``torch.compile`` traces. While one
records, a span is a ``record_function`` range on the trace's clock, a
CUDA event pair on the current stream, and an entry of ``SPANS``, which
gives each name's device and host milliseconds. The program's spans:

  - ``train.call``: one call of ``make_train_step``'s function (K steps);
    inside each step ``train.augment``, ``train.forward`` (model and
    loss), ``train.backward`` (``torch.autograd.grad``),
    ``train.optimizer`` (``apply_gradients``) and ``train.metrics``;
  - ``train.input_wait``: the Solver's wait for its next prefetched batch;
  - ``bn``, ``bn.backward``: every ``BatchNorm`` forward and its backward
    (a rematerialized unit's recomputation included);
  - ``grouped_weight``, ``grouped_weight.backward``: ResNeXt's
    block-diagonal weight build, ``GroupedConvDense.dense_weight``;
  - ``serve.call``: one call of ``load_serving``'s callable, up to its
    return (the host's enqueue of a batch).

``input_overhead`` is the JAX module's step-time helper;
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
from typing import Callable, Dict, Iterator, List, Optional, Tuple

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
    ``torch.profiler.profile`` object, or None when not tracing. The span
    log is cleared as the trace starts, so that it holds the trace's
    spans."""
    logdir = logdir or os.environ.get("RESNET_TPU_PROFILE")
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    SPANS.clear()
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


def kernel_sequence(trace: dict) -> List[Dict[str, object]]:
    """The device's kernels in the order they started: each ``name``,
    ``group`` (``kernel_group``), ``us`` (its duration), ``op`` and
    ``op_ts``, the host op that launched it (the ``cpu_op`` event that
    shares its ``External id``; None where the trace links none) and when
    that op began (µs, the trace's clock)."""
    ops = {ev["args"]["External id"]: ev
           for ev in trace.get("traceEvents", [])
           if ev.get("cat") == "cpu_op"
           and "External id" in ev.get("args", {})}
    kernels = sorted(
        (ev for ev in trace.get("traceEvents", [])
         if ev.get("ph") == "X"
         and str(ev.get("cat", "")).lower() in KERNEL_CATEGORIES),
        key=lambda ev: float(ev["ts"]))
    out = []
    for ev in kernels:
        op = ops.get(ev.get("args", {}).get("External id"))
        out.append({"name": ev["name"], "group": kernel_group(ev["name"]),
                    "us": float(ev.get("dur", 0.0)),
                    "op": op["name"] if op else None,
                    "op_ts": float(op["ts"]) if op else None})
    return out


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


def input_overhead(step_time_with_pipeline: float,
                   step_time_device_data: float) -> float:
    """Fractional input-pipeline overhead (north-star target: < 0.05)."""
    if step_time_device_data <= 0:
        return 0.0
    return max(0.0, step_time_with_pipeline / step_time_device_data - 1.0)


# device cycles of a spin kernel put in front of every timed run (about
# 1 ms): while the card spins, the host enqueues the start event, the
# launches of ``fn`` and the end event, so that the events bracket device
# work and not the host's launch gaps, which vary with the host's load. A
# wrapper that folds BatchNorm vectors with a few small ops before its
# launch needs up to a few tenths of a ms of host time; 0.2 ms of spin
# left that showing in its times
SPIN_CYCLES = 2_000_000


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


# -- spans ----------------------------------------------------------------

# spans a process keeps whole (their CUDA event pairs included) between two
# clears of the log; past them, each name keeps its count and host seconds
MAX_SPANS = 10_000


def _tracing() -> bool:
    """Whether ``torch.export`` or ``torch.compile`` is tracing: dynamo,
    or the proxy mode of a non-strict export."""
    return (torch.compiler.is_compiling() or torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.PROXY) is not None)


def recording() -> bool:
    """Whether spans record: a profiler records and nothing traces."""
    return torch.autograd._profiler_enabled() and not _tracing()


class Span:
    """One recorded span: ``name``, ``parent`` (the log index of the span
    it opened inside, or None), host start and end (``perf_counter``
    seconds) and the CUDA start and end events (None off the card)."""

    __slots__ = ("name", "parent", "index", "host_start", "host_end",
                 "events", "_range")

    def __init__(self, name: str, parent: Optional[int], index: Optional[int],
                 timed: bool):
        self.name, self.parent, self.index = name, parent, index
        self.host_end: Optional[float] = None
        self._range = torch.profiler.record_function(name)
        self._range.__enter__()
        self.events = None
        if timed:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.host_start = time.perf_counter()

    def _end(self) -> None:
        self.host_end = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(None, None, None)

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.host_end - self.host_start)

    @property
    def device_ms(self) -> Optional[float]:
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


class SpanLog:
    """The spans recorded since the process started or since ``clear``.

    Bounded: the first ``limit`` spans are kept whole, each with its CUDA
    event pair when the process has initialised CUDA; past them a span
    still opens its ``record_function`` range, but only its name's count
    and summed host seconds are kept (``past``), so an epoch-long trace
    holds ``limit`` event pairs at most. A span closed while spans opened
    inside it are still open closes them too (a backward span whose
    input's gradient never came)."""

    def __init__(self, limit: int = MAX_SPANS):
        self.limit = limit
        self.clear()

    def clear(self) -> None:
        self.spans: List[Span] = []
        self.past: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
        self._open: List[Span] = []

    def open(self, name: str) -> Span:
        top = self._open[-1].index if self._open else None
        keep = len(self.spans) < self.limit
        span = Span(name, top, len(self.spans) if keep else None,
                    keep and torch.cuda.is_initialized())
        if keep:
            self.spans.append(span)
        self._open.append(span)
        return span

    def close(self, span: Span) -> None:
        if span not in self._open:
            return
        while True:
            top = self._open.pop()
            top._end()
            if top.index is None:
                past = self.past[top.name]
                past[0] += 1
                past[1] += top.host_end - top.host_start
            if top is span:
                return

    def _inside(self, span: Span, names) -> bool:
        i = span.parent
        while i is not None:
            if self.spans[i].name in names:
                return True
            i = self.spans[i].parent
        return False

    def device_ms(self, *names: str) -> Optional[float]:
        """Device milliseconds inside the spans named ``names``, a span
        inside another of them counted once; None off the card, where no
        such span was kept, or where some passed the limit."""
        names = set(names)
        if any(n in self.past for n in names):
            return None
        found = [s for s in self.spans if s.name in names
                 and s.host_end is not None and not self._inside(s, names)]
        if not found or any(s.events is None for s in found):
            return None
        return sum(s.device_ms for s in found)

    def host_ms(self, name: str) -> List[float]:
        """Host milliseconds of each kept span named ``name``."""
        return [s.host_ms for s in self.spans
                if s.name == name and s.host_end is not None]

    def summary(self) -> Dict[str, Dict[str, Optional[float]]]:
        """Each name's count, summed host ms and device ms (None off the
        card), over the kept spans and those past the limit."""
        out: Dict[str, Dict[str, Optional[float]]] = {}
        for name in sorted({s.name for s in self.spans} | set(self.past)):
            count, seconds = self.past.get(name, (0, 0.0))
            host = self.host_ms(name)
            out[name] = {"count": count + len(host),
                         "host_ms": sum(host) + 1e3 * seconds,
                         "device_ms": self.device_ms(name)}
        return out


SPANS = SpanLog()


@contextlib.contextmanager
def span(name: str) -> Iterator[None]:
    """A named span of the program (module docstring); one check while no
    profiler records."""
    if not recording():
        yield
        return
    s = SPANS.open(name)
    try:
        yield
    finally:
        SPANS.close(s)


def spanned(name: str, iterable) -> Iterator:
    """The items of ``iterable``, each fetched inside ``span(name)``."""
    it = iter(iterable)
    while True:
        with span(name):
            try:
                item = next(it)
            except StopIteration:
                return
        yield item


class _Bracket:
    """The backward span of one region: opened by a hook on the gradient of
    the region's output, closed by a hook on the gradient of its input.
    A hook that returns None passes the gradient on unchanged."""

    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name, self.span = name, None

    def open(self, grad) -> None:
        if recording():
            self.span = SPANS.open(self.name)

    def close(self, grad) -> None:
        if self.span is not None:
            SPANS.close(self.span)
            self.span = None


def region(name: str, fn: Callable[[torch.Tensor], torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` inside ``span(name)``, its backward inside
    ``span(name + ".backward")``: from the output's gradient arriving to
    the input's gradient done. ``fn`` takes an alias of ``x`` (a view,
    which launches nothing) that no other op reads, so the input's hook
    fires when the region's own backward is done, whoever else reads
    ``x``. The alias and both hooks go in only while a profiler records
    and autograd records ``x``."""
    if not recording():
        return fn(x)
    with span(name):
        if not (torch.is_grad_enabled() and x.requires_grad):
            return fn(x)
        bracket = _Bracket(name + ".backward")
        x = x.view_as(x)
        x.register_hook(bracket.close)
        out = fn(x)
        if out.requires_grad:
            out.register_hook(bracket.open)
        return out
