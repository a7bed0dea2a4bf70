"""Reading a ``torch.profiler`` chrome trace: the device's work inside the
benchmark's traced window, its busy and idle time, each kernel's class,
and the breakdown of the result line.

``kernel_group`` and ``load_trace`` are frozen copies of the program's
``utils/profiler.py`` readers, so that the yardstick does not move when
the program's profiler module does.

Kernel classes, in this order of precedence:

  - ``handwritten``: the program's own CUDA kernels (``HANDWRITTEN``);
  - ``library``: cuDNN and cuBLAS, known by the host op that launched
    the kernel (a convolution or matrix product, ``LIBRARY_OPS``) or, where
    the trace links no op, by the name (``LIBRARY_NAMES``);
  - ``eager``: every other kernel: PyTorch's own elementwise, reduction,
    copy, pooling and optimizer kernels;
  - ``copy``: the copy engines' copies and fills (busy time, no kernel).
"""

from __future__ import annotations

import gzip
import heapq
import json
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
WINDOW = "gpubench.window"
HANDWRITTEN = ("fused_crop_mirror_normalize", "matmul_stats", "bwd_dx",
               "bwd_dw", "bn_sums")
LIBRARY_OPS = ("aten::cudnn_convolution", "aten::convolution_backward",
               "aten::_convolution", "aten::convolution",
               "aten::cudnn_convolution_transpose", "aten::mm", "aten::addmm",
               "aten::bmm", "aten::baddbmm", "aten::linear", "aten::matmul")
LIBRARY_NAMES = ("cudnn", "xmma", "gemm", "gemv", "cutlass", "nvjet",
                 "wgrad", "dgrad", "implicit", "conv", "winograd", "sm90_",
                 "sm80_", "cublas")


def load_trace(path) -> dict:
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return json.loads(raw)


def _mangled_name(name: str) -> str:
    pos = 3 if name.startswith("_ZN") else 2
    ident = name
    while pos < len(name) and name[pos].isdigit():
        digits = re.match(r"\d+", name[pos:]).group()
        pos += len(digits)
        ident = name[pos:pos + int(digits)]
        pos += int(digits)
    return ident


def kernel_group(name: str) -> str:
    """A kernel's demangled name without return type, namespaces, template
    arguments, argument list and trailing digits."""
    key = _mangled_name(name) if name.startswith("_Z") else name
    key = key.replace("(anonymous namespace)", "anonymous")
    prev = None
    while prev != key:
        prev, key = key, re.sub(r"<[^<>]*>", "", key)
    key = key.split("(", 1)[0].strip()
    key = key.split()[-1] if key.split() else key
    key = key.rsplit("::", 1)[-1]
    key = re.sub(r"\d+$", "", key)
    return key or name[:60]


def kernel_class(group: str, op: Optional[str]) -> str:
    if any(group.startswith(h) for h in HANDWRITTEN):
        return "handwritten"
    if op in LIBRARY_OPS:
        return "library"
    low = group.lower()
    if any(k in low for k in LIBRARY_NAMES):
        return "library"
    return "eager"


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


class Window:
    """The traced window (the ``gpubench.window`` span) of one trace: its
    device events, busy intervals and host events; times in seconds."""

    def __init__(self, trace: dict):
        events = [e for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X"]
        spans = [e for e in events if e.get("name") == WINDOW
                 and e.get("cat") == "user_annotation"]
        if not spans:
            raise ValueError(f"the trace has no {WINDOW} span")
        span = spans[0]
        self.t0 = float(span["ts"])
        self.t1 = self.t0 + float(span["dur"])
        ops = {e["args"]["External id"]: e["name"] for e in events
               if e.get("cat") == "cpu_op"
               and "External id" in e.get("args", {})}
        self.device = []   # (start, end, name, group, class)
        for e in events:
            cat = str(e.get("cat", "")).lower()
            if cat not in DEVICE_CATEGORIES:
                continue
            a = max(float(e["ts"]), self.t0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), self.t1)
            if b <= a:
                continue
            group = kernel_group(e["name"])
            if cat == "kernel":
                op = ops.get(e.get("args", {}).get("External id"))
                cls = kernel_class(group, op)
            else:
                cls = "copy"
            self.device.append((a, b, e["name"], group, cls))
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") in HOST_CATEGORIES
                     and e is not span and e.get("dur") is not None]
        self.busy_intervals = _union([(a, b) for a, b, *_ in self.device])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals) / 1e6

    def seconds_by(self, key: str) -> Dict[str, float]:
        """Device seconds summed by ``group`` or by ``class``."""
        i = {"group": 3, "class": 4}[key]
        out: Dict[str, float] = defaultdict(float)
        for ev in self.device:
            out[ev[i]] += (ev[1] - ev[0]) / 1e6
        return dict(out)

    def kernel_names(self, cls: str) -> List[str]:
        return sorted({ev[2] for ev in self.device if ev[4] == cls})

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds of the device, each gap put to the innermost
        (shortest) host event that spans its middle, the window itself
        where none does."""
        edges = [self.t0] + [t for iv in self.busy_intervals for t in iv] \
            + [self.t1]
        gaps = sorted((a, b) for a, b in zip(edges[0::2], edges[1::2])
                      if b > a)
        host = sorted(self.host)
        active: list = []      # heap of (duration, end, name)
        i = 0
        out: Dict[str, float] = defaultdict(float)
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                s, e, name = host[i]
                heapq.heappush(active, (e - s, e, name))
                i += 1
            while active and active[0][1] < mid:
                heapq.heappop(active)
            out[active[0][2] if active else WINDOW] += (b - a) / 1e6
        return dict(out)


def top(d: Dict[str, float], n: int = 10) -> List[list]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
