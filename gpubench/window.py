"""The measured windows. A rate is all the work of the window over all
its time, and a tail is the tail of every batch in it.

``calls_window``: calls go on until ``seconds`` have passed on the host's
clock; the call in flight is finished and counted, and the window ends
at a synchronize after it, so no call is cut off or left out.

``closed_loop``: one caller; each batch is timed from its submission to
a synchronize after it, and the next is submitted only then.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, List


def calls_window(call: Callable[[int], None], seconds: float,
                 sync: Callable[[], None],
                 clock: Callable[[], float] = time.perf_counter) -> Dict:
    """Run ``call(i)`` for i = 0, 1, ... over the window. Returns the
    calls made, the window's seconds, and each call's host seconds (the
    time to enqueue it)."""
    sync()
    t0 = clock()
    host: List[float] = []
    while True:
        a = clock()
        call(len(host))
        b = clock()
        host.append(b - a)
        if b - t0 >= seconds:
            break
    sync()
    return {"calls": len(host), "seconds": clock() - t0, "host_s": host}


def closed_loop(call: Callable[[int], None], seconds: float,
                sync: Callable[[], None],
                clock: Callable[[], float] = time.perf_counter) -> Dict:
    """One caller: ``call(i)`` then a synchronize, batch after batch,
    until ``seconds`` have passed. Returns the batches, the window's
    seconds and every batch's latency."""
    sync()
    t0 = clock()
    lat: List[float] = []
    while True:
        a = clock()
        call(len(lat))
        sync()
        b = clock()
        lat.append(b - a)
        if b - t0 >= seconds:
            break
    return {"batches": len(lat), "seconds": clock() - t0, "latency_s": lat}


def percentile(values: List[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile: the smallest value with at
    least ``q`` percent of the values at or below it."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


class Laps:
    """Seconds of each named phase of a set-up, each ended by ``sync``."""

    def __init__(self, sync: Callable[[], None],
                 clock: Callable[[], float] = time.perf_counter):
        self.sync, self.clock = sync, clock
        self.seconds: Dict[str, float] = {}
        self.last = clock()

    def __call__(self, name: str) -> None:
        self.sync()
        now = self.clock()
        self.seconds[name] = now - self.last
        self.last = now
