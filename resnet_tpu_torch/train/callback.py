"""Training callbacks: ``BatchEndParam`` and the ``Speedometer``. Port of
``resnet_tpu/train/callback.py``; the log line is the JAX package's (and
the reference's), character for character:
``Epoch[N] Batch [M]\\tSpeed: X.XX samples/sec\\taccuracy=...``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional

log = logging.getLogger("resnet_tpu_torch")


@dataclass
class BatchEndParam:
    """Mirror of mx.model.BatchEndParam passed to batch callbacks."""
    epoch: int
    nbatch: int
    metrics: Dict[str, float]
    lr: Optional[float] = None


class Speedometer:
    """Throughput logger (ref:core/callback.py Speedometer).

    Counts wall-clock between calls; ``reset`` at each epoch start.
    ``auto_reset`` calls ``reset_fn`` after each log line, the reference's
    per-window metrics.
    """

    def __init__(self, batch_size: int, frequent: int = 50,
                 auto_reset: bool = False):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._init = False
        self._tic = 0.0
        self._last_count = 0
        self._last_logged = 0
        self.last_speed: Optional[float] = None

    def __call__(self, param: BatchEndParam,
                 reset_fn: Optional[Callable] = None):
        count = param.nbatch
        if self._init and count > self._last_count:
            # crossing-based gate: under the K-step call nbatch advances K
            # at a time and may never hit an exact multiple of frequent;
            # the numerator is the real batch delta since the last log
            if count // self.frequent > self._last_logged // self.frequent:
                elapsed = time.perf_counter() - self._tic
                speed = ((count - self._last_logged) * self.batch_size
                         / max(elapsed, 1e-9))
                self.last_speed = speed
                metric_str = "\t".join(
                    f"{k}={v:.6f}" for k, v in param.metrics.items())
                lr_str = (f"\tlr={param.lr:.6f}"
                          if param.lr is not None else "")
                log.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec\t%s%s",
                         param.epoch, count, speed, metric_str, lr_str)
                if self.auto_reset and reset_fn is not None:
                    reset_fn()
                self._tic = time.perf_counter()
                self._last_logged = count
        else:
            self._init = True
            self._tic = time.perf_counter()
            # the init call lands AFTER the first batch/dispatch completed;
            # that work counts as done so the first window's numerator
            # matches its elapsed span
            self._last_logged = count
        self._last_count = count

    def reset(self):
        self._init = False
        self._last_count = 0
        self._last_logged = 0
