"""The port's copy of ``resnet_tpu/utils/metric_writer.py``. Structured
metric log: one JSON line per scalar event.

The observability upgrade over the reference's plain-text logs (SURVEY.md
§5 metrics/logging: 'CLU/metric_writers for scalars'): every Speedometer
window, epoch summary and validation result is appended to
``{model_prefix}.metrics.jsonl`` so dashboards/regression tooling can
consume training curves without log scraping. Rank-0 only.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricWriter:
    def __init__(self, path: Optional[str]):
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            self._f = open(path, "a", buffering=1)

    def write(self, split: str, epoch: int, step: int,
              metrics: Dict[str, float], **extra) -> None:
        if self._f is None:
            return
        rec = {"ts": round(time.time(), 3), "split": split, "epoch": epoch,
               "step": step}
        rec.update({k: (round(float(v), 6)
                        if isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        rec.update(extra)
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None
