"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configuration and traffic, and the metrics with the cells each is
reported in. Everything else is a file found by its name:

  - ``configs/<config>.json``: the model, the preset that runs it and the
    hyper-parameters the reference follows;
  - ``traffic/<traffic>.json``: a mix's parameters, read by
    ``traffic.py``; its ``kind`` names the module that runs such a cell,
    ``<kind>_cell.py``, whose ``Run`` class drives set-up, the calls, the
    window and the comparison;
  - ``workloads/<cell>.json``: the limits of the cell's compared numbers;
  - ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
  - ``counts/<config>.json``: the model's FLOPs an image.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def read_json(*parts: str) -> dict:
    with open(HERE.joinpath(*parts)) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    counts: dict
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def cell(name: str, bench: dict = None) -> Cell:
    bench = benchmark() if bench is None else bench
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = read_json("configs", _name(w["config"]) + ".json")
    return Cell(name=name, chips=int(w["chips"]), config=cfg,
                traffic=read_json("traffic", _name(w["traffic"]) + ".json"),
                limits=read_json("workloads", _name(name) + ".json")[
                    "limits"],
                counts=read_json("counts", _name(w["config"]) + ".json"),
                end_to_end=_for(bench["end_to_end"], name),
                per_layer=_for(bench["per_layer"], name))


def reader(metric: str) -> Callable:
    """``read(ctx)`` of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / (_name(metric) + ".py")
    mod_spec = importlib.util.spec_from_file_location(
        "gpubench_metric_" + re.sub(r"\W", "_", metric), path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module.read


def kind(name: str) -> type:
    """The ``Run`` class of ``<name>_cell.py``, which runs cells of that
    traffic kind."""
    return importlib.import_module(f"gpubench.{_name(name)}_cell").Run
