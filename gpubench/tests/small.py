"""Cells shrunk to a size the CPU holds, for the tests: the same
configuration, traffic and limits at a smaller image, batch and pool."""

from __future__ import annotations

import copy
import dataclasses

from gpubench import spec


def small_cell(name: str, image: int = 32, batch: int = 4):
    cell = spec.cell(name)
    config = copy.deepcopy(cell.config)
    config["model"]["image"] = image
    tr = dict(cell.traffic, batch=batch)
    if cell.kind == "train":
        tr.update(canvas=image + image // 7, pool_calls=2, warmup_calls=1)
    else:
        tr.update(pool=2, trace_calls=2, warmup_calls=1)
    return dataclasses.replace(cell, traffic=tr, config=config)
