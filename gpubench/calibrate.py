"""Readings for a cell's limits, on the card at the cell's own size, in one
process (set-up is most of a run; a window is not needed for them):

    python -m gpubench.calibrate --workload <cell> --seed0 <n>
        [--program 12] [--witness 2] [--control 3]

  - ``program``: the program as the configuration states it, the cell's
    own set-up and compared steps or answers, on that many seeds: the
    lower readings;
  - ``witness``: the program computing in float32 with TF32 off, on that
    many seeds: where a number reads high, whether the configuration's
    precision is the cause;
  - ``control``: in the program's place the reference with its
    convolutions in float8 (the control), in bfloat16, and with each
    fault a cell can have planted in it (training: the loss's mean over
    half the batch, the state left unchanged; serving: two answers
    exchanged), on that many seeds: the upper readings.

One JSON line a reading (``side``, ``seed``, the numbers), then a summary
line: each number's largest program reading and smallest reading of each
other side.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from typing import Dict, List

import torch

from gpubench import spec


@contextlib.contextmanager
def program_in_float32(config: dict):
    """The configuration computing in float32, TF32 off, for the
    witness."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield dict(config, train=dict(config["train"], dtype="float32"))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def summary(rows: List[dict]) -> dict:
    sides: Dict[str, Dict[str, List[float]]] = {}
    for row in rows:
        for name, v in row["numbers"].items():
            if not name.startswith("_"):
                side = sides.setdefault(row["side"], {})
                side.setdefault(name, []).append(v)
    out = {}
    for side, numbers in sides.items():
        pick = max if side == "program" else min
        out[side] = {n: pick(v) for n, v in numbers.items()}
        if side == "program":
            out["program_min"] = {n: min(v) for n, v in numbers.items()}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed0", type=int, required=True)
    p.add_argument("--program", type=int, default=12)
    p.add_argument("--witness", type=int, default=2)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from gpubench import program
    from gpubench.run import set_cache_dirs
    program.enable_cache(str(set_cache_dirs(spec.ROOT) / "kernels"))
    cell = spec.cell(args.workload)
    run = spec.kind(cell.kind)
    device = args.device
    rows = []

    def emit(side, seed, numbers):
        row = {"side": side, "seed": seed, "numbers": numbers}
        rows.append(row)
        print(json.dumps(row), flush=True)

    seed = args.seed0
    for _ in range(args.program):
        emit("program", seed, run.program_readings(cell, seed, device))
        seed += 1
    with program_in_float32(cell.config) as config:
        f32 = dataclasses.replace(cell, config=config)
        for _ in range(args.witness):
            emit("witness_float32", seed,
                 run.program_readings(f32, seed, device))
            seed += 1
    for _ in range(args.control):
        for side, numbers in run.reference_readings(cell, seed, device):
            emit(side, seed, numbers)
        seed += 1
    print(json.dumps({"summary": summary(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
