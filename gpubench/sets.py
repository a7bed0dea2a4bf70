"""Sets of runs of cells, each run a process of ``python -m gpubench``,
for setting and checking the bounds of ``BENCHMARK.json``:

    python -m gpubench.sets --out <dir> --seconds <s> [--sets 2]
        [--runs 6] [--seed0 <n>] [--trace 0] <cell>...

Run ``i`` (1-based) of every set of a cell takes the seed
``seed0 + i * 7919``, so the sets repeat the same seeds. Each run's
standard output and error go to ``<dir>/<cell>.s<set>.<i>.out`` and
``.err``; one line a run and, for each set and metric, its spread are
printed. A spread is the distance between the first and the third
quartile (``statistics.quantiles(values, n=4)``) over the median; the
trimmed spread leaves out the set's run farthest from the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

SEED_STEP = 7919


def spread(values: List[float]) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: List[float]) -> List[float]:
    mid = statistics.median(values)
    out = list(values)
    out.remove(max(values, key=lambda v: abs(v - mid)))
    return out


def last_line(path: Path) -> Optional[dict]:
    lines = path.read_text().strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("cells", nargs="+")
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=int, required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--runs", type=int, default=6)
    p.add_argument("--seed0", type=int, default=2147490000)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for cell in args.cells:
        sets: List[Dict[str, List[float]]] = []
        for s in range(1, args.sets + 1):
            values: Dict[str, List[float]] = {}
            for i in range(1, args.runs + 1):
                seed = args.seed0 + i * SEED_STEP
                stem = out / f"{cell}.s{s}.{i}"
                tic = time.monotonic()
                with open(f"{stem}.out", "w") as o, \
                        open(f"{stem}.err", "w") as e:
                    rc = subprocess.call(
                        [sys.executable, "-m", "gpubench", "--workload",
                         cell, "--seed", str(seed), "--seconds",
                         str(args.seconds), "--trace", str(args.trace)],
                        stdout=o, stderr=e)
                line = last_line(Path(f"{stem}.out")) if rc == 0 else None
                metrics = {k: v["value"] for k, v in
                           (line or {}).get("metrics", {}).items()}
                for k, v in metrics.items():
                    values.setdefault(k, []).append(v)
                print(json.dumps({
                    "cell": cell, "set": s, "run": i, "seed": seed, "rc": rc,
                    "wall_s": round(time.monotonic() - tic, 1),
                    "correct": (line or {}).get("correct"),
                    "metrics": metrics}), flush=True)
            sets.append(values)
        for s, values in enumerate(sets, 1):
            print(json.dumps({
                "cell": cell, "set": s, "spread": {
                    k: {"median": statistics.median(v), "spread": spread(v),
                        "trimmed": spread(trimmed(v))}
                    for k, v in values.items() if len(v) >= 4}}),
                flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
