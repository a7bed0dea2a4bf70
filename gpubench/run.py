"""The benchmark of the PyTorch/CUDA port, one cell a process.

    python -m gpubench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s`` from the process's start: imports, the
kernel build on a checkout's first run, weights, traffic, the first call
with its comparison hooks, warm-up), then the window: ``--trace 0``
measures the cell's end-to-end metrics over ``--seconds``; ``--trace 1``
runs the traffic's ``trace_calls`` under ``torch.profiler`` and reads the
cell's per-layer metrics from the trace. Then the peak memory is read,
the program is freed, and the reference decides ``correct``.

Standard output: a provenance line (card, power limit, clocks, torch, the
convolution kernels cuDNN and cuBLAS ran), a diagnostics line, and last
the result line. Standard error ends with each compared number beside its
limit. Without a CUDA card, or with fewer cards than the cell asks for,
it exits 2 and prints no result; so it does if JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, Optional

BANNED = ("jax", "jaxlib", "flax", "resnet_tpu")
SMI_FIELDS = ("name,power.limit,clocks.sm,clocks.max.sm,power.draw,"
              "temperature.gpu")


def banned_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of ``BANNED``, compared
    whole (``resnet_tpu_torch`` is not ``resnet_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def set_cache_dirs(root: Path) -> Path:
    """Every build and kernel cache of the program at fixed paths inside
    the checkout, so that a checkout's later runs load what its first
    built."""
    cache = root / ".gpubench_cache"
    for env, sub in (("RESNET_TPU_TORCH_CACHE", "kernels"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[env] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    return cache


def smi() -> Optional[Dict[str, str]]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return dict(zip(SMI_FIELDS.split(","), (v.strip()
                                              for v in out.split(","))))


def profile(fn: Callable[[], None], sync: Callable[[], None], path: str,
            device_type: str):
    """Run ``fn`` under ``torch.profiler`` inside a ``gpubench.window``
    span that ends with a synchronize; the chrome trace goes to ``path``
    and is read back as a ``trace.Window``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from gpubench import trace
    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync()
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW):
            fn()
            sync()
    prof.export_chrome_trace(path)
    try:
        return trace.Window(trace.load_trace(path))
    finally:
        os.remove(path)


def run_cell(cell, seed: int, seconds: float, traced: bool, device: str,
             t0: float) -> dict:
    """Drive one run of ``cell`` on ``device``; returns the result line's
    fields and the lines printed before it."""
    import torch
    from torch.profiler import record_function
    from gpubench import compare, spec, trace
    run = spec.kind(cell.kind)(cell, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t0
    cuda = run.device.type == "cuda"
    before = smi() if cuda else None
    tmp = tempfile.gettempdir()
    out: dict = {"metrics": {}}
    if traced:
        n = cell.traffic["trace_calls"]
        first = run.calls

        def calls():
            for i in range(n):
                with record_function("gpubench.call"):
                    run.call(i)
        win = profile(calls, run.sync,
                      os.path.join(tmp, f"gpubench_{os.getpid()}.json"),
                      run.device.type)
        ctx = SimpleNamespace(
            kind=cell.kind, window=win, counts=cell.counts,
            peaks=spec.read_json("peaks.json"),
            k1=spec.read_json("counts", "k1_augment.json"),
            config=run.ref_cfg, traffic=cell.traffic, seed=seed,
            launches=run.launches(first, n), **run.traced_counts(n))
        for m in cell.per_layer:
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        kernels = win.kernel_names("library")
        out["device_extra"] = {"busy_s": win.busy_s,
                               "window_s": win.window_s}
        out["breakdown"] = {"device_ops": trace.top(win.seconds_by("group")),
                            "idle_gaps": trace.top(win.idle_gaps())}
        attempted = run.work(n_calls=n)
        diag = {"traced_calls": n, "idle_share": 1 - win.busy_s
                / win.window_s, "device_s_by_class": win.seconds_by("class")}
    else:
        win = run.window(run.call, seconds, run.sync)
        values = run.measures(win)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            out["metrics"][m["name"]] = {"value": values[m["name"]],
                                         "unit": m["unit"]}
        diag = run.diagnostics(win)
        attempted = run.work(win=win)
        kernels = None
    after = smi() if cuda else None
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    if kernels is None:
        # the library kernels cuDNN's autotuner and cuBLAS chose: one
        # more call under the profiler, after the window
        one = profile(lambda: run.call(0), run.sync,
                      os.path.join(tmp, f"gpubench_{os.getpid()}_k.json"),
                      run.device.type)
        kernels = one.kernel_names("library")
        diag.update(device_busy_per_call_s=one.busy_s,
                    busy_share_estimate=one.busy_s / run.period(win))
    run.release()
    tic = time.perf_counter()
    numbers = run.check()
    diag["check_s"] = time.perf_counter() - tic
    ok, lines = compare.judge(numbers, cell.limits)
    out.update(
        correct=ok, numbers=numbers, check_lines=lines, peak=peak,
        attempted=attempted,
        failed=numbers.get("_failed", 0 if ok else run.compared),
        provenance={
            "card": before, "card_after": after,
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "cudnn": (torch.backends.cudnn.version() if cuda else None),
            "cudnn_benchmark": torch.backends.cudnn.benchmark,
            "library_kernels": len(kernels),
            "library_kernel_set": hashlib.sha1(
                "\n".join(kernels).encode()).hexdigest()[:12],
            "library_kernel_names": [k[:120] for k in kernels]},
        diagnostics=dict(diag, setup_s=setup_s, setup_phases=run.phases,
                         seed=seed, preset_departures=run.departs,
                         leaves=numbers.get("_leaves")))
    return out


def result_line(cell, out: dict, device_name: str, count: int) -> dict:
    from gpubench import compare
    numbers = {k: v for k, v in out["numbers"].items()
               if not k.startswith("_")}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": out["peak"]}
    device.update(out.get("device_extra", {}))
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["checks"] = compare.check_entry(numbers, cell.limits)
    return line


def main(argv=None) -> int:
    t0 = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    root = Path(__file__).resolve().parent.parent
    cache = set_cache_dirs(root)
    from gpubench import program, spec
    program.enable_cache(str(cache / "kernels"))
    cell = spec.cell(args.workload, spec.benchmark(root))
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                   t0)
    found = banned_modules()
    if found:
        print(f"gpubench: the run loaded {found}; the port's benchmark "
              f"imports neither JAX nor the JAX package", file=sys.stderr)
        return 2
    print(json.dumps({"provenance": out["provenance"]}))
    print(json.dumps({"diagnostics": out["diagnostics"]}))
    line = result_line(cell, out, torch.cuda.get_device_name(0), cell.chips)
    sys.stdout.flush()
    for text in out["check_lines"]:
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
