"""Whole runs on the CPU at a small size: the result line's keys, a traced
run's device fields, and the refusal to run without a card."""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from gpubench import run
from gpubench.tests.small import small_cell

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def test_train_run_result_line():
    cell = small_cell("resnet50-bnema-train")
    out = run.run_cell(cell, 2 ** 31 + 77, 0.5, False, "cpu",
                       time.perf_counter())
    line = run.result_line(cell, out, "cpu", 1)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["metrics"]) == {"train_img_s", "setup_s"}
    assert line["attempted"] == out["diagnostics"]["calls"] * 6
    assert set(line["checks"]) == set(cell.limits)
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert out["diagnostics"]["setup_phases"]
    json.dumps(line)


def test_traced_serve_run_has_the_trace_fields():
    cell = small_cell("resnet50-serve-bs256")
    out = run.run_cell(cell, 5, 0.0, True, "cpu", time.perf_counter())
    line = run.result_line(cell, out, "cpu", 1)
    assert list(line)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert line["attempted"] == cell.traffic["trace_calls"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "gpubench", "--workload",
         "resnet50-bnema-train", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr
