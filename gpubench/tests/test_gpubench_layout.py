"""BENCHMARK.json against the benchmark's contract, and every cell's,
traffic's and metric's files found by name."""

import dataclasses
import json
import re
from types import SimpleNamespace

import pytest

from gpubench import program, spec, weights

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) == 0


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"]
                         + BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda e: e["name"])
def test_entry_names_and_fields(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
        assert set(entry.get("workloads", CELLS)) <= set(CELLS)
    if "bound" in entry:
        assert 0.01 <= entry["bound"] <= 0.25
        assert entry["source"] in ("host_clock", "device_trace")


def test_setup_and_every_cell_reports_enough():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for cell in CELLS:
        c = spec.cell(cell)
        assert len(c.end_to_end) >= 2 and c.per_layer
        moved = {m["moves"] for m in c.per_layer}
        assert moved <= {m["name"] for m in c.end_to_end}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = spec.cell(cell)
    run = spec.kind(c.kind)
    assert run.kind == c.kind
    assert set(c.traffic) <= run.TRAFFIC_KEYS
    assert c.limits and all(v > 0 for v in c.limits.values())
    assert c.counts["train_flops_per_image"] > c.counts[
        "serve_flops_per_image"] > 0
    assert c.config["reduced"] == []


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_and_silent_elsewhere(metric):
    read = spec.reader(metric)
    kind = "serve" if metric.endswith(("train", "train_mfu")) or \
        metric == "k1_roofline" else "train"
    empty = SimpleNamespace(kind=kind, launches=[], images=0, steps=0,
                            batches=0)
    assert read(empty) is None


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell("no-such-cell")
    with pytest.raises(ValueError):
        spec.reader("../run")
    with pytest.raises(ValueError):
        spec.kind("../run")
    with pytest.raises(ModuleNotFoundError):
        spec.kind("no_such_kind")


@pytest.mark.parametrize("cell", ["resnet50-bnema-train",
                                  "resnet50-serve-bs256"])
def test_a_traffic_key_no_code_reads_is_refused(cell):
    c = spec.cell(cell)
    bad = dataclasses.replace(c, traffic=dict(c.traffic, callers=4))
    with pytest.raises(ValueError, match="callers"):
        spec.kind(c.kind)(bad, 1, "cpu")


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_the_configuration_file_is_what_runs(config):
    from resnet_tpu_torch.config import PRESETS
    c = spec.read_json("configs", config + ".json")
    cfg, departs = program.cell_config(c, {}, 7)
    assert departs == {}
    for dotted, value in program.stated(c).items():
        section, name = dotted.split(".")
        got = getattr(getattr(cfg, section), name)
        assert got == (tuple(value) if isinstance(value, list) else value)
    # a value the file sets apart from the preset is applied, and shown
    c["program"] = dict(c["program"], **{"train.unit_chain": "pallas"})
    c["train"] = dict(c["train"], bn_ema=False)
    cfg, departs = program.cell_config(c, {"batch": 256}, 7)
    assert cfg.train.unit_chain == "pallas" and not cfg.train.bn_ema
    assert set(departs) == {"train.unit_chain", "train.bn_ema"}
    assert cfg.train.batch_size == 256
    assert PRESETS[c["preset"]]().train.unit_chain == "off"
    c["program"] = dict(c["program"], **{"train.no_such_field": 1})
    with pytest.raises(KeyError, match="no_such_field"):
        program.cell_config(c, {}, 7)


def test_the_residual_scale_is_the_configuration_files():
    c = spec.read_json("configs", "resnet50_v1.json")
    c["model"] = dict(c["model"], image=32)
    w = weights.make(c, 3, "cpu")
    assert float(w["stage1_unit1.bn3.weight"][0]) == pytest.approx(
        c["init"]["residual_bn_scale"])
    assert float(w["stage1_unit1.bn2.weight"][0]) == c["init"]["bn_scale"]
    c["init"] = dict(c["init"], residual_bn_scale=0.5)
    assert float(weights.make(c, 3, "cpu")["stage1_unit1.bn3.weight"][0]) \
        == 0.5
