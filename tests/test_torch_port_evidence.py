"""The port's training-evidence tools (``python -m resnet_tpu_torch.tools.
<name>``: ``bench_input``, ``nightly_convergence``, ``device_parity``,
``ema_probe``, ``ema_equivalence``) against the JAX package's ``tools/``
scripts, on the CPU at small sizes.

The data the tools build is the JAX tools' byte for byte (the bench
shard, the stripe shards of ``tests/test_convergence_record.py``, the
sklearn digit tree); the configuration each tool builds equals the JAX
tool's on every field (captured from the JAX tool's own run); the JSON
lines keep the JAX tools' keys, read from their sources; each tool asks
for the card unless given ``--device cpu``."""

import ast
import contextlib
import dataclasses
import filecmp
import importlib.util
import io
import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from resnet_tpu_torch.tools import (bench_input, device_parity,
                                    ema_equivalence, ema_probe,
                                    nightly_convergence)
from resnet_tpu_torch.tools.stripes import build_stripe_tree

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_TOOLS = ROOT / "tools"


@pytest.fixture(autouse=True, scope="module")
def two_intra_op_threads():
    """Two intra-op threads for the module, as in test_torch_port_cli.py:
    the fit loop's main and prefetch threads stall each other at the
    default width beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    """Import ``tools/<name>.py`` under a name of its own, leaving the
    environment and ``sys.path`` as they were (the scripts add the repo
    root to the path, ``bench_input`` sets a cache variable)."""
    env, path = dict(os.environ), list(sys.path)
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  JAX_TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        os.environ.clear()
        os.environ.update(env)
        sys.path[:] = path
    return mod


def _dict_keys(name, target=None, in_call=None):
    """String keys of the dict literals in ``tools/<name>.py`` assigned to
    ``target`` or passed to a call of ``in_call`` (``print``/``update``)."""
    tree = ast.parse((JAX_TOOLS / f"{name}.py").read_text())
    keys = set()
    for node in ast.walk(tree):
        dicts = []
        if target and isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target
                for t in node.targets):
            dicts.append(node.value)
        if in_call and isinstance(node, ast.Call):
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if fname == in_call:
                dicts.extend(a for a in node.args
                             for a in ast.walk(a) if isinstance(a, ast.Dict))
        keys |= {k.value for d in dicts if isinstance(d, ast.Dict)
                 for k in d.keys if isinstance(k, ast.Constant)}
    return keys


def _fields(cfg):
    return {f"{sec}.{f.name}": getattr(getattr(cfg, sec), f.name)
            for sec in ("data", "model", "train")
            for f in dataclasses.fields(getattr(cfg, sec))}


def _same_files(a, b):
    """Every file under ``a`` equals the file at the same path under
    ``b``, and the two trees hold the same paths."""
    fa = sorted(p.relative_to(a) for p in pathlib.Path(a).rglob("*")
                if p.is_file())
    fb = sorted(p.relative_to(b) for p in pathlib.Path(b).rglob("*")
                if p.is_file())
    assert fa == fb and fa
    bad = [str(p) for p in fa
           if not filecmp.cmp(pathlib.Path(a) / p, pathlib.Path(b) / p,
                              shallow=False)]
    assert bad == []


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_bench_dataset_is_the_jax_tools_byte_for_byte(tmp_path):
    jax_bench = _jax_tool("bench_input")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = bench_input.build_dataset(str(tmp_path / "port"), 12, hw=64)
    theirs = jax_bench.build_dataset(str(tmp_path / "jax"), 12, hw=64)
    for ext in (".rec", ".idx"):
        assert filecmp.cmp(ours + ext, theirs + ext, shallow=False), ext


def test_pillow_loader_decodes_every_record_from_its_threads(tmp_path):
    """The Pillow loader (the record path where the decode pool does not
    build, as on the card's machine) decodes a batch in a thread pool over
    one reader a shard: every record comes through, as one thread
    decodes it. With a seek-then-read reader the threads took each
    other's bytes and records were dropped as corrupt."""
    from resnet_tpu_torch.data.native import PythonRecordLoader
    prefix = bench_input.build_dataset(str(tmp_path), 48, hw=64)
    out = {}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for threads in (1, 8):
            loader = PythonRecordLoader(prefix + ".rec", prefix + ".idx",
                                        (64, 64), threads=threads)
            loader.begin_epoch(0, True, 0)
            out[threads] = [loader.next_batch(16) for _ in range(3)]
            assert loader._decode_failures == 0
            loader.close()
    finally:
        sys.setswitchinterval(interval)
    for (im1, lb1, _), (im8, lb8, _) in zip(out[1], out[8]):
        assert len(lb8) == 16
        np.testing.assert_array_equal(lb8, lb1)
        np.testing.assert_array_equal(im8, im1)


def test_stripe_tree_is_the_jax_fixtures_byte_for_byte(tmp_path):
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        from test_convergence_record import shard_tree
    finally:
        sys.path.remove(str(ROOT / "tests"))

    class Factory:
        def mktemp(self, name):
            d = tmp_path / "jax" / name
            d.mkdir(parents=True)
            return d

    with contextlib.redirect_stdout(io.StringIO()):
        theirs = shard_tree.__wrapped__(Factory())
    (tmp_path / "port").mkdir()
    ours = build_stripe_tree(str(tmp_path / "port"))
    _same_files(ours, theirs)
    assert len([p for p in os.listdir(ours) if p.endswith(".rec")]) == 4


def test_digit_tree_is_the_jax_tools_byte_for_byte(tmp_path):
    jax_eq = _jax_tool("ema_equivalence")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    ours = ema_equivalence.build_digits(str(tmp_path / "port"))
    with contextlib.redirect_stdout(io.StringIO()):
        theirs = jax_eq.build_digits(str(tmp_path / "jax"))
    _same_files(ours, theirs)


# ---------------------------------------------------------------------------
# configurations: captured from the JAX tools' own runs
# ---------------------------------------------------------------------------

class _Captured(Exception):
    pass


def _capture_solver_cfg(monkeypatch, run):
    """The config the JAX tool hands its Solver (the run stops there)."""
    import resnet_tpu.train.solver as jax_solver
    seen = []

    def fake(cfg, *a, **k):
        seen.append(cfg)
        raise _Captured

    monkeypatch.setattr(jax_solver, "Solver", fake)
    with pytest.raises(_Captured):
        run()
    return seen[0]


def _jax_cfg(tool, monkeypatch, tmp_path):
    # the JAX ema_probe puts the repo and tests/ on the path
    monkeypatch.setattr(sys, "path", list(sys.path))
    if tool == "nightly_convergence":
        mod = _jax_tool(tool)
        return _capture_solver_cfg(
            monkeypatch, lambda: mod.main(["--epochs", "8", "--bn-ema"]))
    if tool == "ema_probe":
        mod = _jax_tool(tool)
        monkeypatch.setattr(sys, "argv", [
            "ema_probe.py", "--data", str(tmp_path), "--clamp", "1.5",
            "--warmup", "7", "--no-project", "--epochs", "3"])
        return _capture_solver_cfg(monkeypatch, mod.main)
    if tool == "device_parity":
        import resnet_tpu.config as jax_config
        made = []

        class Recorded(jax_config.Config):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)

        monkeypatch.setattr(jax_config, "Config", Recorded)
        mod = _jax_tool(tool)
        with contextlib.redirect_stdout(io.StringIO()):
            # "default": float32 would set JAX's matmul precision for
            # the rest of this process
            assert mod.main(["--depth", "32", "--batch", "8",
                             "--precision", "default"]) == 0
        return made[0]
    return _jax_tool(tool).make_cfg(str(tmp_path), 3, True, 10)


PORT_CFGS = {
    "nightly_convergence": lambda root: nightly_convergence.make_cfg(
        8, 18, True),
    "ema_probe": lambda root: ema_probe.make_cfg(root, 3, 1.5, 7, False),
    "device_parity": lambda root: device_parity.make_cfg(32, 8),
    "ema_equivalence": lambda root: ema_equivalence.make_cfg(
        root, 3, True, 10),
}


@pytest.mark.parametrize("tool", sorted(PORT_CFGS))
def test_tool_config_equals_the_jax_tools(tool, monkeypatch, tmp_path):
    theirs = _fields(_jax_cfg(tool, monkeypatch, tmp_path))
    ours = _fields(PORT_CFGS[tool](str(tmp_path)))
    assert set(ours) == set(theirs)
    assert {k: (ours[k], theirs[k]) for k in ours
            if ours[k] != theirs[k]} == {}


# ---------------------------------------------------------------------------
# runs
# ---------------------------------------------------------------------------

def test_bench_input_quick_on_the_cpu_keeps_the_jax_keys(capsys):
    assert bench_input.main(["--quick", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    want = (_dict_keys("bench_input", target="result", in_call="update")
            - {"cores_needed_for_3000ips"}
            | {"decoder", "cores_needed_for_device_rate"})
    assert set(rec) == want
    assert rec["decoder"] in ("native", "python")
    assert rec["decode_imgs_per_sec"] > 0
    assert rec["step_ms_device_data"] > 0 and rec["step_ms_end_to_end"] > 0
    assert np.isfinite(rec["input_overhead"]) and rec["input_overhead"] >= 0
    assert rec["host_cores"] == os.cpu_count()


def test_device_parity_on_the_cpu_alone_exits_0(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tool compares")
    assert device_parity.main([]) == 0
    assert "only CPU present" in capsys.readouterr().out


def test_device_parity_comparison_flags_a_perturbed_parameter():
    """Two CPU legs from one start agree exactly; a perturbed entry of one
    parameter's delta is found, by name and size."""
    cfg = device_parity.make_cfg(8, 4)
    batches = device_parity.make_batches(4)
    from resnet_tpu_torch.models.registry import get_model
    model = get_model(cfg)
    la, da = device_parity.run_leg(cfg, model, batches, 2, "cpu")
    lb, db = device_parity.run_leg(cfg, model, batches, 2, "cpu")
    assert la == lb
    assert device_parity.worst_delta(da, db) == (0.0, "")
    name = sorted(db)[3]
    db[name] = db[name].copy()
    db[name].flat[0] += 0.1 * np.abs(da[name]).max()
    worst, where = device_parity.worst_delta(da, db)
    assert where == name and worst == pytest.approx(0.1, rel=1e-4)


def test_ema_probe_one_epoch_prints_the_jax_keys(tmp_path, capsys):
    build_stripe_tree(str(tmp_path))
    assert ema_probe.main(["--epochs", "1", "--data", str(tmp_path),
                           "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert set(rec) == _dict_keys("ema_probe", in_call="dumps")
    assert rec["data"] == str(tmp_path) and rec["epochs"] == 1
    assert 0.0 <= rec["val_accuracy"] <= 1.0


def test_ema_equivalence_run_one_gives_the_jax_row(tmp_path, capsys):
    """One epoch of bn-ema (its warmup: batch statistics), both scores;
    the train-mode pass leaves the BatchNorm buffers as the fit left
    them."""
    root = ema_equivalence.build_digits(str(tmp_path))
    row = ema_equivalence.run_one(root, seed=0, bn_ema=True, epochs=1,
                                  device="cpu")
    assert set(row) == _dict_keys("ema_equivalence", target="row")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == row
    assert row["mode"] == "bn_ema" and row["epochs"] == 1
    assert row["eval_consistency_gap"] == pytest.approx(
        row["trainmode_val_accuracy"] - row["val_accuracy"], abs=2e-4)
    summary = ema_equivalence.summarize(
        [row, dict(row, mode="full_batch_bn", val_accuracy=0.5)])
    assert summary["acc_mean_diff(ema - full)"] == round(
        row["val_accuracy"] - 0.5, 4)


def test_trainmode_sums_restores_the_batchnorm_buffers():
    from resnet_tpu_torch.train.solver import _eval_fn
    from resnet_tpu_torch.train.state import create_train_state
    cfg = ema_equivalence.make_cfg("unused", 0, False, 1)
    cfg.model.depth = 8
    state = create_train_state(cfg, device="cpu")
    saved = [b.clone() for b in state.model.buffers()]
    rng = np.random.default_rng(0)
    batch = {"image": torch.from_numpy(
        rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)),
        "label": torch.arange(4)}
    sums = ema_equivalence.trainmode_sums(state, batch, _eval_fn(cfg),
                                          saved)
    assert float(sums["count"]) == 4
    assert all(torch.equal(b, s) for b, s in
               zip(state.model.buffers(), saved))


@pytest.mark.parametrize("tool", [bench_input, nightly_convergence,
                                  ema_probe, ema_equivalence],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_tool_asks_for_the_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    argv = ["--data", str(tmp_path)] if tool in (ema_probe,
                                                 ema_equivalence) else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
