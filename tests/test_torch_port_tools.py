"""The port's deployment tools (``python -m resnet_tpu_torch.tools.<name>``)
on the CPU, from one tiny fit: CIFAR ResNet-8 at 24x24, 3 classes, the
record pipeline over a JPEG tree, 2 epochs.

``export_mxnet``'s pair is read by the JAX package, whose serving function
then gives the port artifact's logits at rtol/atol 1e-4 (float32; the
frameworks sum convolutions in other orders); ``predict`` answers the same
from the ``.pt`` checkpoint as from the pair with wrong ``--depth`` flags;
``validate`` equals the Solver's own validation; ``serve_export --check``
passes; ``bench_serving --quick --device cpu`` keeps the JSON contract of
tests/test_bench_serving.py; and without ``--device cpu`` every tool asks
for the card."""

import ast
import contextlib
import io
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from resnet_tpu.config import cifar10_resnet18 as jax_cifar10_resnet18
from resnet_tpu.models.registry import get_model as jax_get_model
from resnet_tpu.utils.export import load_mxnet_checkpoint as jax_load_mxnet
from resnet_tpu.utils.serving import make_serving_fn as jax_serving_fn
from resnet_tpu.utils.symbol_export import \
    config_from_symbol as jax_config_from_symbol
from resnet_tpu_torch.data import im2rec
from resnet_tpu_torch.tools import (bench_serving, export_mxnet, predict,
                                    serve_export, validate)
from resnet_tpu_torch.train_resnet import main as train_main
from resnet_tpu_torch.tools.common import load_trained, tool_config
from resnet_tpu_torch.utils.serving import load_serving, make_serving_fn
from resnet_tpu_torch.utils.symbol_export import symbol_json

TOL = 1e-4
HW = 24


@pytest.fixture(autouse=True, scope="module")
def two_intra_op_threads():
    """Two intra-op threads for the module, as in test_torch_port_cli.py:
    the fit loop's main and prefetch threads stall each other at the
    default width beside the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _quiet(fn, *args):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        rc = fn(*args)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def fit(tmp_path_factory):
    """(training argv, checkpoint prefix, image tree): 2 epochs of 24
    records, a checkpoint and a validation pass each."""
    tmp = tmp_path_factory.mktemp("tools")
    tree = tmp / "tree"
    rng = np.random.default_rng(0)
    for c in range(3):
        (tree / f"class_{c}").mkdir(parents=True)
        for i in range(8):
            h, w = rng.integers(HW, 2 * HW, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                tree / f"class_{c}" / f"{i}.jpg")
    for name in ("train", "val"):
        _quiet(im2rec.main, ["--root", str(tree), "--prefix",
                             str(tree / name)])
    prefix = str(tmp / "ck" / "c8")
    argv = ["--preset", "cifar10_resnet18", "--depth", "8",
            "--image-shape", f"{HW},{HW},3", "--num-classes", "3",
            "--num-examples", "24", "--batch-size", "8", "--frequent", "3",
            "--pipeline", "record", "--data-dir", str(tree),
            "--preprocess-threads", "2", "--device", "cpu"]
    train_main(argv + ["--num-epochs", "2", "--model-prefix", prefix])
    return argv, prefix, tree


@pytest.fixture(scope="module")
def pair(fit, tmp_path_factory):
    """``export_mxnet``'s pair of epoch 2."""
    argv, prefix, _ = fit
    out = str(tmp_path_factory.mktemp("pair") / "model")
    rc, text = _quiet(export_mxnet.main, ["--out", out, "--", *argv,
                                          "--model-prefix", prefix,
                                          "--load-epoch", "2"])
    assert rc == 0
    assert text.split() == [f"{out}-symbol.json", f"{out}-0002.params"]
    return out


@pytest.fixture(scope="module")
def artifact(fit, tmp_path_factory):
    """``serve_export --check``'s artifact of epoch 2 and its output."""
    argv, prefix, _ = fit
    out = str(tmp_path_factory.mktemp("artifact") / "serve")
    rc, text = _quiet(serve_export.main, [
        "--out", out, "--check", "--", *argv, "--model-prefix", prefix,
        "--load-epoch", "2"])
    return rc, text, out


def test_fit_wrote_the_symbol(fit):
    argv, prefix, _ = fit
    from resnet_tpu_torch.config import build_parser, config_from_args
    cfg = config_from_args(build_parser().parse_args(argv))
    with open(f"{prefix}-symbol.json") as f:
        assert f.read() == symbol_json(cfg)


def test_serve_export_check_passes(artifact):
    rc, text, out = artifact
    assert rc == 0, text
    assert "check: artifact-vs-live max |dlogit|" in text
    assert Path(out + ".pt2").is_file() and Path(out + ".json").is_file()


def test_exported_pair_serves_in_jax_as_the_artifact_does(pair, artifact):
    base = jax_cifar10_resnet18()
    base.data.image_shape = (HW, HW, 3)
    jcfg = jax_config_from_symbol(base, f"{pair}-symbol.json")
    assert (jcfg.model.depth, jcfg.model.dataset, jcfg.data.num_classes) \
        == (8, "cifar10", 3)
    model = jax_get_model(jcfg)
    shapes = jax.eval_shape(partial(model.init, train=False),
                            jax.random.key(0),
                            jnp.zeros((1, HW, HW, 3), jnp.float32))
    params, stats = jax_load_mxnet(pair, 2, shapes["params"],
                                   shapes["batch_stats"])
    x = np.random.default_rng(1).integers(0, 256, (4, HW, HW, 3),
                                          dtype=np.uint8)
    want = np.asarray(jax.jit(jax_serving_fn(jcfg, params, stats))(x))
    serve, _ = load_serving(artifact[2], device="cpu")
    np.testing.assert_allclose(serve(torch.from_numpy(x)).numpy(), want,
                               rtol=TOL, atol=TOL)


def _predict(argv):
    rc, text = _quiet(predict.main, argv)
    assert rc == 0
    return [json.loads(line) for line in text.splitlines()]


def test_predict_answers_the_same_from_checkpoint_and_pair(fit, pair,
                                                           tmp_path):
    argv, prefix, tree = fit
    images = tmp_path / "images"
    images.mkdir()
    for i, f in enumerate(sorted((tree / "class_1").glob("*.jpg"))[:3]):
        Image.open(f).save(images / f"{i}.png")
    inputs = ["--inputs", str(images), str(tree / "val.rec"), "--limit",
              "6", "--top-k", "2", "--"]
    from_pt = _predict(inputs + argv + ["--model-prefix", prefix,
                                        "--load-epoch", "2"])
    # the pair's symbol overrides the wrong network flags
    from_pair = _predict(inputs + argv + ["--depth", "50", "--num-classes",
                                          "7", "--model-prefix", pair,
                                          "--load-epoch", "2"])
    assert from_pt == from_pair
    names = [line["input"] for line in from_pt]
    assert names == [str(images / f"{i}.png") for i in range(3)] + \
        [f"{tree / 'val.rec'}#{i}" for i in range(3)]
    for line in from_pt:
        assert len(line["top_k"]) == 2
        probs = [k["prob"] for k in line["top_k"]]
        assert probs == sorted(probs, reverse=True) and 0 < probs[0] <= 1
    # top-1 is the live model's argmax on the same canvases
    canvases = np.stack([c for _, c in predict._iter_inputs(
        [str(images), str(tree / "val.rec")], (HW, HW), 6)])
    cfg, device = tool_config(argv + ["--model-prefix", prefix,
                                      "--load-epoch", "2"])
    _, state = load_trained(cfg, device)
    with torch.inference_mode():
        live = make_serving_fn(cfg, state.model)(torch.from_numpy(canvases))
    assert [line["top_k"][0]["class"] for line in from_pt] == \
        live.argmax(-1).tolist()


def test_validate_equals_the_solvers_validation(fit, capsys):
    argv, prefix, _ = fit
    with open(f"{prefix}.metrics.jsonl") as f:
        fit_val = [r for r in map(json.loads, f) if r["split"] == "val"]
    # the fit validated after each epoch; epoch 1's pass saw checkpoint 2
    want = next(r for r in fit_val if r["epoch"] == 1)
    capsys.readouterr()
    assert validate.main(argv + ["--model-prefix", prefix,
                                 "--load-epoch", "2"]) == 0
    got = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == {"accuracy", "top_k_accuracy_5", "cross-entropy"}
    for k, v in got.items():
        assert v == want[k], k


def test_bench_serving_quick_keeps_the_json_contract(capsys):
    assert bench_serving.main(["--quick", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["unit"] == "images/sec/chip"
    assert rec["value"] > 0 and rec["live_jit"] > 0
    assert 0.5 < rec["artifact_vs_live"] < 2.0
    assert rec["platform"] == "cpu"
    assert rec["metric"] == "resnet18_serving_artifact_quick"


@pytest.mark.parametrize("tool", [export_mxnet, predict, serve_export,
                                  validate, bench_serving],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_every_tool_asks_for_the_card(tool, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    argv = {export_mxnet: ["--out", str(tmp_path / "m")],
            predict: ["--inputs", str(tmp_path)],
            serve_export: ["--out", str(tmp_path / "a")]}.get(tool, [])
    if tool is not bench_serving:
        argv = argv + ["--"] * (tool is not validate) + [
            "--preset", "cifar10_resnet18", "--model-prefix",
            str(tmp_path / "ck"), "--load-epoch", "1"]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tool.main(argv)
