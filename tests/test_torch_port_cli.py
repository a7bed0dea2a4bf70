"""The port's entry point, ``python -m resnet_tpu_torch.train_resnet``:
pack a tree with the port's ``im2rec``, train one short epoch from it on
the CPU (``--device cpu``), validate, checkpoint, and resume; the ResNeXt
and CIFAR presets the same way; and without ``--device`` the entry point
asks for the CUDA card."""

import logging
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from resnet_tpu_torch.train import checkpoint as ckpt
from resnet_tpu_torch.train_resnet import main

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def two_intra_op_threads():
    """Two intra-op threads for the module, then the process's setting
    again. The fit loop runs torch ops on its main and prefetch threads at
    once; at the default width (one thread a core) and with other
    processes busy on the cores, they stall: on an 8-core host with six
    busy processes, the ResNeXt-50 case of test_torch_port_cli.py took
    115 s, and 8 s at two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    for c in range(3):
        (root / f"class_{c}").mkdir()
        for i in range(8):
            h, w = rng.integers(24, 64, 2)
            Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(
                root / f"class_{c}" / f"{i}.jpg")
    for name in ("train", "val"):
        subprocess.run([sys.executable, "-m", "resnet_tpu_torch.data.im2rec",
                        "--root", str(root), "--prefix", str(root / name)],
                       cwd=ROOT, check=True, capture_output=True, timeout=120)
    return root


def _argv(tree, prefix, *extra):
    return ["--preset", "imagenet_resnet50", "--depth", "18",
            "--image-shape", "32,32,3", "--num-classes", "3",
            "--num-examples", "24", "--batch-size", "4", "--frequent", "2",
            "--steps-per-dispatch", "4", "--bn-ema-warmup", "1",
            "--pipeline", "record", "--data-dir", str(tree),
            "--preprocess-threads", "2", "--model-prefix", str(prefix),
            *extra]


@pytest.fixture
def log_lines():
    """The port logger's messages (it does not propagate, and its stdout
    handler keeps the stream of the first test that set it up)."""
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger = logging.getLogger("resnet_tpu_torch")
    logger.addHandler(handler)
    yield lines
    logger.removeHandler(handler)


def test_trains_validates_checkpoints_and_resumes(tree, tmp_path, log_lines):
    prefix = tmp_path / "ck" / "r18"
    state = main(_argv(tree, prefix, "--num-epochs", "1", "--device", "cpu"))
    # 24 records of batch 4: one 4-step dispatch and two one-step tails
    assert state.step == 6
    assert ckpt.latest_epoch(str(prefix)) == 1
    out = "\n".join(log_lines)
    assert "record loader: native" in out
    assert "Epoch[0] Batch [6]\tSpeed:" in out
    assert "bn-ema: warmup done at step 4" in out
    assert "Epoch[0] Validation-accuracy=" in out
    assert (tmp_path / "ck" / "r18.metrics.jsonl").read_text().count(
        '"split": "val"') == 1
    resumed = main(_argv(tree, prefix, "--num-epochs", "2", "--device", "cpu",
                         "--auto-resume"))
    assert "Resumed from epoch 1 (step 6)" in log_lines
    assert resumed.step == 12 and ckpt.latest_epoch(str(prefix)) == 2


@pytest.mark.parametrize("preset,extra,steps", [
    # ResNeXt-50 32x4d at full width and depth from the record tree, with
    # the host warp on (the Solver then zeroes the device warp)
    ("imagenet_resnext50",
     ("--image-shape", "32,32,3", "--num-classes", "3", "--num-examples",
      "24", "--batch-size", "4", "--steps-per-dispatch", "2",
      "--pipeline", "record", "--preprocess-threads", "2",
      "--max-rotate-angle", "10"), 6),
    # ResNet-18 with the CIFAR stem on the in-memory CIFAR-10 stand-in,
    # the pad-4 crop and the CIFAR eval normalize
    ("cifar10_resnet18", ("--num-examples", "32", "--batch-size", "8"), 4),
], ids=["resnext50", "cifar_r18"])
def test_preset_trains_validates_and_checkpoints(tree, tmp_path, log_lines,
                                                 preset, extra, steps):
    prefix = tmp_path / "ck" / preset
    state = main(["--preset", preset, "--num-epochs", "1", "--frequent",
                  "2", "--data-dir", str(tree), "--model-prefix",
                  str(prefix), "--device", "cpu", *extra])
    assert state.step == steps
    assert ckpt.latest_epoch(str(prefix)) == 1
    out = "\n".join(log_lines)
    assert f"Epoch[0] Batch [{steps}]\tSpeed:" in out
    assert "Epoch[0] Validation-accuracy=" in out
    assert (tmp_path / "ck" / f"{preset}.metrics.jsonl").read_text().count(
        '"split": "val"') == 1
    assert all(bool(torch.isfinite(p).all())
               for p in state.model.parameters())


def test_defaults_to_the_card(tree, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(_argv(tree, tmp_path / "r", "--num-epochs", "1"))
