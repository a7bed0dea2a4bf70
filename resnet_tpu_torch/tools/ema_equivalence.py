"""bn-ema against full-batch BatchNorm: final-accuracy equivalence, port of
``tools/ema_equivalence.py``.

The shipped ``imagenet_resnet50`` preset normalizes with bn-ema (the live
batch mean, a stop-gradient clamped variance, the radial projection), a
deliberate departure from batch-statistics BatchNorm. This runs both BN
programs head to head: same task, same budget, several seeds, on
scikit-learn's handwritten-digit scans (600 train, 150 val, upscaled to
40x40 JPEGs) through the whole record pipeline (two ``.rec`` shards from
``data/im2rec.py``, decode, the CIFAR pad-crop on the device, the Solver)
with lr steps that come after the bn-ema warmup switch.

Each run also scores validation twice: with the running statistics (the
standard eval) and in train mode, normalized by the batch (its
BatchNorm buffers restored after each batch). If bn-ema's frozen variance
drifted from the activations, the first falls behind the second where
full-batch BN's does not: ``eval_consistency_gap``.

One JSON line a run, then a summary row. The gates of the JAX package's
CI rung (``tests/test_real_digits.py``): each mode at least 0.8, the two
within 0.06 of each other, the gap of bn-ema at most 0.05.

    python -m resnet_tpu_torch.tools.ema_equivalence [--seeds 0 1 2] \\
        [--epochs 14] [--data DIR]
    python -m resnet_tpu_torch.tools.ema_equivalence --device cpu

Runs on the card unless ``--device cpu``; without a card it raises. The
digits come from sklearn; without it, pass ``--data`` (a tree this tool
built).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np
import torch

from resnet_tpu_torch.config import Config


def build_digits(root: str) -> str:
    """Pack the sklearn digit scans as the JAX package's tool does: 600
    train images in two shards (``train_000.rec``, ``train_001.rec``), 150
    in ``val.rec``."""
    from PIL import Image
    try:
        from sklearn.datasets import load_digits
    except ImportError as e:
        raise ImportError(
            "ema_equivalence builds its digits with sklearn "
            "(sklearn.datasets.load_digits), which is not installed; pass "
            "--data with a tree this tool built elsewhere") from e

    from resnet_tpu_torch.data.im2rec import build_list, pack

    d = load_digits()
    images = (d.images * (255.0 / 16.0)).astype(np.uint8)
    labels = d.target

    def dump(dst, idx):
        for i in idx:
            cls_dir = os.path.join(dst, f"class_{labels[i]}")
            os.makedirs(cls_dir, exist_ok=True)
            arr = np.repeat(images[i][:, :, None], 3, axis=2)
            im = Image.fromarray(arr).resize((40, 40), Image.BILINEAR)
            im.save(os.path.join(cls_dir, f"d{i}.jpg"), quality=95)

    dump(os.path.join(root, "trainsrc"), range(0, 600))
    dump(os.path.join(root, "valsrc"), range(600, 750))
    with contextlib.redirect_stdout(io.StringIO()):   # pack's "wrote" lines
        pack(os.path.join(root, "trainsrc"), os.path.join(root, "train"),
             build_list(os.path.join(root, "trainsrc")), num_shards=2)
        pack(os.path.join(root, "valsrc"), os.path.join(root, "val"),
             build_list(os.path.join(root, "valsrc")))
    return root


def make_cfg(root: str, seed: int, bn_ema: bool, epochs: int) -> Config:
    """The run's configuration (the JAX tool's, field for field)."""
    cfg = Config()
    cfg.model.depth = 20
    cfg.model.dataset = "cifar10"
    cfg.model.bn_mom = 0.9          # the shipped momentum
    cfg.data.num_classes = 10
    cfg.data.num_examples = 600
    cfg.data.image_shape = (32, 32, 3)
    cfg.data.data_dir = root
    cfg.data.train_rec = "train"
    cfg.data.val_rec = "val.rec"
    cfg.data.pipeline = "record"
    cfg.data.preprocess_threads = 2
    cfg.data.min_random_area = 0.6
    cfg.train.batch_size = 24
    cfg.train.num_epochs = epochs
    cfg.train.lr = 0.05
    # 600/24 = 25 steps an epoch; the bn-ema switch fires at step 50
    # (bn_ema_warmup=-2); the lr steps at 60% and 85% of the budget come
    # after it
    cfg.train.lr_steps = (max(3, int(epochs * 0.6)),
                          max(4, int(epochs * 0.85)))
    cfg.train.frequent = 25
    cfg.train.model_prefix = ""
    cfg.train.seed = seed
    cfg.train.bn_ema = bn_ema
    return cfg


@torch.no_grad()
def trainmode_sums(state, batch, preprocess_fn, saved):
    """Metric sums of ``batch`` with the model in train mode (batch
    statistics, or bn-ema's live evidence); the BatchNorm buffers the
    forward refreshed are put back to ``saved``."""
    from resnet_tpu_torch.ops.metrics import cross_entropy_loss, metric_sums

    model = state.model
    model.train()
    logits = model(preprocess_fn(batch["image"]))
    mask = batch.get("mask")
    loss = cross_entropy_loss(logits, batch["label"], mask=mask)
    sums = metric_sums(logits, batch["label"], loss, mask=mask)
    for buf, keep in zip(model.buffers(), saved):
        buf.copy_(keep)
    return sums


def run_one(root: str, seed: int, bn_ema: bool, epochs: int,
            device=None) -> dict:
    """Fit one mode and seed; score validation both ways; print and
    return the run's row."""
    from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
    from resnet_tpu_torch.data.prefetch import prefetch_to_device
    from resnet_tpu_torch.ops.metrics import MetricAccumulator
    from resnet_tpu_torch.train.solver import Solver, _eval_fn

    cfg = make_cfg(root, seed, bn_ema, epochs)
    solver = Solver(cfg, device=device)
    state = solver.fit(make_train_iter(cfg), None)
    m = solver.validate(state, make_val_iter(cfg), epochs - 1)

    preprocess = _eval_fn(cfg)
    saved = [b.clone() for b in state.model.buffers()]
    acc = MetricAccumulator()
    for batch in prefetch_to_device(make_val_iter(cfg).epoch_iter(0), size=2,
                                    device=solver.device):
        acc.update(trainmode_sums(state, batch, preprocess, saved))
    tm = acc.get()

    row = {
        "mode": "bn_ema" if bn_ema else "full_batch_bn",
        "seed": seed,
        "epochs": epochs,
        "val_accuracy": round(float(m["accuracy"]), 4),
        "val_ce": round(float(m["cross-entropy"]), 4),
        "val_top5": round(float(m["top_k_accuracy_5"]), 4),
        "trainmode_val_accuracy": round(float(tm["accuracy"]), 4),
        "trainmode_val_ce": round(float(tm["cross-entropy"]), 4),
        "eval_consistency_gap": round(
            float(tm["accuracy"]) - float(m["accuracy"]), 4),
    }
    print(json.dumps(row), flush=True)
    return row


def summarize(rows) -> dict:
    """The summary row over ``rows`` (both modes present)."""
    summary = {}
    for mode in ("full_batch_bn", "bn_ema"):
        accs = [r["val_accuracy"] for r in rows if r["mode"] == mode]
        ces = [r["val_ce"] for r in rows if r["mode"] == mode]
        gaps = [r["eval_consistency_gap"] for r in rows if r["mode"] == mode]
        summary[mode] = {
            "acc_mean": round(float(np.mean(accs)), 4),
            "acc_min": round(float(np.min(accs)), 4),
            "acc_max": round(float(np.max(accs)), 4),
            "ce_mean": round(float(np.mean(ces)), 4),
            "consistency_gap_mean": round(float(np.mean(gaps)), 4),
        }
    summary["acc_mean_diff(ema - full)"] = round(
        summary["bn_ema"]["acc_mean"]
        - summary["full_batch_bn"]["acc_mean"], 4)
    return summary


def main(argv=None):
    from resnet_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--epochs", type=int, default=14)
    p.add_argument("--data", default="",
                   help="existing digit shard tree (default: build fresh)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)

    device = resolve_device(args.device)   # no card: raise before the data
    root = args.data or build_digits(tempfile.mkdtemp(prefix="ema_eq_"))
    rows = [run_one(root, seed, bn_ema, args.epochs, device)
            for seed in args.seeds for bn_ema in (False, True)]
    print(json.dumps({"summary": summarize(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
