"""Configuration dataclasses, the five presets and the command line.

The port's own copy of ``resnet_tpu/config.py``: the field names,
defaults, preset values and flags are the JAX package's, so one command
line means the same run in both. Every flag of the JAX parser is
accepted and ported; ``require_ported`` checks that more than one device
runs under the launcher. ``--xla-opts`` carries the port's backend
options (``utils/xla_opts.py``). Fields that only steer the XLA compiler
(``spd_unroll``) are accepted and change nothing: the port's K-step call
is a Python loop.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import torch

# the launcher's rendezvous (parallel/dist.py)
ENV_COORD = "RESNET_TPU_COORDINATOR"

# TrainConfig.dtype -> the compute dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class DataConfig:
    """Dataset, record pipeline and augmentation knobs
    (ref: mx.io.ImageRecordIter kwargs)."""

    data_dir: str = "data"
    train_rec: str = "train.rec"
    train_idx: str = "train.idx"
    val_rec: str = "val.rec"
    val_idx: str = "val.idx"
    num_classes: int = 1000
    num_examples: int = 1281167
    image_shape: tuple = (224, 224, 3)  # NHWC
    rand_crop: bool = True
    rand_mirror: bool = True
    random_resized_crop: bool = True  # area-based RRC vs classic scale crop
    min_random_area: float = 0.08
    max_random_area: float = 1.0
    # MXNet aspect convention: ratio ~ U[1-a, 1+a] for a <= 1; a > 1 is
    # the multiplicative [1/a, a]; min_aspect_ratio overrides the range
    max_aspect_ratio: float = 0.25
    min_aspect_ratio: Optional[float] = None
    min_random_scale: float = 1.0
    max_random_scale: float = 1.0
    max_rotate_angle: float = 0.0
    max_shear_ratio: float = 0.0
    rotate_backend: str = "host"      # where the rotate/shear warp runs
    random_h: int = 36                # HSL jitter, OpenCV HLS units
    random_s: int = 50
    random_l: int = 50
    mean_rgb: tuple = (123.68, 116.779, 103.939)
    std_rgb: tuple = (58.393, 57.12, 57.375)
    max_random_contrast: float = 0.0
    max_random_illumination: float = 0.0
    pad: int = 4                      # CIFAR pad-and-crop
    fill_value: int = 0
    preprocess_threads: int = 4       # decode threads of the record loader
    prefetch_buffer: int = 2          # batches queued ahead, host and device
    canvas_size: int = 0              # train letterbox edge (0: 8/7 of out)
    shuffle: bool = True
    pipeline: str = "record"          # synthetic | memory | record
    # auto | pallas: the fused augmentation kernel (its plain version on a
    # CPU tensor); xla: the plain PyTorch augmenter; pallas-split: the
    # kernel crops, the photometric jitter runs after it as plain ops
    augment_impl: str = "auto"


@dataclass
class ModelConfig:
    """Network selection (ref:symbol/resnet.py get_symbol arguments)."""

    network: str = "resnet"           # resnet | resnext
    depth: int = 50
    version: int = 1                  # v1 post-activation, v2 pre-activation
    cardinality: int = 32             # ResNeXt num_group
    group_width: int = 4              # ResNeXt bottleneck width per group
    bn_mom: float = 0.9
    bn_eps: float = 2e-5
    dataset: str = "imagenet"         # imagenet | cifar10


@dataclass
class TrainConfig:
    """Optimizer, schedule, loop and step knobs
    (ref:train_resnet.py config.TRAIN)."""

    batch_size: int = 256
    lr: float = 0.1
    lr_steps: tuple = (30, 60, 90)    # epochs at which lr *= lr_factor
    lr_factor: float = 0.1
    warmup: bool = False
    warmup_lr: float = 0.0
    warmup_epochs: int = 5
    optimizer: str = "sgd"            # sgd | nag
    mom: float = 0.9
    wd: float = 1e-4
    num_epochs: int = 100
    frequent: int = 50                # Speedometer log interval (batches)
    model_prefix: str = "checkpoints/resnet"
    load_epoch: Optional[int] = None
    auto_resume: bool = False         # resume from the latest checkpoint
    checkpoint_frequent: int = 0      # also save every N batches (0 = off)
    begin_epoch: int = 0
    dtype: str = "float32"            # float32 | bfloat16 compute
    remat: bool = False
    fused_convbn: bool = False        # BN statistics fused into the 1x1 convs
    # chain dataflow for v1 bottleneck units: off | xla | pallas. The values
    # are the JAX package's; in the port "pallas" selects the hand-written
    # CUDA kernels and "xla" the same ops as separate PyTorch ops.
    unit_chain: str = "off"
    grouped_dense: bool = False
    grouped_merge: int = 0
    bn_subsample: int = 1             # BN stats from batch//s leading images
                                      # (s=8 at batch 256 = the reference's
                                      # per-GPU 32-image stats sample count)
    bn_grouped: bool = False          # with bn_subsample s: normalize s
                                      # INDEPENDENT groups, each with its own
                                      # stats — the exact single-chip analog
                                      # of the reference's per-GPU BatchNorm
    bn_stat_stride: int = 1           # BN stats from every s-th spatial
                                      # row/column of ALL images
    bn_ema: bool = False              # live batch mean + stop-grad clamped var
    bn_ema_warmup: int = -2           # steps of full-batch BN before bn-ema
                                      # takes over (negative: that many
                                      # epochs); switched by the Solver
    bn_ema_project: bool = True       # radial projection with bn_ema
    bn_ema_clamp: float = 1.0         # trust region vs the batch evidence
    steps_per_dispatch: int = 1       # SGD steps per train-step call
    spd_unroll: bool = False          # XLA scan unrolling; no-op here
    stem_s2d: bool = False            # 7x7/2 stem as a 4x4/1 conv on s2d input
    aug_s2d: bool = False             # augmenter emits the s2d block layout
    pool_grad: str = "sas"            # stem max-pool backward (sas | mask)
    remat_policy: str = "none"
    xla_opts: str = ""
    label_smooth: float = 0.0
    seed: int = 0
    check_numerics: bool = False      # anomaly detection + a finite loss
    num_devices: int = 0              # 0 = the world size
    dp_mode: str = "jit"
    sync_bn: bool = False             # global-batch BN (jit mode has it)
    dp_comm_dtype: str = "float32"
    dp_sync: str = "step"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Presets: the JAX package's five, value for value
# ---------------------------------------------------------------------------

def cifar10_resnet18() -> Config:
    """ResNet-18 on CIFAR-10: the CIFAR stem (3x3/1 conv, no pool) on the
    ImageNet depth-18 table, batch 128, float32, the pad-4 crop."""
    cfg = Config()
    cfg.data = dataclasses.replace(
        cfg.data, num_classes=10, num_examples=50000,
        image_shape=(32, 32, 3), pipeline="memory",
        mean_rgb=(125.307, 122.95, 113.865), std_rgb=(62.993, 62.089, 66.705),
        min_random_area=1.0, max_aspect_ratio=0.0,
        random_h=0, random_s=0, random_l=0,
    )
    cfg.model = dataclasses.replace(cfg.model, depth=18, dataset="cifar10")
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=128, lr=0.1, lr_steps=(120, 160), num_epochs=200)
    return cfg


def imagenet_resnet50() -> Config:
    """ResNet-50 v1 on ImageNet, one device: batch 128, lr 0.05, bf16
    compute with fp32 params, BN stats and head, bn-ema with the radial
    projection after two epochs of full-batch BN, the space-to-depth stem
    fed by an s2d augmenter, and six SGD steps per train-step call."""
    cfg = Config()
    cfg.train = dataclasses.replace(cfg.train, bn_ema=True,
                                    batch_size=128, lr=0.05,
                                    steps_per_dispatch=6, spd_unroll=True,
                                    stem_s2d=True, aug_s2d=True,
                                    dtype="bfloat16")
    return cfg


def imagenet_resnext50() -> Config:
    """ResNeXt-50 32x4d: the grouped 3x3s lowered two groups a
    block-diagonal block (``grouped_dense``, ``grouped_merge=2``), batch
    128, bf16, bn-ema, the s2d stem fed by the s2d augmenter, four SGD
    steps per train-step call."""
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, network="resnext", depth=50)
    cfg.train = dataclasses.replace(cfg.train, grouped_dense=True,
                                    grouped_merge=2, bn_ema=True,
                                    batch_size=128, lr=0.05,
                                    dtype="bfloat16",
                                    steps_per_dispatch=4, spd_unroll=True,
                                    stem_s2d=True, aug_s2d=True)
    return cfg


def imagenet_resnet101_bf16() -> Config:
    """ResNet-101, bf16 compute, batch 1024 with a 5-epoch lr warmup."""
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, depth=101)
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=1024, lr=0.4, warmup=True, warmup_epochs=5,
        dtype="bfloat16", bn_ema=True,
        steps_per_dispatch=6, spd_unroll=True, stem_s2d=True,
        aug_s2d=True)
    return cfg


def imagenet_resnet152_dp() -> Config:
    """ResNet-152 over 16 devices with remat: run it with as many ranks
    (``python -m resnet_tpu_torch.tools.launch -n 16 -- ...``), or with
    ``--num-devices`` set to the world size and ``--batch-size`` the
    global batch."""
    cfg = Config()
    cfg.model = dataclasses.replace(cfg.model, depth=152)
    cfg.train = dataclasses.replace(
        cfg.train, batch_size=2048, lr=0.8, warmup=True, warmup_epochs=5,
        dtype="bfloat16", remat=True, num_devices=16, bn_ema=True,
        steps_per_dispatch=4, spd_unroll=True, stem_s2d=True,
        aug_s2d=True)
    return cfg


PRESETS = {
    "cifar10_resnet18": cifar10_resnet18,
    "imagenet_resnet50": imagenet_resnet50,
    "imagenet_resnext50": imagenet_resnext50,
    "imagenet_resnet101_bf16": imagenet_resnet101_bf16,
    "imagenet_resnet152_dp": imagenet_resnet152_dp,
}


def require_ported(cfg: Config) -> None:
    """Every switch of the JAX package is ported; what is left to check is
    the device count. More than one device needs a process a device,
    started by the launcher: without its environment ``ValueError``."""
    t = cfg.train
    if t.num_devices > 1 and ENV_COORD not in os.environ:
        raise ValueError(
            f"num_devices={t.num_devices}: the port drives one device per "
            f"process; start {t.num_devices} processes with python -m "
            f"resnet_tpu_torch.tools.launch -n {t.num_devices} -- python -m "
            "resnet_tpu_torch.train_resnet ...")


# ---------------------------------------------------------------------------
# CLI: the JAX package's flags, plus --device
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Train ResNet on NVIDIA GPUs, one process a card "
                    "(PyTorch port of train_resnet.py)")
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="start from a canned BASELINE config")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card; 'cpu' runs "
                        "on the CPU)")
    # model
    p.add_argument("--network", choices=["resnet", "resnext"], default=None)
    p.add_argument("--depth", type=int, default=None)
    p.add_argument("--version", type=int, choices=[1, 2], default=None)
    p.add_argument("--dataset", choices=["imagenet", "cifar10"], default=None)
    p.add_argument("--cardinality", type=int, default=None)
    # data
    p.add_argument("--data-dir", default=None)
    p.add_argument("--train-rec", default=None,
                   help=".rec file/glob/shard-prefix under data-dir")
    p.add_argument("--val-rec", default=None)
    p.add_argument("--num-classes", type=int, default=None)
    p.add_argument("--num-examples", type=int, default=None)
    p.add_argument("--image-shape", default=None,
                   help="H,W,C (reference used C,H,W)")
    p.add_argument("--pipeline", choices=["synthetic", "memory", "record"],
                   default=None)
    p.add_argument("--preprocess-threads", type=int, default=None)
    p.add_argument("--canvas-size", type=int, default=None,
                   help="train letterbox canvas edge (0 = auto: 8/7 of "
                        "the output size)")
    # augmentation knobs (ref: mx.io.ImageRecordIter kwargs)
    p.add_argument("--no-random-resized-crop", action="store_true",
                   default=None, help="classic scale-crop sampling instead")
    p.add_argument("--min-random-area", type=float, default=None)
    p.add_argument("--max-random-area", type=float, default=None)
    p.add_argument("--max-aspect-ratio", type=float, default=None)
    p.add_argument("--min-aspect-ratio", type=float, default=None)
    p.add_argument("--min-random-scale", type=float, default=None)
    p.add_argument("--max-random-scale", type=float, default=None)
    p.add_argument("--random-h", type=int, default=None)
    p.add_argument("--random-s", type=int, default=None)
    p.add_argument("--random-l", type=int, default=None)
    p.add_argument("--max-rotate-angle", type=float, default=None)
    p.add_argument("--max-shear-ratio", type=float, default=None)
    p.add_argument("--max-random-contrast", type=float, default=None)
    p.add_argument("--max-random-illumination", type=float, default=None)
    p.add_argument("--pad", type=int, default=None)
    p.add_argument("--fill-value", type=int, default=None)
    p.add_argument("--rotate-backend", choices=["host", "device"],
                   default=None)
    p.add_argument("--augment-impl",
                   choices=["auto", "pallas", "pallas-split", "xla"],
                   default=None,
                   help="auto/pallas: the fused CUDA augmentation kernel; "
                        "pallas-split: the kernel crops, the photometric "
                        "jitter runs after it; xla: the plain PyTorch "
                        "augmenter")
    # train
    p.add_argument("--batch-size", type=int, default=None, help="global batch")
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-steps", default=None, help="epochs, e.g. 30,60,90")
    p.add_argument("--lr-factor", type=float, default=None)
    p.add_argument("--warmup", action="store_true", default=None)
    p.add_argument("--warmup-epochs", type=int, default=None)
    p.add_argument("--optimizer", choices=["sgd", "nag"], default=None)
    p.add_argument("--mom", type=float, default=None)
    p.add_argument("--wd", type=float, default=None)
    p.add_argument("--num-epochs", type=int, default=None)
    p.add_argument("--label-smooth", type=float, default=None)
    p.add_argument("--frequent", type=int, default=None)
    p.add_argument("--model-prefix", default=None)
    p.add_argument("--load-epoch", type=int, default=None)
    p.add_argument("--auto-resume", action="store_true", default=None,
                   help="resume from the latest checkpoint if present")
    p.add_argument("--checkpoint-frequent", type=int, default=None,
                   help="also checkpoint every N batches (with the data "
                        "cursor); SIGTERM always saves one final mid-epoch "
                        "checkpoint")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument("--remat", action="store_true", default=None)
    p.add_argument("--fused-convbn", action="store_true", default=None,
                   help="BN statistics fused into the 1x1 convs (CUDA "
                        "kernels)")
    p.add_argument("--unit-chain", choices=["off", "xla", "pallas"],
                   default=None,
                   help="chain dataflow for v1 bottleneck units")
    p.add_argument("--grouped-dense", action="store_true", default=None)
    p.add_argument("--grouped-merge", type=int, default=None)
    p.add_argument("--bn-subsample", type=int, default=None)
    p.add_argument("--bn-grouped", action="store_true", default=None)
    p.add_argument("--bn-stat-stride", type=int, default=None)
    p.add_argument("--bn-ema", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="bn-ema mode (the imagenet_resnet50 preset default) "
                        "after a --bn-ema-warmup of full-batch BN; "
                        "--no-bn-ema restores full-batch BN")
    p.add_argument("--bn-ema-warmup", type=int, default=None,
                   help="with --bn-ema: steps of full-batch BN before bn-ema "
                        "takes over (negative = that many epochs)")
    p.add_argument("--bn-ema-project", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--bn-ema-clamp", type=float, default=None)
    p.add_argument("--steps-per-dispatch", type=int, default=None,
                   help="SGD steps per train-step call")
    p.add_argument("--spd-unroll", action=argparse.BooleanOptionalAction,
                   default=None, help="accepted; no effect in the port")
    p.add_argument("--stem-s2d", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--aug-s2d", action=argparse.BooleanOptionalAction,
                   default=None)
    p.add_argument("--pool-grad", choices=["sas", "mask"], default=None)
    p.add_argument("--remat-policy", choices=["none", "conv"], default=None)
    p.add_argument("--xla-opts", default=None)
    p.add_argument("--check-numerics", action="store_true", default=None,
                   help="anomaly detection and a finite-loss check")
    p.add_argument("--seed", type=int, default=None)
    # parallel
    p.add_argument("--num-devices", type=int, default=None,
                   help="replicas: 0 or the launcher's world size")
    p.add_argument("--dp-mode", choices=["jit", "shard_map"], default=None)
    p.add_argument("--dp-comm-dtype", choices=["float32", "bfloat16"],
                   default=None)
    p.add_argument("--dp-sync", choices=["step", "dispatch"], default=None)
    return p


def _parse_tuple(s: str, typ=int) -> tuple:
    return tuple(typ(x) for x in s.split(",") if x.strip())


# flag attribute -> (section, field) for the flags copied as given
_DIRECT = {
    "network": "m", "depth": "m", "version": "m", "dataset": "m",
    "cardinality": "m",
    "data_dir": "d", "train_rec": "d", "val_rec": "d", "num_classes": "d",
    "num_examples": "d", "pipeline": "d", "preprocess_threads": "d",
    "canvas_size": "d", "min_random_area": "d", "max_random_area": "d",
    "max_aspect_ratio": "d", "min_aspect_ratio": "d",
    "min_random_scale": "d", "max_random_scale": "d", "random_h": "d",
    "random_s": "d", "random_l": "d", "max_rotate_angle": "d",
    "max_shear_ratio": "d", "max_random_contrast": "d",
    "max_random_illumination": "d", "pad": "d", "fill_value": "d",
    "rotate_backend": "d", "augment_impl": "d",
    "batch_size": "t", "lr": "t", "lr_factor": "t", "warmup_epochs": "t",
    "optimizer": "t", "mom": "t", "wd": "t", "num_epochs": "t",
    "label_smooth": "t", "frequent": "t", "model_prefix": "t",
    "load_epoch": "t", "checkpoint_frequent": "t", "dtype": "t",
    "unit_chain": "t", "grouped_merge": "t", "bn_subsample": "t",
    "bn_stat_stride": "t", "bn_ema": "t", "bn_ema_project": "t",
    "bn_ema_warmup": "t", "bn_ema_clamp": "t", "steps_per_dispatch": "t",
    "spd_unroll": "t", "stem_s2d": "t", "aug_s2d": "t", "pool_grad": "t",
    "remat_policy": "t", "xla_opts": "t", "seed": "t", "num_devices": "t",
    "dp_mode": "t", "dp_comm_dtype": "t", "dp_sync": "t",
}
# store_true flags: only a given flag sets its field
_SWITCHES = {"warmup": "t", "auto_resume": "t", "remat": "t",
             "fused_convbn": "t", "grouped_dense": "t", "bn_grouped": "t",
             "check_numerics": "t"}


def config_from_args(args: argparse.Namespace) -> Config:
    cfg = PRESETS[args.preset]() if args.preset else Config()
    upd = {"d": {}, "m": {}, "t": {}}
    for name, sec in _DIRECT.items():
        if getattr(args, name) is not None:
            upd[sec][name] = getattr(args, name)
    for name, sec in _SWITCHES.items():
        if getattr(args, name):
            upd[sec][name] = True
    if args.image_shape is not None:
        upd["d"]["image_shape"] = _parse_tuple(args.image_shape)
    if args.no_random_resized_crop:
        upd["d"]["random_resized_crop"] = False
    if args.lr_steps is not None:
        upd["t"]["lr_steps"] = _parse_tuple(args.lr_steps)
    return Config(
        data=dataclasses.replace(cfg.data, **upd["d"]),
        model=dataclasses.replace(cfg.model, **upd["m"]),
        train=dataclasses.replace(cfg.train, **upd["t"]),
    )


def parse_config(argv: Optional[Sequence[str]] = None) -> Config:
    """argv -> Config, checked by ``require_ported``."""
    cfg = config_from_args(build_parser().parse_args(argv))
    require_ported(cfg)
    return cfg
