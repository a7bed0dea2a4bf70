"""Configuration dataclasses and the ImageNet ResNet-50 preset.

The port's own copy of the subset of ``resnet_tpu/config.py`` that its
modules read; the field names, defaults and preset values are the JAX
package's, so one configuration means the same run in both. Fields that
only later slices of the port read (data pipeline, checkpoints, data
parallel, off-default model switches) and the CLI parser are not copied
yet.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

import torch

# TrainConfig.dtype -> the compute dtype
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class DataConfig:
    """Dataset size and the on-device augmentation knobs
    (ref: mx.io.ImageRecordIter kwargs)."""

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
    random_h: int = 36                # HSL jitter, OpenCV HLS units
    random_s: int = 50
    random_l: int = 50
    mean_rgb: tuple = (123.68, 116.779, 103.939)
    std_rgb: tuple = (58.393, 57.12, 57.375)
    max_random_contrast: float = 0.0
    max_random_illumination: float = 0.0


@dataclass
class ModelConfig:
    """Network selection (ref:symbol/resnet.py get_symbol arguments)."""

    network: str = "resnet"           # resnet | resnext
    depth: int = 50
    version: int = 1                  # v1 post-activation, v2 pre-activation
    bn_mom: float = 0.9
    bn_eps: float = 2e-5
    dataset: str = "imagenet"         # imagenet | cifar10


@dataclass
class TrainConfig:
    """Optimizer, schedule and step knobs (ref:train_resnet.py config.TRAIN)."""

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
    dtype: str = "float32"            # float32 | bfloat16 compute
    bn_subsample: int = 1             # BN stats from batch//s leading images
                                      # (s=8 at batch 256 = the reference's
                                      # per-GPU 32-image stats sample count)
    bn_grouped: bool = False          # with bn_subsample s: normalize s
                                      # INDEPENDENT groups, each with its own
                                      # stats — the exact single-chip analog
                                      # of the reference's per-GPU BatchNorm
    bn_stat_stride: int = 1           # BN stats from every s-th spatial
                                      # row/column of ALL images (1/s² of the
                                      # stats-sweep HBM traffic; keeps every
                                      # image in the sample, unlike bnsub)
    bn_ema: bool = False              # live batch mean + stop-grad clamped var
    bn_ema_project: bool = True       # radial projection with bn_ema
    bn_ema_clamp: float = 1.0         # trust region vs the batch evidence
    fused_convbn: bool = False        # BN statistics fused into the 1x1 convs
    # chain dataflow for v1 bottleneck units: off | xla | pallas. The values
    # are the JAX package's; in the port "pallas" selects the hand-written
    # CUDA kernels and "xla" the same ops as separate PyTorch ops.
    unit_chain: str = "off"
    steps_per_dispatch: int = 1       # SGD steps per train-step call
    stem_s2d: bool = False            # 7x7/2 stem as a 4x4/1 conv on s2d input
    aug_s2d: bool = False             # augmenter emits the s2d block layout
    label_smooth: float = 0.0
    seed: int = 0


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def imagenet_resnet50() -> Config:
    """ResNet-50 v1 on ImageNet, one device: batch 128, lr 0.05, bf16
    compute with fp32 params, BN stats and head, bn-ema with the radial
    projection, the space-to-depth stem fed by an s2d augmenter, and six
    SGD steps per train-step call."""
    cfg = Config()
    cfg.train = dataclasses.replace(cfg.train, bn_ema=True,
                                    batch_size=128, lr=0.05,
                                    steps_per_dispatch=6,
                                    stem_s2d=True, aug_s2d=True,
                                    dtype="bfloat16")
    return cfg
