"""Model registry: (network, depth, dataset) -> ResNet module, port of
``resnet_tpu/models/registry.py``."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from resnet_tpu_torch.config import DTYPES, Config, ModelConfig
from resnet_tpu_torch.models.resnet import (
    BOTTLENECK_MIN_DEPTH,
    CIFAR_FILTERS_BASIC,
    CIFAR_FILTERS_BOTTLENECK,
    FILTERS_BASIC,
    FILTERS_BOTTLENECK,
    IMAGENET_UNITS,
    ResNet,
)


def model_spec(m: ModelConfig, num_classes: int):
    """Resolve (units, filters, bottleneck, cifar_stem) for a config."""
    cifar = m.dataset == "cifar10"
    if m.depth in IMAGENET_UNITS:
        units = IMAGENET_UNITS[m.depth]
        bottleneck = m.depth >= BOTTLENECK_MIN_DEPTH
        filters = FILTERS_BOTTLENECK if bottleneck else FILTERS_BASIC
    elif cifar and (m.depth - 2) % 9 == 0 and m.depth >= 164:
        n = (m.depth - 2) // 9        # CIFAR 9n+2 bottleneck
        units, filters, bottleneck = (n, n, n), CIFAR_FILTERS_BOTTLENECK, True
    elif cifar and (m.depth - 2) % 6 == 0:
        n = (m.depth - 2) // 6        # CIFAR 6n+2 basic
        units, filters, bottleneck = (n, n, n), CIFAR_FILTERS_BASIC, False
    else:
        raise ValueError(f"unsupported depth {m.depth} for {m.dataset}")
    if m.network == "resnext" and not bottleneck:
        raise ValueError("resnext requires a bottleneck depth (>=50)")
    return units, filters, bottleneck, cifar


def get_model(cfg: Config,
              generator: Optional[torch.Generator] = None,
              bn_group=None) -> ResNet:
    """Build and initialize the configured model on the CPU; the init draws
    from ``generator``, by default one seeded with ``cfg.train.seed``.
    ``bn_group``: a ``torch.distributed`` process group over which every
    BatchNorm takes global-batch statistics (``dp_mode="jit"``)."""
    m, t = cfg.model, cfg.train
    units, filters, bottleneck, cifar = model_spec(m, cfg.data.num_classes)
    if t.bn_grouped and t.bn_subsample <= 1:
        raise ValueError(
            "--bn-grouped needs --bn-subsample > 1 (the number of "
            "independent normalization groups)")
    if t.bn_ema and 0 < t.bn_ema_clamp < 1:
        raise ValueError(
            "--bn-ema-clamp is a trust-region RATIO: >= 1 (1.0 = normalize "
            "with the live batch evidence, larger = more running-stats "
            "slack), or 0 to disable clamping entirely")
    if t.bn_ema and (t.bn_grouped or t.fused_convbn
                     or t.unit_chain != "off"):
        # grouped normalizes each group with its own batch statistics, the
        # opposite of normalizing with running statistics; the fused/chain
        # kernels compute batch statistics in their epilogues. Silently
        # ignoring either flag would run something other than what the
        # flags say
        raise ValueError(
            "--bn-ema does not compose with --bn-grouped, --fused-convbn "
            "or --unit-chain (those compute/apply batch statistics); "
            "drop one of the flags")
    if t.unit_chain != "off" and (t.bn_subsample > 1
                                  or t.bn_stat_stride > 1
                                  or t.remat_policy == "conv"):
        # the chain dataflow computes full-batch statistics in its
        # epilogues and manages its own residuals; ignoring these knobs
        # would run something other than what the flags say
        raise ValueError(
            "--unit-chain does not compose with --bn-subsample > 1, "
            "--bn-stat-stride > 1 or --remat-policy conv (the chain "
            "computes full-batch BN stats in-kernel); drop one of the "
            "flags")
    if (bn_group is not None and dist.get_world_size(bn_group) > 1
            and (t.fused_convbn or t.unit_chain == "pallas")):
        # the JAX package's kernels of these paths have no partitioning
        # rule: GSPMD cannot partition their Mosaic kernels, so the pair
        # does not compile on the TPU. The xla chain (separate ops) runs,
        # with global statistics (models/chain.py)
        raise ValueError(
            "--fused-convbn and --unit-chain pallas do not run under "
            "--dp-mode jit over more than one device (their kernels "
            "cannot be partitioned); use --dp-mode shard_map (per-replica "
            "BN), --unit-chain xla, or drop the flag")
    if generator is None:
        generator = torch.Generator().manual_seed(t.seed)
    return ResNet(units=units, filters=filters,
                  num_classes=cfg.data.num_classes, bottleneck=bottleneck,
                  bn_mom=m.bn_mom, bn_eps=m.bn_eps, dtype=DTYPES[t.dtype],
                  bn_ema=t.bn_ema, bn_ema_clamp=t.bn_ema_clamp,
                  bn_subsample=t.bn_subsample, bn_grouped=t.bn_grouped,
                  bn_stat_stride=t.bn_stat_stride, stem_s2d=t.stem_s2d,
                  fused=t.fused_convbn, unit_chain=t.unit_chain,
                  version=m.version,
                  cardinality=m.cardinality if m.network == "resnext" else 1,
                  group_width=m.group_width, cifar_stem=cifar,
                  grouped_dense=t.grouped_dense,
                  grouped_merge=t.grouped_merge, remat=t.remat,
                  remat_policy=t.remat_policy, pool_grad=t.pool_grad,
                  bn_group=bn_group, generator=generator)
