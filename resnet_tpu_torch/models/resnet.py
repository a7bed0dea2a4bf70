"""The ResNet / ResNeXt family in PyTorch, port of
``resnet_tpu/models/resnet.py``: v1 (post-activation) and v2
(pre-activation) units, basic and bottleneck, ResNeXt's grouped 3x3 and its
block-diagonal lowering, the ImageNet and CIFAR stems, and remat.

Public boundary NHWC, as in the JAX package; inside, tensors are NCHW in
``channels_last`` memory. The dtype flow is the JAX model's, written out
rather than left to autocast: convolutions cast input and weight to the
compute dtype; BatchNorm computes in float32 and returns the compute
dtype; the global mean-pool runs in the compute dtype; the FC head runs in
float32. Parameters keep the reference's shapes in PyTorch's layout (conv
weights OIHW, fc weight (out, in)), which is also MXNet's, so the weight
bridge (``utils/export.py``) needs no transposes.

``fused`` and ``unit_chain`` switch the execution path of v1 bottleneck
units with ``cardinality == 1`` in train mode (``models/fused.py``,
``models/chain.py``); ``grouped_dense`` switches the lowering of the
grouped 3x3, and ``remat``/``remat_policy`` what a unit keeps for its
backward. The modules that own the parameters and running statistics stay
the same under every switch.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from resnet_tpu_torch.ops.pool import stem_max_pool
from resnet_tpu_torch.parallel.dist import all_reduce_sum

# Depth -> per-stage unit counts (ref:symbol/resnet.py depth table)
IMAGENET_UNITS = {
    18: (2, 2, 2, 2),
    34: (3, 4, 6, 3),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
    200: (3, 24, 36, 3),
    269: (3, 30, 48, 8),
}
BOTTLENECK_MIN_DEPTH = 50
FILTERS_BOTTLENECK = (64, 256, 512, 1024, 2048)
FILTERS_BASIC = (64, 64, 128, 256, 512)
CIFAR_FILTERS_BASIC = (16, 16, 32, 64)
CIFAR_FILTERS_BOTTLENECK = (16, 64, 128, 256)

# MSRA init (ref:train_resnet.py Xavier(gaussian, in, 2)): flax's
# variance_scaling(scale, "fan_in", "normal") draws an untruncated normal
# with variance scale / fan_in ("truncated_normal" is the truncated one)
CONV_INIT_SCALE = 2.0
DENSE_INIT_SCALE = 1.0


def variance_scaling_(w: torch.Tensor, scale: float, fan_in: int,
                      generator: Optional[torch.Generator] = None
                      ) -> torch.Tensor:
    with torch.no_grad():
        return nn.init.normal_(w, 0.0, math.sqrt(scale / fan_in),
                               generator=generator)


class Conv(nn.Module):
    """Bias-free 2-D convolution with an OIHW weight, computed in ``dtype``
    (input and weight both cast, as flax ``nn.Conv(dtype=...)`` does).
    ``groups > 1``: a grouped convolution over the (O, I/G, kh, kw) weight,
    flax's ``feature_group_count``."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32, groups: int = 1):
        super().__init__()
        if cin % groups or cout % groups:
            raise ValueError(f"{groups} groups do not divide {cin} -> {cout} "
                             "channels")
        self.weight = nn.Parameter(
            torch.empty(cout, cin // groups, kernel, kernel))
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.groups = groups

    def reset_parameters(self, generator=None):
        _, cin, kh, kw = self.weight.shape
        variance_scaling_(self.weight, CONV_INIT_SCALE, cin * kh * kw,
                          generator)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding,
                        groups=self.groups)


class GroupedConvDense(Conv):
    """A grouped convolution lowered with ``merge`` groups fused per dense
    block, port of ``_GroupedConvDense``.

    The parameter is the grouped convolution's own (O, I/G, kh, kw) weight,
    so checkpoints interchange with :class:`Conv`. Each forward builds from
    it, in float32, the weight of a convolution with ``G/merge`` groups of
    ``merge`` original groups each: block-diagonal within an outer group
    (input slot ``n`` of outer group ``j`` reaches the outputs of inner
    group ``m`` only where ``n == m``, zero elsewhere), then casts it to
    the compute dtype. The zeros are structural: gradients reach only the
    real parameter. ``merge=0`` or ``G`` is the fully dense lowering.
    """

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 padding: int, groups: int, merge: int = 0,
                 dtype=torch.float32):
        super().__init__(cin, cout, kernel, stride, padding, dtype, groups)
        self.merge = merge or groups
        if groups % self.merge:
            raise ValueError(f"merge {self.merge} does not divide {groups} "
                             "groups")

    def dense_weight(self) -> torch.Tensor:
        """The (O, merge·I/G, kh, kw) weight of the merged convolution."""
        f = self.merge
        cout, cg, kh, kw = self.weight.shape
        go, cog = self.groups // f, cout // self.groups
        # k6[j, m, o, c, h, w]: output o of inner group m of outer group j
        # (output channels run over (j, m, o), as the original groups do)
        k6 = self.weight.float().reshape(go, f, cog, cg, kh, kw)
        eye = torch.eye(f, dtype=torch.float32, device=k6.device)
        dense = torch.einsum("jmochw,nm->jmonchw", k6, eye)
        # the inputs of outer group j run over (n, c): original group
        # j·merge + n, its channel c
        return dense.reshape(cout, f * cg, kh, kw)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.dense_weight().to(self.dtype),
                        stride=self.stride, padding=self.padding,
                        groups=self.groups // self.merge)


class Dense(nn.Module):
    """Fully connected layer, weight (out, in), computed in float32."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))

    def reset_parameters(self, generator=None):
        variance_scaling_(self.weight, DENSE_INIT_SCALE, self.weight.shape[1],
                          generator)
        with torch.no_grad():
            self.bias.zero_()

    def forward(self, x):
        return F.linear(x.float(), self.weight, self.bias)


class StemConvS2D(Conv):
    """The 7x7/2 stem conv lowered in space-to-depth form.

    The parameter stays the reference's (F, C, 7, 7) kernel. In forward it
    is padded by one at the leading edge to 8x8 and regrouped into 2x2
    blocks with input channels in (py, px, c) order, and the conv runs
    4x4/1 over the (H/2, W/2, 4C) blocked input with padding (2, 1): the
    same contraction as the 7x7/2 conv with padding 3. ``pre_blocked``
    input arrives already blocked from the augmenter; an input of odd size
    takes the plain 7x7/2 conv.
    """

    def __init__(self, cin: int, cout: int, dtype=torch.float32):
        super().__init__(cin, cout, 7, stride=2, padding=3, dtype=dtype)

    def forward(self, x, pre_blocked: bool = False):
        n, c, h, w = x.shape
        if not pre_blocked:
            if h % 2 or w % 2:
                return super().forward(x)
            x = (x.reshape(n, c, h // 2, 2, w // 2, 2)
                  .permute(0, 3, 5, 1, 2, 4)
                  .reshape(n, 4 * c, h // 2, w // 2)
                  .contiguous(memory_format=torch.channels_last))
        f, cin = self.weight.shape[:2]
        k = F.pad(self.weight, (1, 0, 1, 0))                   # (F,C,8,8)
        k = (k.reshape(f, cin, 4, 2, 4, 2)                     # f c by py bx px
              .permute(0, 3, 5, 1, 2, 4)                       # f py px c by bx
              .reshape(f, 4 * cin, 4, 4))
        x = F.pad(x.to(self.dtype), (2, 1, 2, 1))
        return F.conv2d(x, k.to(self.dtype))


class BatchNorm(nn.Module):
    """BatchNorm with MXNet/flax semantics and the train-mode statistic
    modes of the JAX package's ``SubsampleBatchNorm``.

    Statistics are float32: ``mean = E[x]``, ``var = max(0, E[x²] - mean²)``
    and the running stats move as ``ra = m·ra + (1-m)·batch`` with the
    biased variance. ``F.batch_norm`` differs on both counts and is not
    used in train mode.

    Train-mode statistics come from the stat sample: the leading
    ``k = max(1, n // subsample)`` images, and of those every
    ``stat_stride``-th spatial row and column (``x[:k, :, ::s, ::s]``; at
    ``subsample = stat_stride = 1`` the whole batch). They carry their
    gradient, so only the sampled values receive the statistics' share.

    ``grouped=True`` with ``subsample > 1``: the batch splits into
    ``min(subsample, n)`` contiguous groups and each is normalized with the
    statistics of its own (strided) sample, the semantics of per-device
    BatchNorm over that many devices; the running stats move with the mean
    over groups of the group statistics.

    ``ema=True`` (bn-ema): normalize with the live mean of the stat sample,
    which keeps its gradient, and a stop-gradient variance: the running
    variance read before this step's refresh, clipped to
    ``[bvar/c², bvar·c² + eps]`` around the sample's variance
    (``c = ema_clamp``; 0 disables the clip); the running mean, clipped to
    ``(c-1)·σ`` of the sample mean, enters as a constant offset. At
    ``c = 1`` both are the sample's own statistics. ``grouped`` takes
    precedence (the registry refuses the pair).

    Eval mode normalizes with the running statistics in every mode.

    ``use_scale=False`` (the reference's ``fix_gamma``): no scale
    parameter at all, ``weight`` is None, as flax has no ``scale``.

    Under remat (:func:`remat_unit`) a unit's forward runs twice; the
    second run, the recomputation, refreshes nothing and reads the running
    statistics the first run read (``remat_pass``).

    ``group`` (a ``torch.distributed`` process group whose ranks each hold
    a contiguous block of one global batch, rank order = batch order):
    train-mode statistics over the GLOBAL batch, every mode above as the
    JAX model computes it over the whole sharded batch (``dp_mode="jit"``,
    ``sync_bn``). Each rank's share of E[x] and E[x²] is summed across the
    group in float32 by a differentiable all-reduce, so the backward
    reduces too; a rank that holds none of the stat sample adds zeros.
    Without a group nothing changes.
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 2e-5, ema: bool = False,
                 ema_clamp: float = 1.0, subsample: int = 1,
                 grouped: bool = False, stat_stride: int = 1,
                 dtype=torch.float32, use_scale: bool = True,
                 group=None):
        super().__init__()
        if use_scale:
            self.weight = nn.Parameter(torch.ones(features))
        else:
            self.register_parameter("weight", None)
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps = momentum, eps
        self.ema, self.ema_clamp, self.dtype = ema, ema_clamp, dtype
        self.subsample, self.grouped = subsample, grouped
        self.stat_stride = stat_stride
        self.group = group
        self.remat_pass: Optional[RematPass] = None

    def _scaled(self, inv):
        return inv if self.weight is None else inv * self.weight

    def _pre_step_stats(self):
        """The running statistics as they were before this step's refresh:
        a copy, or under remat the first run's copy."""
        rp = self.remat_pass
        if rp is not None and rp.replay:
            return rp.stash[id(self)]
        stats = self.running_mean.clone(), self.running_var.clone()
        if rp is not None:
            rp.stash[id(self)] = stats
        return stats

    def _refresh(self, mean, var):
        if self.remat_pass is not None and self.remat_pass.replay:
            return
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
            self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def _strided(self, t):
        """Every ``stat_stride``-th row and column of the two trailing
        (spatial) dims."""
        s = self.stat_stride
        return t if s <= 1 else t[..., ::s, ::s]

    def _stat_sample(self, xf):
        k = max(1, xf.shape[0] // self.subsample)
        return self._strided(xf[:k] if k < xf.shape[0] else xf)

    def _grouped_forward(self, xf):
        n = xf.shape[0]
        g = min(self.subsample, n)
        if n % g:
            raise ValueError(
                f"grouped BN: batch {n} not divisible by {g} groups")
        xs = xf.reshape(g, n // g, *xf.shape[1:])      # (g, n/g, C, H, W)
        ss = self._strided(xs)
        red = (1, 3, 4)
        gmean = ss.mean(red)                           # (g, C)
        gvar = ((ss * ss).mean(red) - gmean * gmean).clamp_min(0.0)
        self._refresh(gmean.detach().mean(0), gvar.detach().mean(0))
        inv = self._scaled(torch.rsqrt(gvar + self.eps))
        out = (xs - gmean[:, None, :, None, None]) \
            * inv[:, None, :, None, None] + self.bias[:, None, None]
        return out.reshape(xf.shape).to(self.dtype)

    def _global_moments(self, xf, detach_sq: bool):
        """(E[x], E[x²]) per channel over the global stat sample: the
        leading ``max(1, N // subsample)`` images of the global batch of
        ``N``, strided. Each rank weights the moments of its part by its
        share of the sample; at world size 1 the weight is exactly 1, so
        the moments are the local path's bit for bit."""
        world = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        n = xf.shape[0]
        k = max(1, n * world // self.subsample)
        mine = min(max(k - rank * n, 0), n)
        xs = self._strided(xf[:mine] if mine < n else xf)
        dims = (0, 2, 3)
        if mine:
            m1 = xs.mean(dims) * (mine / k)
            m2 = (xs * xs).mean(dims) * (mine / k)
        else:
            # zeros that still reach this rank's graph: every rank must
            # join the backward's all-reduce
            m1, m2 = xs.sum(dims), (xs * xs).sum(dims)
        both = all_reduce_sum(torch.stack([m1, m2.detach() if detach_sq
                                           else m2]), self.group)
        return both[0], both[1]

    def _global_grouped_forward(self, xf):
        """``grouped`` over the global batch: ``min(subsample, N)``
        contiguous groups of the global batch, which may span ranks."""
        world = dist.get_world_size(self.group)
        rank = dist.get_rank(self.group)
        n = xf.shape[0]
        g = min(self.subsample, n * world)
        if (n * world) % g:
            raise ValueError(f"grouped BN: global batch {n * world} not "
                             f"divisible by {g} groups")
        size = n * world // g
        ss = self._strided(xf)
        gid = (rank * n + torch.arange(n, device=xf.device)) // size
        onehot = (gid[None, :] == torch.arange(g, device=xf.device)[:, None]
                  ).float() / size                             # (g, n)
        both = all_reduce_sum(torch.cat([onehot @ ss.mean((2, 3)),
                                         onehot @ (ss * ss).mean((2, 3))]),
                              self.group)
        gmean = both[:g]                                       # (g, C)
        gvar = (both[g:] - gmean * gmean).clamp_min(0.0)
        self._refresh(gmean.detach().mean(0), gvar.detach().mean(0))
        inv = self._scaled(torch.rsqrt(gvar + self.eps))
        out = (xf - gmean[gid][:, :, None, None]) \
            * inv[gid][:, :, None, None] + self.bias[:, None, None]
        return out.to(self.dtype)

    def forward(self, x):
        dims = (0, 2, 3)
        xf = x.float()
        sync = self.group is not None
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif self.grouped and self.subsample > 1:
            return (self._global_grouped_forward(xf) if sync
                    else self._grouped_forward(xf))
        elif self.ema:
            if sync:
                bmean_g, bsq = self._global_moments(xf, detach_sq=True)
                bmean = bmean_g.detach()
                bsq = bsq.detach()
            else:
                xs = self._stat_sample(xf)
                bmean_g = xs.mean(dims)
                bmean = bmean_g.detach()
                xs = xs.detach()
                bsq = (xs * xs).mean(dims)
            bvar = (bsq - bmean * bmean).clamp_min(0.0)
            mean, var = self._pre_step_stats()
            if self.ema_clamp > 0:
                c2 = self.ema_clamp * self.ema_clamp
                var = torch.minimum(torch.maximum(var, bvar / c2),
                                    bvar * c2 + self.eps)
                sd = torch.sqrt(bvar + self.eps) * (self.ema_clamp - 1.0)
                mean = torch.minimum(torch.maximum(mean, bmean - sd),
                                     bmean + sd)
            self._refresh(bmean, bvar)
            mean = bmean_g + (mean - bmean)
        else:
            if sync:
                mean, sq = self._global_moments(xf, detach_sq=False)
            else:
                xs = self._stat_sample(xf)
                mean = xs.mean(dims)
                sq = (xs * xs).mean(dims)
            var = (sq - mean * mean).clamp_min(0.0)
            self._refresh(mean.detach(), var.detach())
        inv = self._scaled(torch.rsqrt(var + self.eps))
        out = (xf - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]
        return out.to(self.dtype)


class RematPass:
    """What the two runs of a rematerialized unit share: the running
    statistics each of its BatchNorms read in the first run (``stash``,
    by module id), and whether the run now going is the recomputation."""

    def __init__(self):
        self.stash = {}
        self.replay = False


# the ops whose outputs remat_policy="conv" keeps: the convolutions'
# outputs and the BatchNorm statistics' per-channel means
_CONV_POLICY_SAVES = (torch.ops.aten.convolution.default,
                      torch.ops.aten.mean.dim)


def _conv_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _CONV_POLICY_SAVES
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_unit(unit: nn.Module, x: torch.Tensor,
               selective: bool = False) -> torch.Tensor:
    """Run ``unit`` on ``x`` under ``torch.utils.checkpoint``: its
    activations are recomputed in the backward instead of kept (the
    reference's memonger ``mirror_stage``). ``selective``: keep the
    convolutions' outputs and the BatchNorm statistics and recompute only
    the normalize/ReLU chain around them (``remat_policy="conv"``).

    The recomputation refreshes no running statistic and reads the ones
    the first run read, so a step with remat leaves the model as one
    without does (JAX's functional ``nn.remat`` gets this for free)."""
    rp = RematPass()
    bns = [m for m in unit.modules() if isinstance(m, BatchNorm)]

    def run(inp):
        for bn in bns:
            bn.remat_pass = rp
        try:
            return unit(inp)
        finally:
            for bn in bns:
                bn.remat_pass = None
            rp.replay = True

    kw = {}
    if selective:
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _conv_policy)
    return checkpoint(run, x, use_reentrant=False, **kw)


class ResidualUnit(nn.Module):
    """One residual unit (ref:symbol/resnet.py residual_unit, resnext.py).

    v1: conv-BN-ReLU chains, a projection shortcut conv-BN when
    ``dim_match`` is False, ReLU after the add. v2: pre-activation
    BN-ReLU-conv chains, the projection shortcut taken from the first
    pre-activation without a BN, a plain add. The stride sits on the
    bottleneck's 3x3. ``cardinality > 1`` makes that 3x3 a grouped conv
    (ResNeXt) of ``mid`` channels, lowered block-diagonally with
    ``grouped_dense`` (``GroupedConvDense``, ``grouped_merge`` groups a
    block).

    In train mode a v1 bottleneck unit with ``cardinality == 1`` takes the
    chain dataflow when ``unit_chain`` is ``"xla"`` (separate PyTorch ops)
    or ``"pallas"`` (the hand-written CUDA kernels), else the fused
    conv+BN path when ``fused``; every other unit, and eval, takes the
    standard path."""

    def __init__(self, cin: int, filters: int, stride: int, dim_match: bool,
                 bottleneck: bool, bn_kw: dict, dtype=torch.float32,
                 fused: bool = False, unit_chain: str = "off",
                 version: int = 1, cardinality: int = 1,
                 mid: Optional[int] = None, grouped_dense: bool = False,
                 grouped_merge: int = 0):
        super().__init__()
        if unit_chain not in ("off", "xla", "pallas"):
            raise ValueError(f"unit_chain must be off|xla|pallas, got "
                             f"{unit_chain!r}")
        if version not in (1, 2):
            raise ValueError(f"version must be 1 or 2, got {version}")
        if mid is None:
            mid = filters // 4 if bottleneck else filters
        self.dim_match, self.bottleneck = dim_match, bottleneck
        self.version, self.cardinality = version, cardinality
        self.fused, self.unit_chain = fused, unit_chain
        bn = partial(BatchNorm, **bn_kw)
        conv = partial(Conv, dtype=dtype)

        def grouped3x3():
            """The bottleneck's 3x3: grouped conv, or its block-diagonal
            lowering; the same ``conv2`` parameter either way."""
            if cardinality > 1 and grouped_dense:
                return GroupedConvDense(mid, mid, 3, stride, 1, cardinality,
                                        grouped_merge, dtype=dtype)
            return conv(mid, mid, 3, stride, 1, groups=cardinality)

        if version == 2:
            self.bn1 = bn(cin)
            if not dim_match:
                self.sc = conv(cin, filters, 1, stride)
            if bottleneck:
                self.conv1 = conv(cin, mid, 1)
                self.bn2 = bn(mid)
                self.conv2 = grouped3x3()
                self.bn3 = bn(mid)
                self.conv3 = conv(mid, filters, 1)
            else:
                self.conv1 = conv(cin, mid, 3, stride, 1)
                self.bn2 = bn(mid)
                self.conv2 = conv(mid, filters, 3, 1, 1)
            return
        if not dim_match:
            self.sc = conv(cin, filters, 1, stride)
            self.sc_bn = bn(filters)
        if bottleneck:
            self.conv1 = conv(cin, mid, 1)
            self.bn1 = bn(mid)
            self.conv2 = grouped3x3()
            self.bn2 = bn(mid)
            self.conv3 = conv(mid, filters, 1)
            self.bn3 = bn(filters)
        else:
            self.conv1 = conv(cin, mid, 3, stride, 1)
            self.bn1 = bn(mid)
            self.conv2 = conv(mid, filters, 3, 1, 1)
            self.bn2 = bn(filters)

    def forward(self, x):
        if self.version == 2:
            return self._forward_v2(x)
        if self.bottleneck and self.training and self.cardinality == 1:
            if self.unit_chain != "off":
                from resnet_tpu_torch.models.chain import chain_unit_v1
                return chain_unit_v1(self, x, backend=self.unit_chain)
            if self.fused:
                return self._forward_fused(x)
        shortcut = x if self.dim_match else self.sc_bn(self.sc(x))
        y = F.relu(self.bn1(self.conv1(x)))
        if self.bottleneck:
            y = F.relu(self.bn2(self.conv2(y)))
            y = self.bn3(self.conv3(y))
        else:
            y = self.bn2(self.conv2(y))
        return F.relu(y + shortcut)

    def _forward_v2(self, x):
        """Pre-activation (He et al. 2016, Identity Mappings)."""
        pre = F.relu(self.bn1(x))
        shortcut = x if self.dim_match else self.sc(pre)
        y = F.relu(self.bn2(self.conv1(pre)))
        if self.bottleneck:
            y = F.relu(self.bn3(self.conv2(y)))
            y = self.conv3(y)
        else:
            y = self.conv2(y)
        return y + shortcut

    def _forward_fused(self, x):
        """Train-mode bottleneck with the BN statistics of the three 1x1
        convs fused into their products; the 3x3 and bn2 stay standard.
        As in the JAX package, the fused BNs take full-batch statistics
        whatever the statistic mode says; only bn2 follows it."""
        from resnet_tpu_torch.models.fused import fused_conv_bn
        shortcut = x
        if not self.dim_match:
            shortcut = fused_conv_bn(x, self.sc, self.sc_bn, relu=False)
        y = fused_conv_bn(x, self.conv1, self.bn1, relu=True)
        y = F.relu(self.bn2(self.conv2(y)))
        y = fused_conv_bn(y, self.conv3, self.bn3, relu=False)
        return F.relu(y + shortcut)


class ResNet(nn.Module):
    """The network (ref:symbol/resnet.py ``resnet``): stem, the residual
    stages (stride 2 at the entry of every stage but the first, a
    projection shortcut on every stage's first unit), BN-ReLU for v2,
    global mean-pool and a float32 FC head.

    Stems: ImageNet, 7x7/2 conv (or its space-to-depth form) - BN - ReLU -
    3x3/2 max-pool (``pool_grad`` picks its backward); CIFAR
    (``cifar_stem``), 3x3/1 conv, then BN-ReLU for v1 only, no pool. v2
    puts a fixed-gamma BN (``bn_data``) on the raw input. ResNeXt
    (``cardinality > 1``, bottleneck only) widens each unit's middle to
    ``max(filters·C·group_width // 256, C)``.

    ``remat``: every residual unit runs under ``remat_unit`` in training;
    else ``remat_policy="conv"``, the selective form.

    ``bn_group``: every BatchNorm takes its train-mode statistics over the
    global batch of that process group (``BatchNorm``'s ``group``).

    Input is NHWC: (N, H, W, 3) images, or (N, H/2, W/2, 12) blocks from
    the s2d augmenter, which need ``stem_s2d`` and a v1 ImageNet net.
    Units are registered as ``stage{S}_unit{U}``, the reference's names.
    """

    def __init__(self, units: Sequence[int], filters: Sequence[int],
                 num_classes: int, bottleneck: bool, bn_mom: float = 0.9,
                 bn_eps: float = 2e-5, dtype=torch.float32,
                 bn_ema: bool = False, bn_ema_clamp: float = 1.0,
                 bn_subsample: int = 1, bn_grouped: bool = False,
                 bn_stat_stride: int = 1,
                 stem_s2d: bool = False, fused: bool = False,
                 unit_chain: str = "off", version: int = 1,
                 cardinality: int = 1, group_width: int = 4,
                 cifar_stem: bool = False, grouped_dense: bool = False,
                 grouped_merge: int = 0, remat: bool = False,
                 remat_policy: str = "none", pool_grad: str = "sas",
                 bn_group=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if remat_policy not in ("none", "conv"):
            raise ValueError(f"remat_policy must be none|conv, got "
                             f"{remat_policy!r}")
        if pool_grad not in ("sas", "mask"):
            raise ValueError(f"unknown pool grad_mode: {pool_grad!r}")
        self.dtype, self.stem_s2d = dtype, stem_s2d
        self.version, self.cifar_stem = version, cifar_stem
        self.remat, self.remat_policy = remat, remat_policy
        self.pool_grad = pool_grad
        bn_kw = dict(momentum=bn_mom, eps=bn_eps, ema=bn_ema,
                     ema_clamp=bn_ema_clamp, subsample=bn_subsample,
                     grouped=bn_grouped, stat_stride=bn_stat_stride,
                     dtype=dtype, group=bn_group)
        if version == 2:
            self.bn_data = BatchNorm(3, use_scale=False, **bn_kw)
        if cifar_stem:
            self.conv0 = Conv(3, filters[0], 3, 1, 1, dtype=dtype)
        elif stem_s2d:
            self.conv0 = StemConvS2D(3, filters[0], dtype=dtype)
        else:
            self.conv0 = Conv(3, filters[0], 7, 2, 3, dtype=dtype)
        if not (cifar_stem and version == 2):
            self.bn0 = BatchNorm(filters[0], **bn_kw)
        cin = filters[0]
        cardinality = cardinality if bottleneck else 1
        for stage, (n_units, n_filter) in enumerate(zip(units, filters[1:])):
            mid = None
            if cardinality > 1:
                # ResNeXt width rule (ref:symbol/resnext.py)
                mid = max(n_filter * cardinality * group_width // 256,
                          cardinality)
            for unit in range(n_units):
                first = unit == 0
                stride = 2 if (first and stage > 0) else 1
                self.add_module(
                    f"stage{stage + 1}_unit{unit + 1}",
                    ResidualUnit(cin, n_filter, stride, dim_match=not first,
                                 bottleneck=bottleneck, bn_kw=bn_kw,
                                 dtype=dtype, fused=fused and version == 1,
                                 unit_chain=unit_chain, version=version,
                                 cardinality=cardinality, mid=mid,
                                 grouped_dense=grouped_dense,
                                 grouped_merge=grouped_merge))
                cin = n_filter
        if version == 2:
            self.bn_final = BatchNorm(cin, **bn_kw)
        self.fc = Dense(cin, num_classes)
        self.reset_parameters(generator)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """MSRA conv init and the variance-scaled fc; BN starts at scale 1,
        shift 0."""
        for mod in self.modules():
            if isinstance(mod, (Conv, Dense)):
                mod.reset_parameters(generator)

    def units(self):
        return [m for m in self.children() if isinstance(m, ResidualUnit)]

    def forward(self, x):
        x = x.to(self.dtype)
        pre_blocked = x.shape[-1] == 12
        if pre_blocked and (not self.stem_s2d or self.cifar_stem
                            or self.version != 1):
            raise ValueError(
                "pre-blocked (12-channel) stem input needs stem_s2d and a "
                "v1 net with the ImageNet stem")
        x = x.permute(0, 3, 1, 2)        # NHWC -> NCHW view, channels_last
        if self.version == 2:
            x = self.bn_data(x)
        if self.cifar_stem:
            x = self.conv0(x)
            if self.version == 1:
                x = F.relu(self.bn0(x))
        else:
            if self.stem_s2d:
                x = self.conv0(x, pre_blocked=pre_blocked)
            else:
                x = self.conv0(x)
            x = stem_max_pool(F.relu(self.bn0(x)), self.pool_grad)
        remat = ((self.remat or self.remat_policy == "conv")
                 and self.training and torch.is_grad_enabled())
        for unit in self.units():
            if remat:
                x = remat_unit(unit, x, selective=not self.remat)
            else:
                x = unit(x)
        if self.version == 2:
            x = F.relu(self.bn_final(x))
        x = x.mean(dim=(2, 3))           # global mean-pool, compute dtype
        return self.fc(x)                # float32 head
