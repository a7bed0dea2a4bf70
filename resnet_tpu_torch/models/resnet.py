"""ResNet v1 in PyTorch, port of ``resnet_tpu/models/resnet.py``.

Public boundary NHWC, as in the JAX package; inside, tensors are NCHW in
``channels_last`` memory. The dtype flow is the JAX model's, written out
rather than left to autocast: convolutions cast input and weight to the
compute dtype; BatchNorm computes in float32 and returns the compute
dtype; the global mean-pool runs in the compute dtype; the FC head runs in
float32. Parameters keep the reference's shapes in PyTorch's layout (conv
weights OIHW, fc weight (out, in)), which is also MXNet's, so the weight
bridge (``utils/export.py``) needs no transposes.

``fused`` and ``unit_chain`` switch the execution path of v1 bottleneck
units in train mode (``models/fused.py``, ``models/chain.py``); the modules
that own the parameters and running statistics stay the same under every
switch.

Not ported yet: v2 units, the CIFAR stem, ResNeXt grouped convs and remat.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from resnet_tpu_torch.ops.pool import stem_max_pool

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
    (input and weight both cast, as flax ``nn.Conv(dtype=...)`` does)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: int = 0, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.stride, self.padding, self.dtype = stride, padding, dtype

    def reset_parameters(self, generator=None):
        _, cin, kh, kw = self.weight.shape
        variance_scaling_(self.weight, CONV_INIT_SCALE, cin * kh * kw,
                          generator)

    def forward(self, x):
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype),
                        stride=self.stride, padding=self.padding)


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
    """

    def __init__(self, features: int, momentum: float = 0.9,
                 eps: float = 2e-5, ema: bool = False,
                 ema_clamp: float = 1.0, subsample: int = 1,
                 grouped: bool = False, stat_stride: int = 1,
                 dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.momentum, self.eps = momentum, eps
        self.ema, self.ema_clamp, self.dtype = ema, ema_clamp, dtype
        self.subsample, self.grouped = subsample, grouped
        self.stat_stride = stat_stride

    def _refresh(self, mean, var):
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
        inv = torch.rsqrt(gvar + self.eps) * self.weight
        out = (xs - gmean[:, None, :, None, None]) \
            * inv[:, None, :, None, None] + self.bias[:, None, None]
        return out.reshape(xf.shape).to(self.dtype)

    def forward(self, x):
        dims = (0, 2, 3)
        xf = x.float()
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif self.grouped and self.subsample > 1:
            return self._grouped_forward(xf)
        elif self.ema:
            xs = self._stat_sample(xf)
            bmean_g = xs.mean(dims)
            bmean = bmean_g.detach()
            xs = xs.detach()
            bvar = ((xs * xs).mean(dims) - bmean * bmean).clamp_min(0.0)
            # the running stats as they were before this step's refresh
            mean = self.running_mean.clone()
            var = self.running_var.clone()
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
            xs = self._stat_sample(xf)
            mean = xs.mean(dims)
            var = ((xs * xs).mean(dims) - mean * mean).clamp_min(0.0)
            self._refresh(mean.detach(), var.detach())
        inv = torch.rsqrt(var + self.eps) * self.weight
        out = (xf - mean[:, None, None]) * inv[:, None, None] \
            + self.bias[:, None, None]
        return out.to(self.dtype)


class ResidualUnit(nn.Module):
    """v1 residual unit (ref:symbol/resnet.py residual_unit): conv-BN-ReLU
    chains, a projection shortcut conv-BN when ``dim_match`` is False, ReLU
    after the add. The stride sits on the bottleneck's 3x3.

    In train mode a bottleneck unit takes the chain dataflow when
    ``unit_chain`` is ``"xla"`` (separate PyTorch ops) or ``"pallas"`` (the
    hand-written CUDA kernels), else the fused conv+BN path when ``fused``;
    eval and basic units always take the standard path."""

    def __init__(self, cin: int, filters: int, stride: int, dim_match: bool,
                 bottleneck: bool, bn_kw: dict, dtype=torch.float32,
                 fused: bool = False, unit_chain: str = "off"):
        super().__init__()
        if unit_chain not in ("off", "xla", "pallas"):
            raise ValueError(f"unit_chain must be off|xla|pallas, got "
                             f"{unit_chain!r}")
        mid = filters // 4 if bottleneck else filters
        self.dim_match, self.bottleneck = dim_match, bottleneck
        self.fused, self.unit_chain = fused, unit_chain
        if not dim_match:
            self.sc = Conv(cin, filters, 1, stride, dtype=dtype)
            self.sc_bn = BatchNorm(filters, **bn_kw)
        if bottleneck:
            self.conv1 = Conv(cin, mid, 1, dtype=dtype)
            self.bn1 = BatchNorm(mid, **bn_kw)
            self.conv2 = Conv(mid, mid, 3, stride, 1, dtype=dtype)
            self.bn2 = BatchNorm(mid, **bn_kw)
            self.conv3 = Conv(mid, filters, 1, dtype=dtype)
            self.bn3 = BatchNorm(filters, **bn_kw)
        else:
            self.conv1 = Conv(cin, mid, 3, stride, 1, dtype=dtype)
            self.bn1 = BatchNorm(mid, **bn_kw)
            self.conv2 = Conv(mid, filters, 3, 1, 1, dtype=dtype)
            self.bn2 = BatchNorm(filters, **bn_kw)

    def forward(self, x):
        if self.bottleneck and self.training:
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
    """v1 ResNet with the ImageNet stem (ref:symbol/resnet.py ``resnet``):
    7x7/2 conv (or its space-to-depth form) - BN - ReLU - 3x3/2 max-pool,
    the residual stages (stride 2 at the entry of every stage but the
    first, a projection shortcut on every stage's first unit), global
    mean-pool and a float32 FC head.

    Input is NHWC: (N, H, W, 3) images, or (N, H/2, W/2, 12) blocks from
    the s2d augmenter, which need ``stem_s2d``. Units are registered as
    ``stage{S}_unit{U}``, the reference's names.
    """

    def __init__(self, units: Sequence[int], filters: Sequence[int],
                 num_classes: int, bottleneck: bool, bn_mom: float = 0.9,
                 bn_eps: float = 2e-5, dtype=torch.float32,
                 bn_ema: bool = False, bn_ema_clamp: float = 1.0,
                 bn_subsample: int = 1, bn_grouped: bool = False,
                 bn_stat_stride: int = 1,
                 stem_s2d: bool = False, fused: bool = False,
                 unit_chain: str = "off",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype, self.stem_s2d = dtype, stem_s2d
        bn_kw = dict(momentum=bn_mom, eps=bn_eps, ema=bn_ema,
                     ema_clamp=bn_ema_clamp, subsample=bn_subsample,
                     grouped=bn_grouped, stat_stride=bn_stat_stride,
                     dtype=dtype)
        if stem_s2d:
            self.conv0 = StemConvS2D(3, filters[0], dtype=dtype)
        else:
            self.conv0 = Conv(3, filters[0], 7, 2, 3, dtype=dtype)
        self.bn0 = BatchNorm(filters[0], **bn_kw)
        cin = filters[0]
        for stage, (n_units, n_filter) in enumerate(zip(units, filters[1:])):
            for unit in range(n_units):
                first = unit == 0
                stride = 2 if (first and stage > 0) else 1
                self.add_module(
                    f"stage{stage + 1}_unit{unit + 1}",
                    ResidualUnit(cin, n_filter, stride, dim_match=not first,
                                 bottleneck=bottleneck, bn_kw=bn_kw,
                                 dtype=dtype, fused=fused,
                                 unit_chain=unit_chain))
                cin = n_filter
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
        if pre_blocked and not self.stem_s2d:
            raise ValueError(
                "pre-blocked (12-channel) stem input needs stem_s2d")
        x = x.permute(0, 3, 1, 2)        # NHWC -> NCHW view, channels_last
        if self.stem_s2d:
            x = self.conv0(x, pre_blocked=pre_blocked)
        else:
            x = self.conv0(x)
        x = stem_max_pool(F.relu(self.bn0(x)))
        for unit in self.units():
            x = unit(x)
        x = x.mean(dim=(2, 3))           # global mean-pool, compute dtype
        return self.fc(x)                # float32 head
