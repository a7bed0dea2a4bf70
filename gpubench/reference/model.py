"""Plain float32 ResNet v1 / ResNeXt with bottleneck units, written from
the papers' tables and the configuration file, for the benchmark's
comparison. It imports nothing of the measured program.

The network (He et al., arXiv:1512.03385, Table 1; Xie et al.,
arXiv:1611.05431, Table 1): a 7x7/2 convolution, BatchNorm, ReLU and a
3x3/2 max-pool; four stages of bottleneck units (1x1, 3x3, 1x1, each
followed by BatchNorm, ReLU after the first two and after the residual
add); a projection shortcut (1x1 convolution and BatchNorm) on each
stage's first unit; global mean-pool and a fully connected layer. Two
departures, both the MXNet recipe's and stated in the configuration
file: the stride of a stage sits on the unit's 3x3 (not its first 1x1),
and ResNeXt's middle width is ``max(filters * C * group_width // 256,
C)``.

Parameters are a flat dict keyed by the names the program's modules use
(``conv0.weight``, ``stage1_unit1.bn2.running_var``, ``fc.bias``, ...),
so the benchmark can hand one set of weights to both.

BatchNorm (``bn_mode``):

  - ``"ema"``: the bn-ema training form. The live mean of the batch,
    which carries its gradient; a stop-gradient variance, the running
    variance clipped to ``[bvar / c^2, bvar * c^2 + eps]`` around the
    batch's biased variance; the running mean, clipped to ``(c-1)`` batch
    standard deviations, enters as a constant offset. The running
    statistics then move as ``r = m * r + (1 - m) * batch``;
  - ``"eval"``: the running statistics;
  - ``"batch"``: normalize with the batch's statistics and store them as
    the running statistics (the benchmark's calibration of served
    weights).

``quant`` (None or a function) rounds the operands of every convolution
and of the fully connected layer: the control's lower precision.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def mid_width(filters: int, cardinality: int, group_width: int) -> int:
    if cardinality == 1:
        return filters // 4
    return max(filters * cardinality * group_width // 256, cardinality)


def param_shapes(arch: dict) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, kind) of every tensor of the network, kind being
    ``conv``, ``fc_weight``, ``fc_bias``, ``bn_weight``, ``bn_bias``,
    ``bn_mean`` or ``bn_var``; in a fixed order."""
    out = []

    def bn(prefix, c):
        out.extend([(f"{prefix}.weight", (c,), "bn_weight"),
                    (f"{prefix}.bias", (c,), "bn_bias"),
                    (f"{prefix}.running_mean", (c,), "bn_mean"),
                    (f"{prefix}.running_var", (c,), "bn_var")])

    filters, card = arch["filters"], arch["cardinality"]
    out.append(("conv0.weight", (filters[0], 3, 7, 7), "conv"))
    bn("bn0", filters[0])
    cin = filters[0]
    for s, (n_units, f) in enumerate(zip(arch["units"], filters[1:])):
        mid = mid_width(f, card, arch["group_width"])
        for u in range(n_units):
            p = f"stage{s + 1}_unit{u + 1}"
            out.append((f"{p}.conv1.weight", (mid, cin, 1, 1), "conv"))
            bn(f"{p}.bn1", mid)
            out.append((f"{p}.conv2.weight", (mid, mid // card, 3, 3),
                        "conv"))
            bn(f"{p}.bn2", mid)
            out.append((f"{p}.conv3.weight", (f, mid, 1, 1), "conv"))
            bn(f"{p}.bn3", f)
            if u == 0:
                out.append((f"{p}.sc.weight", (f, cin, 1, 1), "conv"))
                bn(f"{p}.sc_bn", f)
            cin = f
    out.append(("fc.weight", (arch["num_classes"], cin), "fc_weight"))
    out.append(("fc.bias", (arch["num_classes"],), "fc_bias"))
    return out


class Net:
    """The network over a flat dict of tensors. ``forward`` takes float32
    NHWC images and returns float32 logits; in ``"ema"`` and ``"batch"``
    mode it updates the running statistics in ``params`` in place."""

    def __init__(self, arch: dict, params: Params, bn_mode: str = "ema",
                 quant: Optional[Callable] = None):
        if bn_mode not in ("ema", "eval", "batch"):
            raise ValueError(f"unknown bn_mode {bn_mode!r}")
        self.arch, self.p, self.bn_mode = arch, params, bn_mode
        self.quant = quant or (lambda t: t)

    def trainable(self) -> List[str]:
        return [n for n, _, kind in param_shapes(self.arch)
                if kind not in ("bn_mean", "bn_var")]

    def _conv(self, x, name, stride=1, padding=0, groups=1):
        return F.conv2d(self.quant(x), self.quant(self.p[name]),
                        stride=stride, padding=padding, groups=groups)

    def _bn(self, x, prefix):
        a = self.arch
        w, b = self.p[prefix + ".weight"], self.p[prefix + ".bias"]
        rm = self.p[prefix + ".running_mean"]
        rv = self.p[prefix + ".running_var"]
        eps, mom = a["bn_eps"], a["bn_mom"]
        dims = (0, 2, 3)
        if self.bn_mode == "eval":
            mean, var = rm, rv
        else:
            bmean_live = x.mean(dims)
            bmean = bmean_live.detach()
            xd = x.detach()
            bvar = ((xd * xd).mean(dims) - bmean * bmean).clamp_min(0.0)
            if self.bn_mode == "batch":
                mean, var = bmean, bvar
                with torch.no_grad():
                    rm.copy_(bmean)
                    rv.copy_(bvar)
            else:
                c = a["bn_ema_clamp"]
                mean, var = rm.clone(), rv.clone()
                if c > 0:
                    var = torch.minimum(torch.maximum(var, bvar / (c * c)),
                                        bvar * c * c + eps)
                    sd = torch.sqrt(bvar + eps) * (c - 1.0)
                    mean = torch.minimum(torch.maximum(mean, bmean - sd),
                                         bmean + sd)
                with torch.no_grad():
                    rm.mul_(mom).add_((1 - mom) * bmean)
                    rv.mul_(mom).add_((1 - mom) * bvar)
                mean = bmean_live + (mean - bmean)
        scale = torch.rsqrt(var + eps) * w
        return (x - mean[:, None, None]) * scale[:, None, None] \
            + b[:, None, None]

    def _unit(self, x, prefix, stride, first, card):
        y = F.relu(self._bn(self._conv(x, prefix + ".conv1.weight"),
                            prefix + ".bn1"))
        y = F.relu(self._bn(self._conv(y, prefix + ".conv2.weight", stride,
                                       1, card), prefix + ".bn2"))
        y = self._bn(self._conv(y, prefix + ".conv3.weight"), prefix + ".bn3")
        sc = x
        if first:
            sc = self._bn(self._conv(x, prefix + ".sc.weight", stride),
                          prefix + ".sc_bn")
        return F.relu(y + sc)

    def forward(self, images_nhwc: torch.Tensor) -> torch.Tensor:
        a = self.arch
        x = images_nhwc.float().permute(0, 3, 1, 2)
        x = F.relu(self._bn(self._conv(x, "conv0.weight", 2, 3), "bn0"))
        x = F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
        for s, n_units in enumerate(a["units"]):
            for u in range(n_units):
                stride = 2 if (u == 0 and s > 0) else 1
                x = self._unit(x, f"stage{s + 1}_unit{u + 1}", stride,
                               u == 0, a["cardinality"])
        x = x.mean(dim=(2, 3))
        return F.linear(self.quant(x), self.quant(self.p["fc.weight"]),
                        self.p["fc.bias"])


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bfloat16 and back; the gradient passes through."""
    return t + (t.detach().to(torch.bfloat16).float() - t).detach()


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude to 448, the format's largest), back in float32; the
    gradient passes through unchanged."""
    with torch.no_grad():
        scale = 448.0 / t.detach().abs().amax().clamp_min(1e-30)
        q = (t.detach() * scale).to(torch.float8_e4m3fn).float() / scale
    return t + (q - t).detach()
