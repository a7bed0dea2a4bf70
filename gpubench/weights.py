"""Weights made from the run's seed on the run's device, in one draw,
and handed to both the program and the reference.

Convolutions take MSRA's normal (variance 2 / fan-in), the classifier a
normal of variance 1 / fan-in and a zero bias; BatchNorm running mean 0
and variance 1, and the scale and shift that the configuration's file
states under ``init`` (``bn_scale``, ``bn_shift``), except the scale of
the last BatchNorm of each residual branch (``bn3``), which is
``init.residual_bn_scale``: a small form of the zero scale there of Goyal
et al. (arXiv:1706.02677, section 5.1), and the state a trained ResNet's
branches end in. At scale 1 the random network amplifies a perturbation about 1.3 times a unit, so bfloat16's
rounding alone moves its served logits by 10% RMS, as float8's moves them
by 21%, and no comparison could tell the two apart; at 0.2, 0.8% against
10% (the reference at 224x224, 32 noise images).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from gpubench.reference.model import param_shapes
from gpubench.traffic import WEIGHTS_STREAM, seeded

_FILL = {"bn_mean": 0.0, "bn_var": 1.0, "fc_bias": 0.0}


def make(config: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``config``'s model (its ``model`` and ``init``
    entries) for ``seed``."""
    specs = param_shapes(config["model"])
    init = config["init"]
    fills = dict(_FILL, bn_weight=init["bn_scale"], bn_bias=init["bn_shift"])
    residual = init["residual_bn_scale"]
    drawn = [(n, s, kind) for n, s, kind in specs if kind not in fills]
    counts = [math.prod(s) for _, s, _ in drawn]
    stds = torch.tensor([math.sqrt((2.0 if kind == "conv" else 1.0)
                                   / math.prod(s[1:]))
                         for _, s, kind in drawn], device=device)
    flat = torch.randn(sum(counts), generator=seeded(seed, WEIGHTS_STREAM,
                                                     device), device=device)
    flat *= torch.repeat_interleave(
        stds, torch.tensor(counts, device=device))
    out = {n: t.view(s) for (n, s, _), t in
           zip(drawn, flat.split(counts))}
    for n, s, kind in specs:
        if kind in fills:
            fill = residual if n.endswith(".bn3.weight") else fills[kind]
            out[n] = torch.full(s, fill, device=device)
    return {n: out[n] for n, _, _ in specs}


@torch.no_grad()
def load_into(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
              ) -> None:
    """Copy ``weights`` into the program's model by name; every tensor of
    the model and every weight must find its counterpart, shape for
    shape."""
    own = dict(model.named_parameters())
    own.update(model.named_buffers())
    missing = sorted(set(own) ^ set(weights))
    if missing:
        raise ValueError(f"the model and the benchmark's weights differ in "
                         f"{missing[:6]} ({len(missing)} names)")
    for name, t in own.items():
        if tuple(t.shape) != tuple(weights[name].shape):
            raise ValueError(f"{name}: model {tuple(t.shape)}, weights "
                             f"{tuple(weights[name].shape)}")
        t.copy_(weights[name])
