"""MXNet-semantics SGD and the radial projection, port of
``resnet_tpu/train/optim.py``.

MXNet's momentum update (src/operator/optimizer_op.cc ``sgd_mom_update``)
keeps the learning rate inside the momentum and decays every parameter,
BN scale and shift and the fc bias included:

    mom    = momentum * mom - lr * (grad + wd * weight)
    weight = weight + mom

Unlike optax, which returns new arrays, these functions update the
parameters and momentum buffers in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Sequence

import torch


def radial_projection(grads: Sequence[torch.Tensor],
                      params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Project every 4-D (conv) gradient orthogonal to its output filter,
    ``g <- g - w·<g,w>/<w,w>`` per output channel; other gradients pass
    through. Restores the scale-invariance backward that stop-gradient BN
    (bn-ema) drops. Kernels are OIHW here, so the sums run over
    (I, H, W); the JAX package sums HWIO over (H, W, I)."""
    out = []
    for g, p in zip(grads, params):
        if g.ndim != 4:
            out.append(g)
            continue
        num = (g * p).sum(dim=(1, 2, 3), keepdim=True)
        den = (p * p).sum(dim=(1, 2, 3), keepdim=True)
        out.append(g - p * (num / den.clamp_min(1e-12)))
    return out


@torch.no_grad()
def mxnet_sgd_(params: List[torch.Tensor], grads: List[torch.Tensor],
               momentum_bufs: List[torch.Tensor], lr: float,
               momentum: float = 0.9, weight_decay: float = 1e-4,
               nesterov: bool = False) -> None:
    """One MXNet SGD (or NAG) update, in place on ``params`` and
    ``momentum_bufs``.

    NAG (python/mxnet/optimizer.py NAG.update):
    ``mom = momentum·mom + (grad + wd·w)``, then
    ``w += -lr·(grad + wd·w + momentum·mom)``.
    """
    g = torch._foreach_mul(params, weight_decay)
    torch._foreach_add_(g, grads)                     # grad + wd * w
    torch._foreach_mul_(momentum_bufs, momentum)
    if nesterov:
        torch._foreach_add_(momentum_bufs, g)
        torch._foreach_add_(g, torch._foreach_mul(momentum_bufs, momentum))
        torch._foreach_mul_(g, -lr)
        torch._foreach_add_(params, g)
    else:
        torch._foreach_mul_(g, lr)
        torch._foreach_sub_(momentum_bufs, g)
        torch._foreach_add_(params, momentum_bufs)


@dataclass
class MXNetSGD:
    """The optimizer of a train state: lr schedule, MXNet SGD/NAG and, with
    ``project``, the radial projection applied first."""

    schedule: Callable[[int], float]
    momentum: float = 0.9
    weight_decay: float = 1e-4
    nesterov: bool = False
    project: bool = False

    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                momentum_bufs: List[torch.Tensor], count: int) -> None:
        """Apply update number ``count`` (0-based) in place."""
        with torch.no_grad():
            if self.project:
                grads = radial_projection(grads, params)
            mxnet_sgd_(params, list(grads), momentum_bufs,
                       self.schedule(count), self.momentum,
                       self.weight_decay, self.nesterov)
