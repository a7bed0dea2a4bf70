"""Stem max-pool (ref:symbol/resnet.py ``Pooling(kernel=(3,3),
stride=(2,2), pool_type='max')``), port of ``resnet_tpu/ops/pool.py``.

Two backward passes, chosen by ``grad_mode``:

- ``sas`` (the default): each window's whole cotangent goes to its first
  maximum in scan order, as the JAX package's ``select_and_scatter`` does
  (pinned on post-ReLU ties by the port's tests).
- ``mask``: each window's cotangent is split evenly among the input
  positions that equal its maximum (``dy / tie_count``, a valid
  subgradient), written as 9 strided views of the padded input aligned to
  the output grid. For windows with a unique maximum the two agree
  bitwise; after a ReLU, all-negative windows tie at 0 and the two differ.

Only the (3,3)/(2,2)/pad-1 geometry the model family uses is supported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pool(x):
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)


def _views(xp, h_out, w_out):
    """The 9 strided views of the padded input aligned to the output grid,
    with their offsets."""
    for di in range(3):
        for dj in range(3):
            yield (di, dj), xp[:, :, di:di + 2 * h_out - 1:2,
                               dj:dj + 2 * w_out - 1:2]


class MaxPoolMask(torch.autograd.Function):
    """3x3 stride-2 pad-1 max pool over NCHW whose backward splits each
    window's cotangent evenly among its ties (``max_pool_mask``)."""

    @staticmethod
    def forward(ctx, x):
        y = _pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        h, w = x.shape[2:]
        h_out, w_out = y.shape[2:]
        xp = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
        ties = torch.zeros(y.shape, dtype=torch.float32, device=y.device)
        for _, view in _views(xp, h_out, w_out):
            ties += (view == y).float()
        share = (dy.float() / ties).to(dy.dtype)
        dxp = torch.zeros(xp.shape, dtype=dy.dtype, device=dy.device)
        zero = torch.zeros((), dtype=dy.dtype, device=dy.device)
        for (di, dj), view in _views(xp, h_out, w_out):
            dxp[:, :, di:di + 2 * h_out - 1:2, dj:dj + 2 * w_out - 1:2] += \
                torch.where(view == y, share, zero)
        return dxp[:, :, 1:h + 1, 1:w + 1]


def max_pool_mask(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool; backward = even split among ties."""
    return MaxPoolMask.apply(x)


def stem_max_pool(x: torch.Tensor, grad_mode: str = "sas") -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool over an NCHW (channels_last) tensor;
    ``grad_mode`` picks the backward (module docstring)."""
    if grad_mode == "mask":
        return max_pool_mask(x)
    if grad_mode != "sas":
        raise ValueError(f"unknown pool grad_mode: {grad_mode!r}")
    return _pool(x)
