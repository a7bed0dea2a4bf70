"""Fused 1x1-conv + BN execution path for residual units, port of
``resnet_tpu/models/fused.py``.

A drop-in alternative execution of the ``Conv(1x1) -> BatchNorm`` pairs
inside bottleneck units in train mode, backed by the matmul+stats kernel
(``ops/fused_convbn.py``). It reads the same ``Conv`` and ``BatchNorm``
modules' parameters and refreshes the same running statistics, so the
parameter tree, ``state_dict()`` and the weight bridge do not change and
the switch is purely one of execution path. Eval takes the standard path.
"""

from __future__ import annotations

import torch

from resnet_tpu_torch.ops.fused_convbn import conv1x1_bn_stats


def rows_of(x: torch.Tensor) -> torch.Tensor:
    """NCHW tensor -> its (N*H*W, C) rows: a view for ``channels_last``
    memory, one copy otherwise (a strided subsample)."""
    n, c, h, w = x.shape
    return x.permute(0, 2, 3, 1).reshape(n * h * w, c).contiguous()


def image_of(rows: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(N*H*W, C) rows -> NCHW view in ``channels_last`` memory."""
    return rows.reshape(n, h, w, rows.shape[1]).permute(0, 3, 1, 2)


def weight_2d(conv, dtype) -> torch.Tensor:
    """A 1x1 conv's OIHW weight as the ops' ``w`` (K, N) in the compute
    dtype: the transposed view of the (N, K) matrix, which is the layout
    the kernels read in place."""
    return conv.weight[:, :, 0, 0].to(dtype).t()


def fused_conv_bn(x: torch.Tensor, conv, bn, relu: bool) -> torch.Tensor:
    """1x1 ``conv`` + ``bn`` (+ReLU) on NCHW ``x`` in train mode, the
    batch statistics fused into the conv's product. A strided 1x1 conv is
    a spatial subsample followed by the same product. Refreshes ``bn``'s
    running statistics."""
    if conv.stride != 1:
        x = x[:, :, ::conv.stride, ::conv.stride]
    n, _, h, w = x.shape
    y2d, mean, var = conv1x1_bn_stats(rows_of(x).to(bn.dtype),
                                      weight_2d(conv, bn.dtype))
    bn._refresh(mean.detach(), var.detach())
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    out = ((y2d.float() - mean) * inv + bn.bias).to(bn.dtype)
    out = image_of(out, n, h, w)
    return torch.relu(out) if relu else out
