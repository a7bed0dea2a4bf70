"""Fused 1x1-conv + BatchNorm-statistics op, port of
``resnet_tpu/ops/fused_convbn.py``.

A 1x1 convolution over NHWC activations is a matrix product (M = N*H*W
rows, K = Cin, N = Cout); the kernel computes it and the per-channel sum
and sum of squares of its output in the same pass, so the statistics sweep
over the conv output never happens. ``matmul_with_stats`` replaces the TPU
kernel ``resnet_tpu/ops/fused_convbn.py::_kernel`` with the hand-written
CUDA kernel ``csrc/matmul_stats.cu`` (prologue off); the kernel's source
says what bounds it on an H100 and what its design does about that. Its
plain PyTorch version is ``matmul_with_stats_plain``.

The backward of ``conv1x1_bn_stats`` is two plain matrix products with the
mean/var cotangents folded into ``gy``, outside any kernel, as in the JAX
package.
"""

from __future__ import annotations

import torch

from resnet_tpu_torch.ops import matmul_stats_cuda as _k


def matmul_with_stats_plain(x2d: torch.Tensor, w2d: torch.Tensor):
    """Plain PyTorch version of the kernel: the float32-accumulated
    product, stored in ``x2d``'s dtype, and its column sums taken from the
    float32 accumulator (not from the rounded ``y``), as the kernel takes
    them."""
    return _k.forward_plain(x2d, w2d)


def matmul_with_stats(x2d: torch.Tensor, w2d: torch.Tensor):
    """``y = x2d @ w2d`` plus per-column ``(sum, sumsq)`` of ``y``, in one
    pass. ``x2d`` (M, K) in the compute dtype, ``w2d`` (K, N); returns
    ``y`` (M, N) in ``x2d``'s dtype and two (N,) float32 vectors.

    On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
    runs the plain version. ``matmul_with_stats.launches`` counts kernel
    launches.
    """
    return _k.forward(x2d, w2d, counter=matmul_with_stats)


matmul_with_stats.launches = 0


class _Conv1x1BNStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w2d):
        y, s, ss = matmul_with_stats(x2d, w2d)
        m = x2d.shape[0]
        mean = s / m
        var = ss / m - mean * mean      # fast variance, not clamped at 0
        ctx.save_for_backward(x2d, w2d, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x2d, w2d, y, mean = ctx.saved_tensors
        m = x2d.shape[0]
        # mean = sum(y)/m ; var = sum(y^2)/m - mean^2
        # d/dy: gy + gmean/m + gvar*(2y/m - 2*mean/m)
        acc = mean.dtype
        gy_eff = gy.to(acc) if gy is not None else torch.zeros_like(y, dtype=acc)
        if gmean is not None:
            gy_eff = gy_eff + gmean / m
        if gvar is not None:
            gy_eff = gy_eff + (2.0 / m) * gvar * (y.to(acc) - mean)
        gy_eff = gy_eff.to(x2d.dtype)
        dx = gy_eff @ w2d.t()
        dw = x2d.t() @ gy_eff
        return dx.to(x2d.dtype), dw.to(w2d.dtype)


def conv1x1_bn_stats(x2d: torch.Tensor, w2d: torch.Tensor):
    """Fused matmul + batch statistics: ``(y, mean, biased var over rows)``
    with ``var = E[y^2] - mean^2``, differentiable in ``x2d`` and ``w2d``
    through all three outputs."""
    return _Conv1x1BNStats.apply(x2d, w2d)


def reference_conv1x1_bn_stats(x2d: torch.Tensor, w2d: torch.Tensor):
    """Unfused reference for tests: plain product, mean and variance."""
    acc = _k.acc_dtype(x2d.dtype)
    y = x2d.to(acc) @ w2d.to(acc)
    mean = y.mean(dim=0)
    var = (y * y).mean(dim=0) - mean * mean
    return y.to(x2d.dtype), mean, var
