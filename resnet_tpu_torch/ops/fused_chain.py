"""Normalize-input matmul with BN-statistics epilogue, port of
``resnet_tpu/ops/fused_chain.py``.

The chain's building block: consume the PREVIOUS conv's raw output and its
batch statistics, apply BN + ReLU on the way in, multiply, and emit the raw
output and ITS statistics in the same pass:

    y_raw = relu((x_raw - mean) * rsqrt(var + eps) * gamma + beta) @ W
    (+ per-column sum and sum of squares of y_raw)

``normalized_matmul_with_stats`` replaces the TPU kernel
``resnet_tpu/ops/fused_chain.py::_kernel`` with the hand-written CUDA
kernel ``csrc/matmul_stats.cu`` (prologue on); the kernel's source says
what bounds it on an H100 and what its design does about that. Forward
only, as in the JAX package, where no model path reaches it.
"""

from __future__ import annotations

import torch

from resnet_tpu_torch.ops import matmul_stats_cuda as _k


def _fold(mean, var, gamma, beta, eps):
    """The affine fold of BN: ``xn = x*a + b`` with
    ``a = gamma*rsqrt(var+eps)``, ``b = beta - mean*a``, float32."""
    a = (gamma * torch.rsqrt(var.float() + eps)).float()
    b = (beta - mean * a).float()
    return a, b


def normalized_matmul_with_stats_plain(x_raw, w, mean, var, gamma, beta,
                                       eps: float = 2e-5,
                                       relu: bool = True):
    """Plain PyTorch version of the kernel: the prologue in float32 rounded
    to ``x_raw``'s dtype, the float32-accumulated product, and the column
    sums taken from the float32 accumulator, as the kernel takes them."""
    a, b = _fold(mean, var, gamma, beta, eps)
    return _k.forward_plain(x_raw, w, a, b, relu)


def normalized_matmul_with_stats(x_raw, w, mean, var, gamma, beta,
                                 eps: float = 2e-5, relu: bool = True):
    """``y = relu(norm(x_raw)) @ w`` plus the column stats of ``y``, one
    pass. ``x_raw`` (M, K), ``w`` (K, N), the four vectors (K,).

    On a CUDA tensor it launches the kernel or raises; on a CPU tensor it
    runs the plain version. ``normalized_matmul_with_stats.launches``
    counts kernel launches.
    """
    a, b = _fold(mean, var, gamma, beta, eps)
    return _k.forward(x_raw, w, a, b, relu,
                      counter=normalized_matmul_with_stats)


normalized_matmul_with_stats.launches = 0


def reference_chain(x_raw, w, mean, var, gamma, beta, eps: float = 2e-5,
                    relu: bool = True):
    """The same chain in separate PyTorch ops (also the numeric oracle):
    statistics from the rounded ``y``."""
    a, b = _fold(mean, var, gamma, beta, eps)
    h = x_raw.float() * a + b
    if relu:
        h = torch.relu(h)
    y = (h.to(x_raw.dtype).float() @ w.float()).to(x_raw.dtype)
    yf = y.float()
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)
