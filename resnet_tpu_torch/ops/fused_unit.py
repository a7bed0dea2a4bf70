"""Chained ops for fused bottleneck units, port of
``resnet_tpu/ops/fused_unit.py``.

Every 1x1 conv of the chain is one product that owns its input's
normalization (prologue) and its output's statistics (epilogue):

  op A  matmul_stats:            y = x @ W            (+ sum y, sum y^2)
  op B  norm_relu_matmul_stats:  y = relu(bn(x)) @ W  (+ sum y, sum y^2)

so each activation is written once and read once. The backward of each op
is ONE kernel launch that computes dx, dW, dgamma and dbeta from (gy, y, x):
the per-channel reductions ride in the epilogue of the dx product, and
``g = gy + gsum + 2*y*gsumsq`` (the statistics' cotangents folded in) is
formed in registers, never written to device memory.

``backend="pallas"`` selects the hand-written CUDA kernels (the name is the
JAX package's, kept so that one configuration means the same run in both):
forward ``csrc/matmul_stats.cu``, which replaces the TPU kernel
``resnet_tpu/ops/fused_unit.py::_fwd_kernel``, and backward
``csrc/matmul_stats_bwd.cu``, which replaces
``resnet_tpu/ops/fused_unit.py::_bwd_kernel``. The kernels' sources say what
bounds them on an H100 and what their design does about it. The CUDA
backward takes every shape: the TPU kernel's fit rule (its largest shape
went to plain products) has no counterpart here. ``backend="xla"`` runs the
same ops as separate PyTorch ops, with the statistics taken from the
rounded ``y`` as the JAX package's XLA backend takes them.

Launch counters: ``matmul_stats.launches`` and
``norm_relu_matmul_stats.launches`` (forward kernel, by op) and
``fused_backward.launches`` (backward kernel, both ops).
"""

from __future__ import annotations

import torch

from resnet_tpu_torch.ops import matmul_stats_cuda as _k

BACKENDS = ("pallas", "xla")


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")


def _rounded_stats(y, acc):
    yf = y.to(acc)
    return y, yf.sum(dim=0), (yf * yf).sum(dim=0)


def _forward(x, w, a, b, relu, backend, counter):
    if backend == "pallas":
        return _k.forward(x, w, a, b, relu, counter=counter)
    return _rounded_stats(_k.forward_plain(x, w, a, b, relu)[0],
                          _k.acc_dtype(x.dtype))


def fused_backward_plain(gy, gs, gss, y, x, w, consts=None,
                         relu: bool = False):
    """Plain PyTorch version of the backward kernel, and the backward of
    ``backend="xla"``: ``(dx, dw (K, N) float32, dgamma, dbeta)``, rounding
    where the kernel rounds (see ``matmul_stats_cuda.backward_plain``)."""
    return _k.backward_plain(gy, gs, gss, y, x, w, consts, relu)


def fused_backward(gy, gs, gss, y, x, w, consts=None, relu: bool = False):
    """The one-launch backward of both ops. ``consts`` is ``None`` (op A)
    or the float32 vectors ``(a, b, inv, -mean*inv)`` (op B). On a CUDA
    tensor it launches the kernels or raises; on a CPU tensor it runs the
    plain version. ``fused_backward.launches`` counts launches."""
    return _k.backward(gy, gs, gss, y, x, w, consts, relu,
                       counter=fused_backward)


fused_backward.launches = 0


def _backward(backend, gy, gs, gss, y, x, w, consts, relu):
    """Cotangents with ``None`` (an unused output) read as zeros."""
    acc = _k.acc_dtype(x.dtype)
    n = w.shape[1]
    if gy is None:
        gy = torch.zeros_like(y)
    gs = torch.zeros(n, dtype=acc, device=x.device) if gs is None else gs
    gss = torch.zeros(n, dtype=acc, device=x.device) if gss is None else gss
    fn = fused_backward if backend == "pallas" else fused_backward_plain
    return fn(gy.contiguous(), gs, gss, y, x, w, consts, relu)


# ---------------------------------------------------------------------------
# op A: matmul with stats epilogue (conv1 / shortcut of v1 units)
# ---------------------------------------------------------------------------

class _MatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, backend):
        out = _forward(x, w, None, None, False, backend, matmul_stats)
        ctx.save_for_backward(x, w, out[0])
        ctx.backend = backend
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, gy, gs, gss):
        x, w, y = ctx.saved_tensors
        dx, dw, _, _ = _backward(ctx.backend, gy, gs, gss, y, x, w, None,
                                 False)
        return dx, dw.to(w.dtype), None


def matmul_stats(x: torch.Tensor, w: torch.Tensor, backend: str = "pallas"):
    """``y = x @ w``; also the per-column sum and sum of squares of ``y``.
    ``x`` (M, K), ``w`` (K, N); differentiable in both through all three
    outputs."""
    _check_backend(backend)
    return _MatmulStats.apply(x, w, backend)


matmul_stats.launches = 0


# ---------------------------------------------------------------------------
# op B: normalize -> relu -> matmul with stats epilogue (conv3 of v1 units)
# ---------------------------------------------------------------------------

def _nrms_consts(mean, var, gamma, beta, eps, acc):
    inv = torch.rsqrt(var.to(acc) + eps)
    a = gamma.to(acc) * inv
    b = beta.to(acc) - mean.to(acc) * a
    return a, b, inv


class _NormReluMatmulStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mean, var, gamma, beta, eps, relu, backend):
        a, b, _ = _nrms_consts(mean, var, gamma, beta, eps,
                               _k.acc_dtype(x.dtype))
        out = _forward(x, w, a, b, relu, backend, norm_relu_matmul_stats)
        ctx.save_for_backward(x, w, mean, var, gamma, beta, out[0])
        ctx.eps, ctx.relu, ctx.backend = eps, relu, backend
        ctx.set_materialize_grads(False)
        return out

    @staticmethod
    def backward(ctx, gy, gs, gss):
        x, w, mean, var, gamma, beta, y = ctx.saved_tensors
        acc = _k.acc_dtype(x.dtype)
        a, b, inv = _nrms_consts(mean, var, gamma, beta, ctx.eps, acc)
        dx, dw, dgamma, dbeta = _backward(
            ctx.backend, gy, gs, gss, y, x, w,
            (a, b, inv, -mean.to(acc) * inv), ctx.relu)
        # the statistics' cotangents derive from dgamma/dbeta:
        #   dmean = -a * dbeta ;  dvar = -1/2 * a * inv * dgamma
        dmean = (-a * dbeta).to(mean.dtype)
        dvar = (-0.5 * a * inv * dgamma).to(var.dtype)
        return (dx, dw.to(w.dtype), dmean, dvar, dgamma.to(gamma.dtype),
                dbeta.to(beta.dtype), None, None, None)


def norm_relu_matmul_stats(x, w, mean, var, gamma, beta, eps: float = 2e-5,
                           relu: bool = True, backend: str = "pallas"):
    """``y = relu((x - mean) * gamma/sqrt(var+eps) + beta) @ w``, plus the
    column stats of ``y``: the chain link, which consumes the PREVIOUS
    conv's raw output and statistics and emits this conv's raw output and
    statistics. Differentiable in the first six arguments."""
    _check_backend(backend)
    return _NormReluMatmulStats.apply(x, w, mean, var, gamma, beta, eps,
                                      relu, backend)


norm_relu_matmul_stats.launches = 0


# ---------------------------------------------------------------------------
# references of the full op semantics in separate, differentiable PyTorch
# ops (oracle for the gradient tests)
# ---------------------------------------------------------------------------

def reference_matmul_stats(x, w):
    acc = _k.acc_dtype(x.dtype)
    y = (x.to(acc) @ w.to(acc)).to(x.dtype)
    return _rounded_stats(y, acc)


def reference_norm_relu_matmul_stats(x, w, mean, var, gamma, beta,
                                     eps: float = 2e-5, relu: bool = True):
    acc = _k.acc_dtype(x.dtype)
    inv = torch.rsqrt(var.to(acc) + eps)
    xh = (x.to(acc) - mean) * inv * gamma + beta
    if relu:
        xh = torch.relu(xh)
    y = (xh.to(x.dtype).to(acc) @ w.to(acc)).to(x.dtype)
    return _rounded_stats(y, acc)
