"""The bn-ema BatchNorm's training step as hand-written CUDA kernels
(``csrc/bn_sums.cu``), their binding and their plain versions.

A train-mode bn-ema BatchNorm (``models/resnet.py::BatchNorm``, ``ema``)
over an (M, C) matrix ``x``, the rows of a channels-last activation (the
wrappers take the NCHW tensor itself, whose memory is that matrix):

  - forward: the column sums of x and x² (``stats``), then per channel
    (``finalize``) the batch mean and variance, the ``ema_clamp`` clip of
    the running statistics around them, the running statistics refreshed
    in place, and the vectors ``mean`` (the clipped running mean's value),
    ``inv = rsqrt(var + eps)`` and ``a = weight·inv``; then
    ``y = (x - mean)·a + bias`` (``apply``);
  - backward: K5's sums ``S1 = Σgy``, ``S2 = Σgy·(x - mean)·inv``
    (``cuda_sums``) give ``dbias = S1`` and ``dweight = S2``, and
    ``dx = (gy - S1/M)·a`` (``dx``): the live mean carries the gradient,
    the variance and the clipped running mean are constants.

``bn_ema_forward`` and ``bn_ema_backward`` run each direction through one
launch function (three kernels); ``BatchNormEmaTrain`` is the autograd
function over them. Each wrapper takes the plain PyTorch versions for
tensors on the CPU and launches the kernels for tensors on the card, or
raises: no path falls back. The plain versions round where the kernels
round; only the order of the float32 sums differs (and, on the card, a
division by a Python number, which PyTorch computes as a product with its
reciprocal). Each wrapper counts its calls (``.launches``) and reports
them to the active ``utils/op_count.OpCounter``, with the bytes of their
bound.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from resnet_tpu_torch.utils.op_count import report_kernel

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# the row kernels' geometry (csrc/bn_sums.cu): 256 threads a block, 8
# columns a thread; the rows are split so that about TARGET_BLOCKS blocks
# exist (4 for each of an H100's 132 SMs), each row lane walking at least
# MIN_ROWS_PER_LANE rows
BLOCK_THREADS, COLS = 256, 8
TARGET_BLOCKS, MIN_ROWS_PER_LANE = 528, 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _channel_count(t: torch.Tensor) -> int:
    """C of an (M, C) matrix or an NCHW tensor."""
    return t.shape[-1 if t.ndim == 2 else 1]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """An (M, C) matrix as it is; an NCHW tensor as its (N·H·W, C) rows."""
    return t if t.ndim == 2 else t.permute(0, 2, 3, 1).reshape(-1, t.shape[1])


def _channels(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (C,) vector shaped to broadcast over ``like``'s channel axis."""
    return v if like.ndim == 2 else v[:, None, None]


def torch_sums(gy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
               inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5 (the JAX tool's ``xla_sums``): float32
    ``(Σ gy, Σ gy·xhat)`` over the rows, ``xhat = (x-mean)·inv``."""
    gy32 = _rows(gy).float()
    xhat = (_rows(x).float() - mean) * inv
    return gy32.sum(dim=0), (gy32 * xhat).sum(dim=0)


def stats_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the statistics kernel: float32 ``(Σ x, Σ x²)`` over
    the rows."""
    xf = _rows(x).float()
    return xf.sum(dim=0), (xf * xf).sum(dim=0)


def finalize_plain(s1, s2, count: int, running_mean, running_var, weight,
                   eps: float, momentum: float, clamp: float
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the finalize kernel: from the column sums ``s1``,
    ``s2`` of ``count`` rows, refresh ``running_mean`` and ``running_var``
    in place and return ``(mean, inv, a)``, each (C,) float32. The
    arithmetic is the eager bn-ema branch's, operation for operation."""
    bmean = s1 / count
    bvar = (s2 / count - bmean * bmean).clamp_min(0.0)
    mean, var = running_mean.clone(), running_var.clone()
    if clamp > 0:
        c2 = clamp * clamp
        var = torch.minimum(torch.maximum(var, bvar / c2), bvar * c2 + eps)
        sd = torch.sqrt(bvar + eps) * (clamp - 1.0)
        mean = torch.minimum(torch.maximum(mean, bmean - sd), bmean + sd)
    running_mean.copy_(momentum * running_mean + (1 - momentum) * bmean)
    running_var.copy_(momentum * running_var + (1 - momentum) * bvar)
    inv = 1.0 / torch.sqrt(var + eps)
    return (bmean + (mean - bmean), inv,
            inv if weight is None else inv * weight)


def apply_plain(x, mean, a, bias) -> torch.Tensor:
    """Plain version of the apply kernel: ``(x - mean)·a + bias`` in
    float32, rounded to ``x``'s dtype, in ``x``'s layout."""
    return ((x.float() - _channels(mean, x)) * _channels(a, x)
            + _channels(bias, x)).to(x.dtype)


def dx_plain(gy, s1, a) -> torch.Tensor:
    """Plain version of the dx kernel: ``(gy - s1/M)·a`` in float32 over
    ``gy``'s M rows, rounded to ``gy``'s dtype, in ``gy``'s layout."""
    m = gy.numel() // _channel_count(gy)
    return ((gy.float() - _channels(s1 / m, gy)) * _channels(a, gy)
            ).to(gy.dtype)


# ---------------------------------------------------------------------------
# the kernels' binding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sum_splits(m: int, c: int) -> Tuple[int, int]:
    """(splits, rows per split) of the row kernels for an (M, C) input."""
    chunks = c // COLS
    row_threads = min(chunks, BLOCK_THREADS)
    lanes = BLOCK_THREADS // row_threads
    col_blocks = -(-chunks // row_threads)
    splits = max(1, min(-(-TARGET_BLOCKS // col_blocks),
                        -(-m // (lanes * MIN_ROWS_PER_LANE))))
    rows = -(-m // splits)
    return -(-m // rows), rows


def _matrix(name: str, t: torch.Tensor, like: torch.Tensor
            ) -> Tuple[int, int]:
    """(M, C) of ``t``, whose memory the kernels read as an (M, C) row-major
    matrix: a contiguous (M, C) tensor or a channels-last NCHW one of
    ``like``'s shape, dtype and device. Raises on anything else."""
    if t.ndim == 2 and t.is_contiguous():
        m, c = t.shape
    elif t.ndim == 4 and t.is_contiguous(memory_format=torch.channels_last):
        n, c, h, w = t.shape
        m = n * h * w
    else:
        raise ValueError(f"{name} must be a contiguous (M, C) matrix or a "
                         f"channels-last NCHW tensor, got {tuple(t.shape)}")
    if t.shape != like.shape:
        raise ValueError(f"{name} must have the shape {tuple(like.shape)}, "
                         f"got {tuple(t.shape)}")
    if t.dtype not in _DTYPE_CODES or t.dtype != like.dtype:
        raise ValueError(f"the kernels take bfloat16 or float32 tensors of "
                         f"one dtype, got {name} {t.dtype}")
    if m < 1 or c < COLS or c % COLS:
        raise ValueError(f"the kernels need C to be a multiple of {COLS} "
                         f"(16-byte chunks), got M={m} C={c}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return m, c


def _check_vector(name: str, v: torch.Tensor, c: int, device) -> None:
    if v.dtype != torch.float32 or tuple(v.shape) != (c,):
        raise ValueError(f"{name} must be float32 ({c},), got {v.dtype} "
                         f"{tuple(v.shape)}")
    if v.device != device or not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _on_card(t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain versions), True for a CUDA one;
    raises on any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def _launch(fn: str, device: torch.device, *args) -> None:
    """Call ``libbn_sums``'s launch function ``fn`` on the current stream of
    ``device``; raises on an error it returns. (Device and stream are named
    by index: PyTorch resolves an index at a fraction of the host time it
    takes for a device object, and this runs twice a BatchNorm a step.)"""
    from resnet_tpu_torch._build import load_library
    lib = load_library("bn_sums")
    index = device.index
    with torch.cuda.device(index):
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        why = ("an argument the kernel does not take" if err == -1
               else f"CUDA error {err}")
        raise RuntimeError(f"{fn} failed: {why}")


def _count(wrapper, nbytes: int) -> None:
    """One call of ``wrapper``: its launch count, and the bytes its kernels
    must move to the active op counter."""
    wrapper.launches += 1
    report_kernel(wrapper.__name__, 0, nbytes)


def _backward_launch(gy, x, mean_ptr: int, inv_ptr: int,
                     a_ptr: Optional[int]):
    """K5 and the reduce, and dx unless ``a_ptr`` is None, on (M, C)
    tensors gy and x: (dx or None, S1, S2)."""
    m, c = _matrix("gy", gy, gy)
    _matrix("x", x, gy)
    splits, rows = sum_splits(m, c)
    part = torch.empty((2 * splits + 2) * c, dtype=torch.float32,
                       device=gy.device)
    sums = part[2 * splits * c:]
    dx = None if a_ptr is None else torch.empty_like(gy)
    _launch("bn_sums_launch", gy.device, gy.data_ptr(), x.data_ptr(),
            mean_ptr, inv_ptr, a_ptr, part.data_ptr(), sums.data_ptr(),
            None if dx is None else dx.data_ptr(), m, c, splits, rows,
            _DTYPE_CODES[gy.dtype])
    return dx, sums[:c], sums[c:]


def cuda_sums(gy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
              inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S1, S2)``, two (C,) float32 vectors, by the K5 kernel and the
    reduce kernel, which adds its split partials in a fixed order; the
    counterpart of the JAX tool's ``pallas_sums``. gy, x (M, C) (or NCHW
    channels-last) in bfloat16 or float32; mean, inv (C,) float32.

    On CPU tensors it runs ``torch_sums``; on CUDA tensors it launches the
    kernels or raises (on a non-contiguous input, ``C % 8 != 0``, another
    dtype, or a failed launch). ``cuda_sums.launches`` counts launches.
    """
    if not _on_card(gy):
        return torch_sums(gy, x, mean, inv)
    c = _channel_count(gy)
    _check_vector("mean", mean, c, gy.device)
    _check_vector("inv", inv, c, gy.device)
    _, s1, s2 = _backward_launch(gy, x, mean.data_ptr(), inv.data_ptr(),
                                 None)
    _count(cuda_sums, 2 * gy.numel() * gy.element_size())
    return s1, s2


cuda_sums.launches = 0


def bn_ema_forward(x: torch.Tensor, weight: Optional[torch.Tensor],
                   bias: torch.Tensor, running_mean: torch.Tensor,
                   running_var: torch.Tensor, eps: float, momentum: float,
                   clamp: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward of a train-mode bn-ema BatchNorm over ``x``, an (M, C)
    matrix or an NCHW channels-last tensor in bfloat16 or float32:
    ``(y, vectors)``, y like x and vectors (3, C) float32, the rows
    ``mean``, ``inv``, ``a``; ``running_mean`` and ``running_var`` are
    refreshed in place. On the card one launch function runs the
    statistics, finalize and apply kernels (``bn_ema_forward.launches``
    counts its calls); on the CPU, their plain versions."""
    if not _on_card(x):
        vectors = torch.stack(finalize_plain(
            *stats_plain(x), x.numel() // _channel_count(x),
            running_mean, running_var, weight, eps, momentum, clamp))
        return apply_plain(x, vectors[0], vectors[2], bias), vectors
    m, c = _matrix("x", x, x)
    for name, v in (("running_mean", running_mean),
                    ("running_var", running_var), ("bias", bias)) + (
                        () if weight is None else (("weight", weight),)):
        _check_vector(name, v, c, x.device)
    splits, rows = sum_splits(m, c)
    buf = torch.empty((2 * splits + 3) * c, dtype=torch.float32,
                      device=x.device)
    vectors = buf[2 * splits * c:].view(3, c)
    y = torch.empty_like(x)
    _launch("bn_sums_forward_launch", x.device, x.data_ptr(),
            buf.data_ptr(), running_mean.data_ptr(), running_var.data_ptr(),
            None if weight is None else weight.data_ptr(), bias.data_ptr(),
            vectors.data_ptr(), y.data_ptr(), m, c, splits, rows,
            _DTYPE_CODES[x.dtype], eps, momentum, 1 - momentum, clamp,
            clamp * clamp, clamp - 1.0)
    # statistics: x; apply: x and y (the finalize's few vectors aside)
    _count(bn_ema_forward, 3 * x.numel() * x.element_size())
    return y, vectors


bn_ema_forward.launches = 0


def bn_ema_backward(gy: torch.Tensor, x: torch.Tensor,
                    vectors: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``bn_ema_forward`` for the output gradient ``gy``
    (x's shape, dtype and layout): ``(dx, dbias, dweight)`` = ``((gy -
    S1/M)·a, S1, S2)`` from K5's sums ``S1 = Σgy``, ``S2 = Σgy·(x -
    mean)·inv``. On the card one launch function runs K5, the reduce and
    the dx kernels (``bn_ema_backward.launches`` counts its calls); on the
    CPU, their plain versions."""
    if not _on_card(gy):
        mean, inv, a = vectors
        s1, s2 = torch_sums(gy, x, mean, inv)
        return dx_plain(gy, s1, a), s1, s2
    c = _channel_count(gy)
    if (vectors.shape != (3, c) or vectors.dtype != torch.float32
            or not vectors.is_contiguous() or vectors.device != gy.device):
        raise ValueError(f"vectors must be float32 (3, {c}) contiguous on "
                         f"{gy.device}, got {vectors.dtype} "
                         f"{tuple(vectors.shape)}")
    ptr = vectors.data_ptr()
    dx, s1, s2 = _backward_launch(gy, x, ptr, ptr + 4 * c, ptr + 8 * c)
    # K5: gy and x; dx: gy and dx
    _count(bn_ema_backward, 4 * gy.numel() * gy.element_size())
    return dx, s1, s2


bn_ema_backward.launches = 0


# ---------------------------------------------------------------------------
# the autograd function
# ---------------------------------------------------------------------------

class BatchNormEmaTrain(torch.autograd.Function):
    """``y = (x - mean)·a + bias`` of a train-mode bn-ema BatchNorm over
    ``x`` (an NCHW channels-last tensor, or an (M, C) matrix), with its
    running statistics refreshed in place: the kernels on a CUDA ``x``,
    their plain versions on a CPU one. It saves ``x`` as it came and the
    (3, C) vectors for the backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, weight: Optional[torch.Tensor],
                bias: torch.Tensor, running_mean: torch.Tensor,
                running_var: torch.Tensor, eps: float, momentum: float,
                clamp: float) -> torch.Tensor:
        y, vectors = bn_ema_forward(x, weight, bias, running_mean,
                                    running_var, eps, momentum, clamp)
        ctx.save_for_backward(x, vectors)
        ctx.has_weight = weight is not None
        return y

    @staticmethod
    def backward(ctx, gy: torch.Tensor):
        x, vectors = ctx.saved_tensors
        gy = gy.contiguous(memory_format=torch.channels_last
                           if gy.ndim == 4 else torch.contiguous_format)
        dx, dbias, dweight = bn_ema_backward(gy, x, vectors)
        return (dx if ctx.needs_input_grad[0] else None,
                dweight if ctx.has_weight else None, dbias,
                None, None, None, None, None)
