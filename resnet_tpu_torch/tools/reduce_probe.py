"""Microbenchmark: the BatchNorm backward's sum pair per column,
``S1 = Σ gy`` and ``S2 = Σ gy·(x − mean)·inv``, as torch's eager
reductions (``torch_sums``) against the hand-written CUDA kernel
(``cuda_sums``, ``csrc/bn_sums.cu``), on ResNet-50's BN input shapes at
batch 256. Port of ``tools/reduce_probe.py``.

    python -m resnet_tpu_torch.tools.reduce_probe [--iters 30] [--check]

It asks one question of the card: can a column reduction of these sums,
written by hand, read its inputs at the HBM rate where eager reductions do
not? Each line gives a shape, a route (``torch`` or ``cuda``), the median
of ``--iters`` CUDA-event timings, each with L2 flushed before it (the
card's 50 MB L2 would otherwise hold the smaller pairs whole), and the
rate at which the two inputs were read. ``--check`` holds the kernel
against ``torch_sums`` on the card at the reference's check shape and
prints ``parity ok``. Without a card it raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from resnet_tpu_torch.utils.device import resolve_device
from resnet_tpu_torch.utils.profiler import cuda_median_ms

# (M, C) pairs: every distinct R50 bottleneck BN-input shape at bs256
SHAPES = [
    (802816, 64),
    (802816, 256),
    (200704, 128),
    (200704, 512),
    (50176, 256),
    (50176, 1024),
    (12544, 512),
    (12544, 2048),
]
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, data sheet
# the kernel's geometry (csrc/bn_sums.cu): 256 threads a block, 8 columns a
# thread; the wrapper splits the rows so that about TARGET_BLOCKS blocks
# exist (4 for each of an H100's 132 SMs), each row lane walking at least
# MIN_ROWS_PER_LANE rows
BLOCK_THREADS, COLS = 256, 8
TARGET_BLOCKS, MIN_ROWS_PER_LANE = 528, 8
# |kernel - plain| <= SUM_TOL * Σ|terms| per column: float32 sums of up to
# 802816 terms added in another order
SUM_TOL = 1e-5
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def torch_sums(gy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
               inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel (the JAX tool's ``xla_sums``):
    float32 ``(Σ gy, Σ gy·xhat)`` over the rows, ``xhat = (x-mean)·inv``."""
    gy32 = gy.float()
    xhat = (x.float() - mean) * inv
    return gy32.sum(dim=0), (gy32 * xhat).sum(dim=0)


def sum_bounds(gy, x, mean, inv) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-column tolerance of either sum: ``SUM_TOL`` times the sum of
    its terms' magnitudes (Σ|gy|, Σ|gy·xhat|)."""
    gy32 = gy.float()
    xhat = (x.float() - mean) * inv
    return (SUM_TOL * gy32.abs().sum(dim=0),
            SUM_TOL * (gy32 * xhat).abs().sum(dim=0))


def sum_splits(m: int, c: int) -> Tuple[int, int]:
    """(splits, rows per split) of the kernel for an (M, C) input."""
    chunks = c // COLS
    row_threads = min(chunks, BLOCK_THREADS)
    lanes = BLOCK_THREADS // row_threads
    col_blocks = -(-chunks // row_threads)
    splits = max(1, min(-(-TARGET_BLOCKS // col_blocks),
                        -(-m // (lanes * MIN_ROWS_PER_LANE))))
    rows = -(-m // splits)
    return -(-m // rows), rows


def _check_args(gy, x, mean, inv) -> Tuple[int, int]:
    if gy.ndim != 2 or tuple(x.shape) != tuple(gy.shape):
        raise ValueError(f"gy and x must be one (M, C) shape, got "
                         f"{tuple(gy.shape)} and {tuple(x.shape)}")
    m, c = gy.shape
    if gy.dtype not in _DTYPE_CODES or x.dtype != gy.dtype:
        raise ValueError(f"the kernel takes bfloat16 or float32 gy and x of "
                         f"one dtype, got {gy.dtype} and {x.dtype}")
    if m < 1 or c < COLS or c % COLS:
        raise ValueError(f"the kernel needs C to be a multiple of {COLS} "
                         f"(16-byte chunks), got M={m} C={c}")
    for name, t in (("gy", gy), ("x", x)):
        if t.device != gy.device:
            raise ValueError(f"{name} is on {t.device}, expected {gy.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, v in (("mean", mean), ("inv", inv)):
        if v.dtype != torch.float32 or tuple(v.shape) != (c,):
            raise ValueError(f"{name} must be float32 ({c},), got "
                             f"{v.dtype} {tuple(v.shape)}")
        if v.device != gy.device or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {gy.device}")
    return m, c


def cuda_sums(gy: torch.Tensor, x: torch.Tensor, mean: torch.Tensor,
              inv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(S1, S2)``, two (C,) float32 vectors, by the K5 kernel; the
    counterpart of the JAX tool's ``pallas_sums``. gy, x (M, C) in bfloat16
    or float32; mean, inv (C,) float32.

    On CPU tensors it runs ``torch_sums``; on CUDA tensors it launches the
    kernel or raises (on a non-contiguous input, ``C % 8 != 0``, another
    dtype, or a failed launch). ``cuda_sums.launches`` counts launches.
    """
    if gy.device.type == "cpu":
        return torch_sums(gy, x, mean, inv)
    if gy.device.type != "cuda":
        raise ValueError(f"unsupported device {gy.device}")
    m, c = _check_args(gy, x, mean, inv)
    splits, rows = sum_splits(m, c)
    part = torch.empty((2, splits, c), dtype=torch.float32, device=gy.device)
    from resnet_tpu_torch._build import load_library
    lib = load_library("bn_sums")
    with torch.cuda.device(gy.device):
        err = lib.bn_sums_launch(
            gy.data_ptr(), x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
            part[0].data_ptr(), part[1].data_ptr(), m, c, splits, rows,
            _DTYPE_CODES[gy.dtype], torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"bn_sums kernel launch failed: CUDA error {err}")
    cuda_sums.launches += 1
    s1, s2 = part.sum(dim=1)          # the splits, added in a fixed order
    return s1, s2


cuda_sums.launches = 0


def probe(iters: int = 30, device=None) -> List[dict]:
    """Time both routes at every shape of ``SHAPES`` (bf16 gy and x from
    seed 0, mean 0, inv 1, as the JAX tool does); print one line per shape
    and route and return them as dicts."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("the probe times the card; it has no CPU mode")
    print(f"# {torch.cuda.get_device_name(dev)}, median of {iters} runs, "
          "L2 flushed before each", flush=True)
    gen = torch.Generator(device=dev).manual_seed(0)
    # reading 64 MiB evicts the 50 MB L2 with clean lines, so no write-back
    # of an earlier output lands in a timed run
    flush_buf = torch.ones(64 << 20, dtype=torch.uint8, device=dev)
    rows = []
    for m, c in SHAPES:
        gy = torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn((m, c), generator=gen, device=dev).to(torch.bfloat16)
        mean = torch.zeros((c,), dtype=torch.float32, device=dev)
        inv = torch.ones((c,), dtype=torch.float32, device=dev)
        moved = 2 * m * c * gy.element_size()     # both inputs, read once
        for name, fn in (("torch", torch_sums), ("cuda", cuda_sums)):
            fn(gy, x, mean, inv)                  # first call: build, warm
            ms = cuda_median_ms(lambda: fn(gy, x, mean, inv), runs=iters,
                                flush=flush_buf.sum)
            print(f"({m:7d},{c:5d}) {name:6s} {ms:7.3f} ms "
                  f"{moved / ms / 1e6:6.0f} GB/s", flush=True)
            rows.append(dict(shape=[m, c], route=name, ms=ms,
                             gb_per_s=moved / ms / 1e6,
                             bound_ms=moved / HBM_BYTES_PER_S * 1e3))
        del gy, x
    return rows


def check(device=None) -> None:
    """The kernel against ``torch_sums`` at the JAX tool's check shape
    (4096x128 bf16, random mean and inv in [0.5, 2], numpy seed 0), on the
    card; raises on a column out of tolerance, else prints ``parity ok``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    m, c = 4096, 128

    def tensor(a, dtype):
        return torch.from_numpy(a.astype(np.float32)).to(dtype).to(dev)
    gy = tensor(rng.normal(size=(m, c)), torch.bfloat16)
    x = tensor(rng.normal(size=(m, c)), torch.bfloat16)
    mean = tensor(rng.normal(size=(c,)), torch.float32)
    inv = tensor(rng.uniform(0.5, 2.0, (c,)), torch.float32)
    got = cuda_sums(gy, x, mean, inv)
    want = torch_sums(gy, x, mean, inv)
    for name, g, w, bound in zip(("S1", "S2"), got, want,
                                 sum_bounds(gy, x, mean, inv)):
        bad = int(((g - w).abs() > bound).sum())
        if bad:
            raise AssertionError(f"{name}: {bad} of {c} columns out of "
                                 f"tolerance")
    print("parity ok")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--check", action="store_true",
                   help="parity of the kernel with torch_sums on the card")
    args = p.parse_args(argv)
    if args.check:
        check()
    else:
        probe(args.iters)
    return 0


if __name__ == "__main__":
    sys.exit(main())
