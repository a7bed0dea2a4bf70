"""Microbenchmark: the BatchNorm backward's sum pair per column,
``S1 = Σ gy`` and ``S2 = Σ gy·(x − mean)·inv``, as torch's eager
reductions (``torch_sums``) against the hand-written CUDA kernel
(``cuda_sums``, ``csrc/bn_sums.cu``, bound in ``ops/bn_ema.py``), on
ResNet-50's BN input shapes at batch 256. Port of ``tools/reduce_probe.py``.

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

from resnet_tpu_torch.ops.bn_ema import cuda_sums, sum_splits, torch_sums
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
# (M, C) -> the number of BatchNorms of that input shape in one train step
# of each model at batch 256 (53 each), the bn-ema kernels' shapes on the
# main path
STEP_SHAPES = {
    "resnet50": {(12544, 512): 5, (12544, 2048): 4, (50176, 256): 11,
                 (50176, 512): 1, (50176, 1024): 7, (200704, 128): 7,
                 (200704, 256): 1, (200704, 512): 5, (802816, 64): 6,
                 (802816, 128): 1, (802816, 256): 4, (3211264, 64): 1},
    "resnext50": {(12544, 1024): 5, (12544, 2048): 4, (50176, 512): 11,
                  (50176, 1024): 8, (200704, 256): 7, (200704, 512): 6,
                  (802816, 128): 6, (802816, 256): 5, (3211264, 64): 1},
}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, data sheet
# |kernel - plain| <= SUM_TOL * Σ|terms| per column: float32 sums of up to
# 802816 terms added in another order
SUM_TOL = 1e-5


def sum_bounds(gy, x, mean, inv) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-column tolerance of either sum: ``SUM_TOL`` times the sum of
    its terms' magnitudes (Σ|gy|, Σ|gy·xhat|)."""
    gy32 = gy.float()
    xhat = (x.float() - mean) * inv
    return (SUM_TOL * gy32.abs().sum(dim=0),
            SUM_TOL * (gy32 * xhat).abs().sum(dim=0))


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
