"""The matmul-with-statistics kernels' binding and their plain versions.

``csrc/matmul_stats.cu`` and ``csrc/matmul_stats_bwd.cu`` compute one
family of functions, a 1x1 convolution as the product ``(M, K) @ (K, N)``
with BatchNorm work in its prologue and epilogue, forward and backward.
The JAX package wrote it three times forward (``ops/fused_convbn.py``,
``ops/fused_chain.py``, ``ops/fused_unit.py``) and once backward
(``ops/fused_unit.py``); the port's three modules of those names share this
one binding. Each of their public wrappers passes itself as ``counter``
and so counts its own launches.

``forward`` and ``backward`` take the plain PyTorch version for tensors on
the CPU and launch the CUDA kernel for tensors on the card, or raise: no
path falls back. The plain versions follow the kernels, rounding where they
round: in particular the column statistics come from the float32
accumulator, not from the ``y`` that is stored in ``x``'s dtype.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from resnet_tpu_torch.utils.op_count import report_kernel

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
BLOCK_ROWS = 128       # rows of y or dx, and of one partial sum, a block
TILE_WIDTHS = (256, 128, 64)   # output tile widths of the bf16 kernels
DW_TILE_ROWS = 128     # rows (along N) of a bf16 dW^T tile
DW_ROW_STEP = 64       # rows a dW stage holds: a split's row multiple
H100_SMS = 132
MAX_GRID_Y = 65535     # the float32 kernels' grid: one block row per 128 rows
TMA_ALIGN = 16         # bytes: TMA's base address and row pitch multiple
# the bf16 kernels' shared memory, as csrc/matmul_stats*.cu lay it out
SMEM_LIMIT = 232448    # bytes a block may use on an H100
# ring stages of each kernel, by tile width
STAGES = {"forward": {64: 5, 128: 5, 256: 3}, "dx": {64: 3, 128: 3, 256: 3},
          "dw": {64: 4, 128: 4, 256: 3}}
CONSUMER_WARPS = 8     # two consumer warpgroups
BOX_BYTES = 64 * 64 * 2   # one 64 x 64 bf16 TMA box
ATOM_BYTES = 1024      # the swizzle atom: the ring's alignment
_LAUNCH_ERRORS = {-1: "an argument the kernel does not take",
                  -2: "the driver has no cuTensorMapEncodeTiled",
                  -3: "the driver refused a tensor map"}


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """float32 accumulation; float64 for the CPU tests' float64 inputs."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def activation(x, a, b, relu):
    """The prologue: ``[relu](x*a + b)`` in the accumulation dtype, rounded
    to ``x``'s dtype; ``x`` itself without ``a``."""
    if a is None:
        return x
    xh = x.to(a.dtype) * a + b
    if relu:
        xh = torch.relu(xh)
    return xh.to(x.dtype)


def forward_plain(x: torch.Tensor, w: torch.Tensor,
                  a: Optional[torch.Tensor] = None,
                  b: Optional[torch.Tensor] = None, relu: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``y = act @ w`` accumulated in
    float32 and stored in ``x``'s dtype, and the column sums of ``y`` and
    ``y*y`` taken from the accumulator before that rounding."""
    acc = acc_dtype(x.dtype)
    yf = activation(x, a, b, relu).to(acc) @ w.to(acc)
    return yf.to(x.dtype), yf.sum(dim=0), (yf * yf).sum(dim=0)


def folded_cotangent(gy, gs, gss, y):
    """``g = gy + gs + 2*y*gss``: the two sums' cotangents folded into
    ``gy``, from the saved (rounded) ``y``, rounded to ``y``'s dtype."""
    acc = acc_dtype(y.dtype)
    return (gy.to(acc) + gs + 2.0 * y.to(acc) * gss).to(y.dtype)


def backward_plain(gy, gs, gss, y, x, w, consts=None, relu: bool = False):
    """Plain version of the backward kernel. ``consts`` is ``None`` (no
    prologue) or the float32 vectors ``(a, b, inv, minv)``. Returns
    ``(dx, dw, dgamma, dbeta)``: ``dx`` in ``x``'s dtype, ``dw`` (K, N) in
    the accumulation dtype, the last two ``None`` without ``consts``.

    Rounds where the kernel rounds: ``g`` (from the saved, rounded ``y``)
    and ``act`` go to ``x``'s dtype before the products; the ReLU mask
    tests ``x*a + b > 0`` before any rounding.
    """
    acc = acc_dtype(x.dtype)
    g = folded_cotangent(gy, gs, gss, y).to(acc)
    gact = g @ w.to(acc).t()
    if consts is None:
        return gact.to(x.dtype), x.to(acc).t() @ g, None, None
    a, b, inv, minv = consts
    xf = x.to(acc)
    gxh = gact
    if relu:
        gxh = torch.where(xf * a + b > 0, gact, torch.zeros_like(gact))
    xhat = xf * inv + minv
    return ((gxh * a).to(x.dtype), activation(x, a, b, relu).to(acc).t() @ g,
            (gxh * xhat).sum(dim=0), gxh.sum(dim=0))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def tma_misalignment(data_ptr: int, strides, itemsize: int
                     ) -> Optional[str]:
    """Why TMA cannot read a matrix at ``data_ptr`` with element
    ``strides`` (outermost first) of ``itemsize`` bytes, or None if it
    can: the base address and every stride but the innermost, in bytes,
    must be multiples of 16, and the innermost stride 1. The kernels load
    every bf16 operand through TMA tensor maps; the wrapper refuses what
    the maps would refuse rather than copy it."""
    if data_ptr % TMA_ALIGN:
        return f"must start on a {TMA_ALIGN}-byte boundary (at {data_ptr})"
    if strides and strides[-1] != 1:
        return f"must have unit column stride, got strides {tuple(strides)}"
    for st in strides[:-1]:
        if st * itemsize % TMA_ALIGN:
            return (f"must have row strides of a multiple of {TMA_ALIGN} "
                    f"bytes, got {st * itemsize}")
    return None


def _check_matrix(name, t, shape, dtype, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    why = tma_misalignment(t.data_ptr(), t.stride(), t.element_size())
    if why is not None:
        raise ValueError(f"{name} {why}")


def _check_problem(x, w):
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"the kernel takes bfloat16 and float32, got "
                         f"{x.dtype}")
    m, k = x.shape
    n = w.shape[1]
    if m < 1 or k % 8 or n % 8:
        raise ValueError(f"the kernel needs K and N to be multiples of 8 "
                         f"(16-byte chunks), got M={m} K={k} N={n}")
    if m > MAX_GRID_Y * BLOCK_ROWS:
        raise ValueError(f"at most {MAX_GRID_Y * BLOCK_ROWS} rows per "
                         f"launch, got {m}")
    _check_matrix("x", x, (m, k), x.dtype, x.device)
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"w must be {x.dtype} on {x.device}, got "
                         f"{w.dtype} on {w.device}")
    return m, k, n


def _weight_rows(w: torch.Tensor) -> torch.Tensor:
    """``w`` (K, N) as the kernels read it: Wt (N, K) row-major, the layout
    of a 1x1 conv's OIHW weight. A view when ``w`` is the transpose of such
    a weight; otherwise one small copy."""
    wt = w.t()
    if not wt.is_contiguous() or tma_misalignment(
            wt.data_ptr(), wt.stride(), wt.element_size()) is not None:
        wt = wt.clone(memory_format=torch.contiguous_format)
    return wt


def _vector(name, v, size, device):
    v = v.detach()
    if v.dtype != torch.float32 or tuple(v.shape) != (size,):
        raise ValueError(f"{name} must be float32 ({size},), got "
                         f"{v.dtype} {tuple(v.shape)}")
    if v.device != device:
        raise ValueError(f"{name} is on {v.device}, expected {device}")
    v = v.contiguous()
    return v if v.data_ptr() % 16 == 0 else v.clone()   # 16-byte copies


def forward_cost(m: int, k: int, n: int, itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bound bytes) of one forward launch: the product's
    ``2·M·K·N``; read x and W, write y and the two (N,) float32 sums."""
    return 2 * m * k * n, (m * k + k * n + m * n) * itemsize + 2 * n * 4


def backward_cost(m: int, k: int, n: int, itemsize: int) -> Tuple[int, int]:
    """(FLOPs, bound bytes) of one backward launch: two products; read
    gy, y, x and W, write dx and the float32 dW."""
    return (2 * 2 * m * k * n,
            (2 * m * n + 2 * m * k + k * n) * itemsize + k * n * 4)


def report_launch(counter, cost: Tuple[int, int]) -> None:
    """One launch of ``counter``'s kernel: its launch count, and its
    FLOPs and bytes to the active ``utils/op_count.OpCounter``."""
    counter.launches += 1
    report_kernel(counter.__name__, *cost)


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        why = _LAUNCH_ERRORS.get(err, f"CUDA error {err}")
        raise RuntimeError(f"{what} kernel launch failed: {why}")


def forward(x, w, a=None, b=None, relu: bool = False, *, counter):
    """``(y, sum, sumsq)`` of the forward function. ``a`` and ``b`` (K,)
    float32 switch the prologue on. Adds one to ``counter.launches`` where
    it launches the kernel, and reports the launch to the active op counter
    (``report_launch``)."""
    if x.device.type == "cpu":
        return forward_plain(x, w, a, b, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m, k, n = _check_problem(x, w)
    wt = _weight_rows(w)
    normalize = a is not None
    if normalize:
        a = _vector("a", a, k, x.device)
        b = _vector("b", b, k, x.device)
    from resnet_tpu_torch._build import load_library
    lib = load_library("matmul_stats")
    grid_m = -(-m // BLOCK_ROWS)
    width, grid = forward_plan(m, k, n, _sm_count(x.device))
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    # (sum, sumsq) partials, each (N, ceil(M/128)): one row per column, so
    # that one reduction along contiguous rows adds them in a fixed order
    stats = torch.empty((2, n, grid_m), dtype=torch.float32, device=x.device)
    psum, psumsq = stats[0], stats[1]
    with torch.cuda.device(x.device):
        err = lib.matmul_stats_launch(
            x.data_ptr(), wt.data_ptr(),
            a.data_ptr() if normalize else None,
            b.data_ptr() if normalize else None,
            y.data_ptr(), psum.data_ptr(), psumsq.data_ptr(), m, k, n,
            _DTYPE_CODES[x.dtype], int(normalize), int(relu), width, grid,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "matmul_stats")
    report_launch(counter, forward_cost(m, k, n, x.element_size()))
    total, total_sq = stats.sum(dim=2)
    return y, total, total_sq


def _wave_fill(items: int, sms: int) -> float:
    """Share of the block slots that ``items`` equal work items fill over
    the waves of a grid of ``sms`` persistent blocks (one an SM)."""
    return items / (-(-items // sms) * sms)


def tile_widths(k: int, n: int, normalize: bool = False
                ) -> Tuple[int, int, int]:
    """Output tile widths (forward along N, dx along K, dW^T along K) of
    the bf16 kernels for a (M, K) @ (K, N) product: 64 where the output is
    at most 64 wide; 256, whose 64-deep stages carry 1.5 times the
    operations of a 128-wide tile's for each byte read from L2, where it
    measured faster on one H100 (every ResNet-50 shape at both widths):
    the forward where N >= 256 and K <= 512 (at K
    >= 1024 its 3-stage ring lost to the 5-stage ring of 128-wide tiles,
    e.g. 25088x1024x256 0.060 against 0.044 ms), dx where K >= 512 without
    the prologue (with it, x's tile for the epilogue takes the room of the
    wider ring), dW where K >= 256; else 128."""
    forward = 64 if n <= 64 else 256 if n >= 256 and k <= 512 else 128
    dx = 64 if k <= 64 else 256 if k >= 512 and not normalize else 128
    dw = 64 if k <= 64 else 256 if k >= 256 else 128
    return forward, dx, dw


def smem_bytes(kernel: str, width: int, normalize: bool = False) -> int:
    """Dynamic shared memory of one block of a bf16 kernel ("forward",
    "dx" or "dw") with output tiles ``width`` wide, as the kernel lays it
    out: the 1024-byte alignment slack, the ring of stages of 64 x 64
    boxes, then (forward, dx) the staging of one TMA store pass of 128
    rows (forward: up to 128 columns; dx: the tile, a quarter of the
    256-wide one) and each consumer warp's column partials, then (dx with
    the prologue) the tile's x and its columns' four BatchNorm constants,
    then the stages' barriers."""
    operand = 64 * width * 2                  # a 64-deep operand of the tile
    boxes = {"forward": 2, "dx": 4, "dw": 4}  # x; gy, y (128 rows or cols)
    if kernel not in boxes:
        raise ValueError(f"unknown kernel {kernel!r}")
    stages = STAGES[kernel][width]
    # full and empty a stage; the forward's prologue adds `ready`
    epilogue, barriers = 0, (3 if kernel == "forward" else 2) * stages * 8
    if kernel != "dw":
        store = min(width, 128) if kernel == "forward" else \
            (64 if width == 256 else width)
        epilogue = BLOCK_ROWS * store * 2 + 2 * CONSUMER_WARPS * width * 4
    if kernel == "dx" and normalize:   # x's tile; a, b, inv, minv
        epilogue += BLOCK_ROWS * width * 2 + 4 * width * 4
        barriers += 16
    return (ATOM_BYTES + stages * (boxes[kernel] * BOX_BYTES + operand)
            + epilogue + barriers)


def _grid(rows: int, cols: int, width: int, sms: int) -> int:
    """Persistent blocks over the 128-row tiles ``width`` wide of a
    (rows, cols) output: one an SM, no more than the tiles."""
    return min(-(-rows // BLOCK_ROWS) * -(-cols // width), sms)


@functools.lru_cache(maxsize=None)
def forward_plan(m: int, k: int, n: int, sms: int = H100_SMS
                 ) -> Tuple[int, int]:
    """(tile width, persistent blocks) of the bf16 forward kernel."""
    width = tile_widths(k, n)[0]
    return width, _grid(m, n, width, sms)


@functools.lru_cache(maxsize=None)
def dx_plan(m: int, k: int, n: int, sms: int = H100_SMS,
            normalize: bool = False) -> Tuple[int, int]:
    """(tile width, persistent blocks) of the bf16 dx kernel, with or
    without the BatchNorm epilogue."""
    width = tile_widths(k, n, normalize)[1]
    return width, _grid(m, k, width, sms)


@functools.lru_cache(maxsize=None)
def dw_plan(m: int, k: int, n: int, sms: int = H100_SMS
            ) -> Tuple[int, int, int, int]:
    """(tile width along K, splits, rows per split, persistent blocks) of
    the bf16 dW kernel; the float32 kernel takes the same splits. A work
    item is one 128 x width tile of dW^T and one split of the M rows. The
    split count is the one, up to ``round(sms / tiles)``, whose items fill
    the card's waves best (ties to fewer), so that the float32 partials
    stay near one wave of tiles whatever M is; one split writes dW with no
    partials."""
    width = tile_widths(k, n)[2]
    tiles = -(-n // DW_TILE_ROWS) * -(-k // width)
    best = None
    for s in range(1, max(1, round(sms / tiles)) + 1):
        rows = -(-(-(-m // s)) // DW_ROW_STEP) * DW_ROW_STEP
        s = -(-m // rows)
        fill = _wave_fill(tiles * s, sms)
        if best is None or fill > best[0] + 1e-9:
            best = (fill, s, rows)
    _, s, rows = best
    return width, s, rows, min(tiles * s, sms)


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def backward(gy, gs, gss, y, x, w, consts=None, relu: bool = False, *,
             counter):
    """``(dx, dw, dgamma, dbeta)`` of the backward function; arguments and
    results as ``backward_plain``. Takes every shape the forward takes: no
    fit rule. Adds one to ``counter.launches`` where it launches the
    kernels (one launch function starts both on the current stream)."""
    if x.device.type == "cpu":
        return backward_plain(gy, gs, gss, y, x, w, consts, relu)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    m, k, n = _check_problem(x, w)
    wt = _weight_rows(w)
    _check_matrix("gy", gy, (m, n), x.dtype, x.device)
    _check_matrix("y", y, (m, n), x.dtype, x.device)
    gs = _vector("gs", gs, n, x.device)
    gss = _vector("gss", gss, n, x.device)
    normalize = consts is not None
    if normalize:
        a, b, inv, minv = (_vector(name, v, k, x.device) for name, v in
                           zip(("a", "b", "inv", "minv"), consts))
    grid_m = -(-m // BLOCK_ROWS)
    sms = _sm_count(x.device)
    dx_width, dx_grid = dx_plan(m, k, n, sms, normalize)
    dw_width, splits, rows, dw_grid = dw_plan(m, k, n, sms)
    dx = torch.empty((m, k), dtype=x.dtype, device=x.device)
    dwt_part = torch.empty((splits, n, k), dtype=torch.float32,
                           device=x.device)
    pdgamma = pdbeta = None
    if normalize:     # (dgamma, dbeta) partials, each (K, ceil(M/128))
        bn_part = torch.empty((2, k, grid_m), dtype=torch.float32,
                              device=x.device)
        pdgamma, pdbeta = bn_part[0], bn_part[1]
    from resnet_tpu_torch._build import load_library
    lib = load_library("matmul_stats_bwd")
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(x.device):
        err = lib.matmul_stats_bwd_launch(
            gy.data_ptr(), y.data_ptr(), x.data_ptr(), wt.data_ptr(),
            gs.data_ptr(), gss.data_ptr(),
            *((a.data_ptr(), b.data_ptr(), inv.data_ptr(), minv.data_ptr())
              if normalize else (None,) * 4),
            dx.data_ptr(), ptr(pdgamma), ptr(pdbeta), dwt_part.data_ptr(),
            m, k, n, splits, rows, _DTYPE_CODES[x.dtype], int(normalize),
            int(relu), dx_width, dx_grid, dw_width, dw_grid,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, "matmul_stats_bwd")
    report_launch(counter, backward_cost(m, k, n, x.element_size()))
    # (K, N) view of dW^T (N, K); the splits summed in a fixed order
    dw = (dwt_part[0] if splits == 1 else dwt_part.sum(dim=0)).t()
    if not normalize:
        return dx, dw, None, None
    dgamma, dbeta = bn_part.sum(dim=2)
    return dx, dw, dgamma, dbeta
