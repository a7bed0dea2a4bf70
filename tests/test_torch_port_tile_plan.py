"""The bf16 1x1-conv kernels' launch geometry, picked in pure Python
(``resnet_tpu_torch/ops/matmul_stats_cuda.py``), at every 1x1 conv of a
ResNet-50 train step at batch 128 (the shape table ``chip_smoke.py`` times)
and at small edge shapes. The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``); this holds what they are handed.
"""

import sys
from pathlib import Path

import pytest
import torch

from resnet_tpu_torch.ops import matmul_stats_cuda as mk

ROOT = Path(__file__).resolve().parents[1]
EDGE_SHAPES = [(1, 8, 8), (135, 8, 8), (96, 32, 64), (333, 72, 40),
               (4100, 1024, 256), (4100, 200, 136), (70000, 64, 64)]


def _r50_shapes():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.registry import get_model
    cfg = imagenet_resnet50()
    cfg.train.bn_ema = False
    model = get_model(cfg)
    ops_a, ops_b, _ = chip_smoke.r50_op_shapes(model, 128, 224)
    assert (len(ops_a), len(ops_b)) == (20, 16)
    return sorted(set(ops_a) | set(ops_b))


def _card_test_shapes():
    """MM_SHAPES and R50_SHAPES of the card's tests
    (tests/test_torch_port_cuda.py), read from that file."""
    sys.path.insert(0, str(ROOT / "tests"))
    try:
        import test_torch_port_cuda as card
    finally:
        sys.path.remove(str(ROOT / "tests"))
    return list(card.MM_SHAPES), list(card.R50_SHAPES)


@pytest.fixture(scope="module")
def r50():
    return _r50_shapes()


@pytest.fixture(scope="module")
def shapes(r50):
    return r50 + EDGE_SHAPES


@pytest.mark.parametrize("sms", [132, 114])
def test_tile_plan_covers_every_shape(shapes, sms):
    """Forward tiles over (M, N), dx tiles over (M, K): a width the kernels
    take, 64 wherever the output is at most 64 wide, and a persistent grid
    of at least one and at most one block an SM, no more than the tiles."""
    for m, k, n in shapes:
        for plan, cols in ((mk.forward_plan, n), (mk.dx_plan, k),
                           (lambda *a: mk.dx_plan(*a, normalize=True), k)):
            width, grid = plan(m, k, n, sms)
            assert width in mk.TILE_WIDTHS
            assert (cols <= 64) == (width == 64)
            tiles = -(-m // mk.BLOCK_ROWS) * -(-cols // width)
            assert 1 <= grid <= min(tiles, sms)


def test_tile_width_rule_at_resnet50(r50):
    """128 x 64 only where the output is at most 64 wide (at bs128 the
    forward of the N = 64 convs and the dx and dW of the K = 64 ones);
    128 x 256 where it measured faster: the forward of N >= 256 at K <=
    512, the dx of K >= 512, the dW of K >= 256; 128 x 128 elsewhere."""
    widths = {(m, k, n): (mk.forward_plan(m, k, n)[0], mk.dx_plan(m, k, n)[0],
                          mk.dw_plan(m, k, n)[0]) for m, k, n in r50}
    for (m, k, n), (fwd, dx, dw) in widths.items():
        assert fwd == (64 if n == 64 else 256 if n >= 256 and k <= 512
                       else 128)
        assert dx == (64 if k == 64 else 256 if k >= 512 else 128)
        assert dw == (64 if k == 64 else 256 if k >= 256 else 128)
    assert widths[(401408, 64, 64)] == (64, 64, 64)
    assert widths[(401408, 64, 256)] == (256, 64, 64)
    assert widths[(25088, 1024, 256)] == (128, 256, 256)
    assert widths[(100352, 128, 512)] == (256, 128, 128)
    assert widths[(6272, 2048, 512)] == (128, 256, 256)
    # with the prologue, dx's epilogue keeps x's tile: 128 at most
    assert mk.dx_plan(6272, 512, 2048, normalize=True)[0] == 128
    assert mk.dx_plan(100352, 128, 512, normalize=True)[0] == 128


@pytest.mark.parametrize("sms", [132, 114])
def test_dw_plan_covers_every_row(shapes, sms):
    """Splits times rows covers M and no split is empty; rows are whole
    stages; the work items stay near one wave, so the partials do too; the
    float32 kernel's grid has room for the row tiles; the grid is
    persistent."""
    for m, k, n in shapes:
        width, splits, rows, grid = mk.dw_plan(m, k, n, sms)
        assert width in mk.TILE_WIDTHS and (k > 64 or width == 64)
        assert rows % mk.DW_ROW_STEP == 0 and rows >= mk.DW_ROW_STEP
        assert splits * rows >= m > (splits - 1) * rows
        tiles = -(-n // mk.DW_TILE_ROWS) * -(-k // width)
        assert splits <= max(1, round(sms / tiles))
        assert 1 <= grid <= min(tiles * splits, sms)
        assert -(-m // mk.BLOCK_ROWS) <= mk.MAX_GRID_Y


def test_dw_plan_fills_the_card_at_resnet50(r50):
    """At every bs128 shape the dW work items fill at least 70% of the
    block slots of their waves on a 132-SM card."""
    assert len(r50) == 15
    for m, k, n in r50:
        width, splits, _, _ = mk.dw_plan(m, k, n)
        items = -(-n // mk.DW_TILE_ROWS) * -(-k // width) * splits
        assert mk._wave_fill(items, 132) >= 0.7, (m, k, n, items)


def test_card_tests_hold_the_kernels_at_every_resnet50_shape(r50):
    """The card's kernel tests take the 15 distinct bs128 shapes that
    chip_smoke.py derives from the model."""
    assert sorted(_card_test_shapes()[1]) == r50


@pytest.mark.parametrize("which", ["resnet50", "card_tests"])
def test_smem_budget_fits_every_launch(r50, which):
    """Each bf16 kernel's shared memory (the ring of 64 x 64 TMA boxes, the
    epilogue's staging and partials, the barriers, the alignment slack) at
    the tile widths its plan picks stays within the 232,448 bytes a block
    may use on an H100, at every ResNet-50 shape and every shape of the
    card's tests."""
    shapes = r50 if which == "resnet50" else _card_test_shapes()[0]
    for m, k, n in shapes:
        for normalize in (False, True):
            used = (mk.smem_bytes("forward", mk.forward_plan(m, k, n)[0]),
                    mk.smem_bytes("dx", mk.dx_plan(
                        m, k, n, normalize=normalize)[0], normalize),
                    mk.smem_bytes("dw", mk.dw_plan(m, k, n)[0]))
            assert max(used) <= mk.SMEM_LIMIT, ((m, k, n), used)
    assert mk.smem_bytes("dx", 256, normalize=True) > mk.SMEM_LIMIT


def test_smem_budget_matches_the_kernels_layout():
    """The layouts, summed by hand from csrc/matmul_stats*.cu's FwdSmem,
    DxSmem and DwSmem: 1024 bytes of alignment, the stages of 8 KB boxes
    (5 forward, 3 at width 256; 3 dx; 4 dW, 3 at width 256), one store
    pass's staging and the warps' (sum, sumsq) partials, dx's x tile and
    constants with the prologue, two 8-byte barriers a stage (three forward: the
    prologue's `ready`); the 256-wide dx the closest to the limit, and
    with the prologue over it."""
    box = 64 * 64 * 2
    assert mk.smem_bytes("forward", 128) == \
        1024 + 5 * 4 * box + 128 * 128 * 2 + 2 * 8 * 128 * 4 + 5 * 24
    assert mk.smem_bytes("forward", 256) == \
        1024 + 3 * 6 * box + 128 * 128 * 2 + 2 * 8 * 256 * 4 + 3 * 24
    assert mk.smem_bytes("dx", 256) == \
        1024 + 3 * 8 * box + 128 * 64 * 2 + 2 * 8 * 256 * 4 + 3 * 16
    assert mk.smem_bytes("dx", 128, normalize=True) == \
        1024 + 3 * 6 * box + 128 * 128 * 2 + 2 * 8 * 128 * 4 \
        + 128 * 128 * 2 + 4 * 128 * 4 + 3 * 16 + 16
    assert mk.smem_bytes("dw", 128) == 1024 + 4 * 6 * box + 4 * 16
    assert mk.smem_bytes("dw", 256) == 1024 + 3 * 8 * box + 3 * 16
    assert mk.SMEM_LIMIT - mk.smem_bytes("dx", 256) == 2000
    with pytest.raises(ValueError, match="unknown kernel"):
        mk.smem_bytes("dy", 128)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tma_alignment_rule_refuses_offset_and_ragged_views(dtype):
    """The tensor maps need 16-byte-aligned bases and row pitches: a view
    one element (2 bytes in bf16) into an aligned buffer, or a matrix whose rows are not a
    multiple of 16 bytes apart, is refused by the pure rule and by the
    wrapper's matrix check; aligned matrices and row blocks pass."""
    item = torch.empty((), dtype=dtype).element_size()
    flat = torch.zeros(64 * 40 + 16, dtype=dtype)
    start = (-flat.data_ptr() % 16) // item   # the first aligned element
    rule = lambda t: mk.tma_misalignment(t.data_ptr(), t.stride(),
                                         t.element_size())
    whole = flat[start:start + 64 * 40].view(64, 40)
    assert rule(whole) is None and rule(whole[8:]) is None
    mk._check_matrix("x", whole, (64, 40), dtype, whole.device)
    off = flat[start + 1:start + 1 + 64 * 40].view(64, 40)   # 2 or 4 bytes
    assert off.is_contiguous() and "16-byte boundary" in rule(off)
    with pytest.raises(ValueError, match="x must start on a 16-byte"):
        mk._check_matrix("x", off, off.shape, dtype, off.device)
    ragged = flat[start:start + 64 * 6].view(64, 6)   # 12 or 24 bytes a row
    assert ragged.is_contiguous() and "row strides" in rule(ragged)
    with pytest.raises(ValueError, match="gy must have row strides"):
        mk._check_matrix("gy", ragged, ragged.shape, dtype, ragged.device)
    assert "unit column stride" in mk.tma_misalignment(0, (64, 2), 2)
