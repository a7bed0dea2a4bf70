"""The bf16 1x1-conv kernels' launch geometry, picked in pure Python
(``resnet_tpu_torch/ops/matmul_stats_cuda.py``), at every 1x1 conv of a
ResNet-50 train step at batch 128 (the shape table ``chip_smoke.py`` times)
and at small edge shapes. The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``); this holds what they are handed.
"""

import sys
from pathlib import Path

import pytest

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
        for rows, cols in ((m, n), (m, k)):
            width, grid = mk.tile_plan(rows, cols, sms)
            assert width in mk.TILE_WIDTHS
            assert cols > 64 or width == 64
            tiles = -(-rows // mk.BLOCK_ROWS) * -(-cols // width)
            assert 1 <= grid <= min(tiles, sms)


def test_tile_width_rule_at_resnet50(r50):
    """128 x 64 only where the output is at most 64 wide: at bs128 the
    forward of the N = 64 convs and the dx of the K = 64 ones; 128 x 128
    everywhere else, the dW^T tiles included."""
    narrow = {(m, k, n, which) for m, k, n in r50
              for which, (rows, cols) in (("fwd", (m, n)), ("dx", (m, k)))
              if mk.tile_plan(rows, cols)[0] == 64}
    assert narrow == {(m, k, n, which) for m, k, n in r50
                      for which, cols in (("fwd", n), ("dx", k))
                      if cols == 64}
    assert {(401408, 64, 64, "fwd"), (401408, 256, 64, "fwd"),
            (401408, 64, 256, "dx")} <= narrow
    for m, k, n in r50:
        assert mk.dw_plan(m, k, n)[0] == (64 if k == 64 else 128)


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
