"""The augmentation kernel's launch plan, picked in pure Python
(``resnet_tpu_torch/ops/augment_fused.py::aug_plan``), and the division
sequence its HSL round-trip uses. The kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``); this holds what it is handed: for
crops the samplers draw (letterboxed, upscaled, at the valid edge, whole,
mirrored), every band's canvas window fits the rows and columns the plan
stages, the shared memory fits a block, and the bands cover every output
row once.
"""

import numpy as np
import pytest
import torch

from resnet_tpu_torch.config import DataConfig
from resnet_tpu_torch.ops import augment_fused as af
from resnet_tpu_torch.ops.augment import sample_boxes_canvas

# (canvas h, w, output h, w, s2d): the training shapes, the trace probe's,
# a large canvas, and small odd ones
SHAPES = [(256, 256, 224, 224, True), (224, 224, 224, 224, False),
          (512, 512, 224, 224, True), (40, 48, 32, 32, True),
          (40, 29, 31, 31, False), (17, 23, 9, 11, False),
          (112, 112, 96, 96, True)]


def _crops(sh, sw, oh, ow, n=96, seed=0):
    """(N, 7) float32 rows (y0, x0, ch, cw, flip, vh, vw): random-resized
    crops the port's sampler draws on canvases a third of them letterboxed,
    then upscales, crops at the valid edge and whole crops, each mirrored
    and not."""
    g = torch.Generator().manual_seed(seed)
    dims = torch.tensor([[sh, sw, sh, sw]] * n, dtype=torch.int32)
    lb = torch.arange(n) % 3 == 0
    orig = torch.randint(sh // 2 + 1, 3 * sh, (n, 2), generator=g)
    scale = min(sh, sw) / orig.max(dim=1).values.float()
    eff = torch.minimum(torch.round(orig.float() * scale[:, None]),
                        torch.tensor([sh, sw], dtype=torch.float32))
    dims[lb, :2] = orig[lb].int()
    dims[lb, 2:] = eff[lb].clamp_min(1).int()
    y0, x0, ch, cw = sample_boxes_canvas(g, DataConfig(), n, sh, sw,
                                         (oh, ow), dims)
    vh, vw = dims[:, 2].float(), dims[:, 3].float()
    rows = [torch.stack([y0, x0, ch, cw, torch.zeros(n), vh, vw], 1)]
    for c_h, c_w, at_edge in ((3.0, 2.0, False), (3.0, 2.0, True),
                              (sh, sw, False), (sh / 3, sw / 2, True)):
        y = sh - c_h if at_edge else 0.0
        x = sw - c_w if at_edge else 0.0
        rows.append(torch.tensor([[y, x, c_h, c_w, 0.0, sh, sw]]))
    rows = torch.cat(rows).float()
    mirrored = rows.clone()
    mirrored[:, 4] = 1.0
    return torch.cat([rows, mirrored])


def _taps(start, size, valid, out_size, positions):
    """The kernel's ``axis_tap`` floors in float32: ``start + (pos + 0.5) *
    (size / out_size) - 0.5`` clamped to ``[0, valid - 1]``, for each crop
    (rows) and position (columns)."""
    scale = size / torch.tensor(float(out_size))
    pos = positions.float()[None, :]
    src = start[:, None] + (pos + 0.5) * scale[:, None] - 0.5
    src = torch.minimum(src.clamp_min(0.0), valid[:, None] - 1.0)
    return torch.floor(src).long()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_band_window_fits_the_staged_budget(shape):
    sh, sw, oh, ow, s2d = shape
    plan = af.aug_plan(sh, sw, oh, ow, s2d)
    assert plan.staged_rows > 0, "every shape here stages its rows"
    rows = _crops(sh, sw, oh, ow)
    y0, x0, ch, cw, flip, vh, vw = rows.unbind(1)
    # columns: the ends of the mirrored or plain output column range
    j = torch.tensor([0, ow - 1])
    j_eff = torch.where(flip[:, None] > 0.5, (ow - 1) - j[None, :], j[None])
    xa = torch.stack([_taps(x0[i:i + 1], cw[i:i + 1], vw[i:i + 1], ow,
                            j_eff[i])[0] for i in range(len(rows))])
    nc = xa.max(dim=1).values + 2 - xa.min(dim=1).values
    assert int(nc.max()) <= plan.staged_cols <= sw + 1
    for b in range(plan.bands):
        i0 = b * plan.band_rows
        last = min(i0 + plan.band_rows, oh) - 1
        ya = _taps(y0, ch, vh, oh, torch.tensor([i0, last]))
        nr = ya.max(dim=1).values + 2 - ya.min(dim=1).values
        assert int(nr.max()) <= plan.staged_rows, (b, int(nr.max()))
        assert plan.staged_rows == af.band_source_rows(plan.band_rows, sh,
                                                       oh)


@pytest.mark.parametrize("shape", SHAPES + [(6, 10000, 4, 8, False),
                                            (2048, 2048, 64, 64, True),
                                            (3, 5, 1, 1, False)], ids=str)
def test_plan_shared_memory_and_bands(shape):
    """The shared memory the plan asks for is the layout's, fits a block,
    and stays within the target unless the band is already the smallest;
    bands are even in s2d, no taller than a block's threads, and cover
    every output row once."""
    sh, sw, oh, ow, s2d = shape
    plan = af.aug_plan(sh, sw, oh, ow, s2d)
    step = 2 if s2d else 1
    assert plan.band_rows % step == 0 and step <= plan.band_rows
    assert plan.band_rows <= min(af.AUG_MAX_BAND, af.AUG_THREADS)
    assert plan.smem_bytes == af.aug_smem_bytes(
        ow, plan.band_rows, plan.staged_rows, plan.staged_cols)
    assert plan.smem_bytes <= af.AUG_SMEM_MAX
    if plan.band_rows > step:
        assert plan.smem_bytes <= af.AUG_SMEM_TARGET
    assert (plan.staged_rows == 0) == (plan.staged_cols == 0)
    starts = [b * plan.band_rows for b in range(plan.bands)]
    covered = [i for s in starts for i in range(s, min(s + plan.band_rows,
                                                       oh))]
    assert covered == list(range(oh))


def test_a_canvas_too_wide_for_a_block_stages_nothing():
    plan = af.aug_plan(6, 10000, 4, 8, False)
    assert plan.band_rows == 1 and plan.staged_rows == 0
    assert af.aug_smem_bytes(8, 1, af.band_source_rows(1, 6, 4),
                             10001) > af.AUG_SMEM_MAX


def _fma32(a, b, c):
    """float32 fused multiply-add, correctly rounded: ``a*b`` is exact in
    float64; where the float64 sum lands exactly halfway between two
    float32 values, its rounding error (TwoSum) says which way the exact
    sum lies."""
    a, b, c = (np.asarray(v, np.float32).astype(np.float64)
               for v in (a, b, c))
    p = a * b
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.astype(np.float32)
    up = np.nextafter(r, np.float32(np.inf))
    dn = np.nextafter(r, np.float32(-np.inf))
    r64 = r.astype(np.float64)
    tie_up = s == (r64 + up.astype(np.float64)) / 2
    tie_dn = s == (r64 + dn.astype(np.float64)) / 2
    r = np.where(tie_up & (err > 0), up, r)
    return np.where(tie_dn & (err < 0), dn, r)


@pytest.mark.parametrize("d", [255.0, 30.0])
def test_constant_division_sequence_is_ieee_division(d):
    """``ConstDiv`` in csrc/augment.cu: r0 = RN(1/d), r = fma(fma(r0, -d,
    1), r0, r0); q = fma(r, x, 0); x/d = fma(r, fma(q, -d, x), q). Equal to
    the correctly rounded quotient at every float32 in [1, 2), hence (each
    step scales exactly by a power of two) at every x in [2^-100, 2^100],
    and at +0."""
    f = np.float32
    d = f(d)
    r0 = f(1.0) / d
    r = _fma32(_fma32(r0, -d, f(1.0)), r0, r0)
    step = 1 << 21
    for lo in range(0, 1 << 23, step):
        bits = np.arange(lo, lo + step, dtype=np.uint32) | np.uint32(
            0x3F800000)
        x = bits.view(np.float32)
        q = _fma32(r, x, f(0.0))
        got = _fma32(r, _fma32(q, -d, x), q)
        np.testing.assert_array_equal(got, x / d)
    rng = np.random.default_rng(0)
    x = (rng.uniform(1.0, 2.0, 4096) * 2.0 ** rng.integers(-100, 100, 4096)
         ).astype(np.float32)
    x = np.concatenate([x, np.zeros(1, np.float32)])
    q = _fma32(r, x, f(0.0))
    np.testing.assert_array_equal(_fma32(r, _fma32(q, -d, x), q), x / d)
