"""Tests of the port that need the CUDA card; each skips without one.

They import nothing of JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The kernel is held against its plain PyTorch version (itself held against
the JAX kernel by tests/test_torch_port_augment.py), and the card's
max-pool backward against the CPU's tie routing.
"""

import numpy as np
import pytest
import torch

from resnet_tpu_torch.config import DataConfig
from resnet_tpu_torch.ops.augment import space_to_depth
from resnet_tpu_torch.ops.augment_fused import (
    augment_rows, fused_crop_mirror_normalize,
    fused_crop_mirror_normalize_reference)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from resnet_tpu_torch.utils.device import set_tf32
    set_tf32(False)
    yield torch.device("cuda")
    set_tf32(True)


def _inputs(device, n=5, hc=40, wc=48):
    g = torch.Generator().manual_seed(0)
    canvas = torch.randint(0, 256, (n, hc, wc, 3), generator=g,
                           dtype=torch.uint8)
    vh = torch.tensor([40.0, 23.0, 40.0, 31.0, 40.0][:n])
    vw = torch.tensor([48.0, 48.0, 17.0, 29.0, 48.0][:n])
    ch = torch.round(4 + torch.rand(n, generator=g) * (vh - 4))
    cw = torch.round(4 + torch.rand(n, generator=g) * (vw - 4))
    y0 = torch.floor(torch.rand(n, generator=g) * (vh - ch + 1))
    x0 = torch.floor(torch.rand(n, generator=g) * (vw - cw + 1))
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)
    ph = {"dh": u(-36, 36), "ds": u(-50, 50), "dl": u(-50, 50),
          "alpha": u(0.7, 1.3), "beta": u(-20, 20)}
    rows = augment_rows((y0, x0, ch, cw), torch.rand(n, generator=g) < 0.5,
                        (vh, vw), ph, n, (hc, wc))
    return canvas.to(device), rows.to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s2d", [False, True], ids=["standard", "s2d"])
def test_kernel_matches_plain_version(cuda, s2d, dtype):
    canvas, rows = _inputs(cuda)
    d = DataConfig()
    args = (canvas, rows, (32, 32), d.mean_rgb, d.std_rgb, dtype)
    flags = dict(s2d=s2d, hsl=True, contrast=True, illum=True)
    before = fused_crop_mirror_normalize.launches
    got = fused_crop_mirror_normalize(*args, **flags)
    want = fused_crop_mirror_normalize_reference(*args, **flags)
    torch.cuda.synchronize()
    assert fused_crop_mirror_normalize.launches == before + 1
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                               rtol=rtol)
    if s2d:
        std = fused_crop_mirror_normalize(*args, **dict(flags, s2d=False))
        assert torch.equal(got, space_to_depth(std))


def _aug_case(device, n, hc, wc, *, upscale=False, wide_dh=False,
              overrun=False, seed=1):
    """``n`` uint8 canvases of ``hc`` x ``wc`` (every other one letterboxed
    to about 3/4 of each side, zero beyond) and rows drawn for them: crops
    of 2-6 pixels a side with ``upscale``; hue shifts with 180 <= |dh| <
    540 with ``wide_dh``; with ``overrun`` a valid extent and a crop three
    times the canvas's height, so that a band taps more canvas rows than
    the launch plan stages (taps beyond the canvas add nothing)."""
    g = torch.Generator().manual_seed(seed)
    canvas = torch.randint(0, 256, (n, hc, wc, 3), generator=g,
                           dtype=torch.uint8)
    lb = torch.arange(n) % 2 == 1
    vh = torch.where(lb, float(max(1, hc * 3 // 4)), float(hc))
    vw = torch.where(lb, float(max(1, wc * 3 // 4)), float(wc))
    for i in range(n):
        canvas[i, int(vh[i]):] = 0
        canvas[i, :, int(vw[i]):] = 0
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(n, generator=g)
    if upscale:
        ch, cw = torch.round(u(2, 6)), torch.round(u(2, 6))
    else:
        ch = torch.round(u(0.2, 1) * vh).clamp_min(2.0)
        cw = torch.round(u(0.2, 1) * vw).clamp_min(2.0)
    if overrun:
        vh = ch = torch.full((n,), 3.0 * hc)
    y0 = torch.floor(u(0, 1) * (vh - ch + 1))
    x0 = torch.floor(u(0, 1) * (vw - cw + 1))
    dh = u(-36, 36)
    if wide_dh:
        dh = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0) * u(180, 540)
    ph = {"dh": dh, "ds": u(-50, 50), "dl": u(-50, 50),
          "alpha": u(0.7, 1.3), "beta": u(-20, 20)}
    rows = augment_rows((y0, x0, ch, cw), torch.rand(n, generator=g) < 0.5,
                        (vh, vw), ph, n, (hc, wc))
    return canvas.to(device), rows.to(device)


def _assert_kernel(canvas, rows, out_hw, dtype, **flags):
    """The kernel against its plain version in the standard layout and,
    where the output is even, in s2d, which must be a bitwise regroup of
    the standard output. Returns the standard output."""
    d = DataConfig()
    args = (canvas, rows, out_hw, d.mean_rgb, d.std_rgb, dtype)
    rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
    got = fused_crop_mirror_normalize(*args, **flags)
    want = fused_crop_mirror_normalize_reference(*args, **flags)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=5e-2,
                               rtol=rtol)
    if out_hw[0] % 2 == 0 and out_hw[1] % 2 == 0:
        blocked = fused_crop_mirror_normalize(*args, s2d=True, **flags)
        assert torch.equal(blocked, space_to_depth(got))
    return got


_ALL_FLAGS = dict(hsl=True, contrast=True, illum=True)
# (canvas n, hc, wc, _aug_case switches), output size: the shapes the
# launch plan must take beside the training ones
_EDGE_CASES = {
    "odd_width": ((3, 40, 48, {}), (31, 29)),
    "unaligned_canvas": ((4, 40, 29, {}), (32, 32)),
    "upscale": ((4, 40, 48, dict(upscale=True)), (32, 32)),
    "one_image": ((1, 40, 48, {}), (32, 32)),
    "canvas512": ((2, 512, 512, {}), (224, 224)),
    "wide_dh": ((4, 40, 48, dict(wide_dh=True)), (32, 32)),
    "overrun": ((4, 40, 48, dict(overrun=True)), (32, 32)),
    "unstaged_canvas": ((2, 6, 10000, {}), (4, 8)),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(_EDGE_CASES))
def test_kernel_edge_shapes_match_plain_version(cuda, case, dtype):
    (n, hc, wc, switches), out_hw = _EDGE_CASES[case]
    canvas, rows = _aug_case(cuda, n, hc, wc, **switches)
    _assert_kernel(canvas, rows, out_hw, dtype, **_ALL_FLAGS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_without_hsl_matches_plain_version(cuda, dtype):
    canvas, rows = _aug_case(cuda, 5, 40, 48)
    _assert_kernel(canvas, rows, (32, 32), dtype, contrast=True, illum=True)


def test_kernel_launches_give_identical_bits(cuda):
    canvas, rows = _aug_case(cuda, 5, 40, 48)
    d = DataConfig()
    args = (canvas, rows, (32, 32), d.mean_rgb, d.std_rgb, torch.bfloat16)
    for s2d in (False, True):
        first = fused_crop_mirror_normalize(*args, s2d=s2d, **_ALL_FLAGS)
        again = fused_crop_mirror_normalize(*args, s2d=s2d, **_ALL_FLAGS)
        assert torch.equal(first, again)


_F = np.float32


def _floor_mod(x, m):
    r = np.fmod(x, m)
    return np.where((r != 0) & (r < 0), r + m, r)


def _clip(x, lo, hi):
    return np.minimum(np.maximum(x, _F(lo)), _F(hi))


def _per_pixel_form(canvas, rows, out_hw, mean_rgb, std_rgb):
    """The kernel's function evaluated pixel by pixel in numpy float32
    (IEEE operations, no fused multiply-adds, divisions with ``/``), in the
    kernel's expression order: the taps, the bilinear sample (zero outside
    the canvas), the HSL round-trip with contrast and illumination, the
    normalize. Returns the float32 (N, oh, ow, 3) output and each pixel's
    ``delta`` (max - min of its channels over 255)."""
    img = canvas.astype(_F)
    n, sh, sw, _ = img.shape
    oh, ow = out_hw
    y0, x0, ch, cw, flip, vh, vw, dh, ds, dl, alpha, beta = (
        rows[:, k:k + 1] for k in range(12))

    def taps(pos, start, size, out_size, valid):
        src = start + (pos + _F(0.5)) * (size / _F(out_size)) - _F(0.5)
        src = np.minimum(np.maximum(src, _F(0)), valid - _F(1))
        f = np.floor(src)
        return (f.astype(np.int64), np.maximum(_F(0), _F(1) - np.abs(src - f)),
                np.maximum(_F(0), _F(1) - np.abs(src - (f + _F(1)))))

    j = np.arange(ow, dtype=_F)[None]
    ya, wya, wyb = taps(np.arange(oh, dtype=_F)[None], y0, ch, oh, vh)
    xa, wxa, wxb = taps(np.where(flip > 0.5, (_F(ow) - _F(1)) - j, j), x0,
                        cw, ow, vw)
    idx = np.arange(n)[:, None, None]

    def pixel(y, x):
        inside = (y >= 0) & (y < sh) & (x >= 0) & (x < sw)
        v = img[idx, np.clip(y, 0, sh - 1), np.clip(x, 0, sw - 1)]
        return np.where(inside[..., None], v, _F(0))

    y, x = ya[:, :, None], xa[:, None, :]
    wa, wb = wya[:, :, None, None], wyb[:, :, None, None]
    va = wa * pixel(y, x) + wb * pixel(y + 1, x)
    vb = wa * pixel(y, x + 1) + wb * pixel(y + 1, x + 1)
    p = va * wxa[:, None, :, None] + vb * wxb[:, None, :, None]

    r, g, b = (p[..., c] / _F(255) for c in range(3))
    cmax = np.maximum(np.maximum(r, g), b)
    cmin = np.minimum(np.minimum(r, g), b)
    delta = cmax - cmin
    light = (cmax + cmin) / _F(2)
    safe = delta > _F(1e-8)
    den = delta + _F(1e-8)
    with np.errstate(divide="ignore", invalid="ignore"):
        sat = np.where(safe, delta / (_F(1) - np.abs(_F(2) * light - _F(1))
                                      + _F(1e-8)), _F(0))
        hr = np.where(safe & (cmax == r), _floor_mod((g - b) / den, _F(6)),
                      _F(0))
        hg = np.where(safe & (cmax == g) & (cmax != r),
                      (b - r) / den + _F(2), _F(0))
        hb = np.where(safe & (cmax == b) & (cmax != r) & (cmax != g),
                      (r - g) / den + _F(4), _F(0))
    per_image = lambda v: v[:, :, None]
    h = _floor_mod((hr + hg + hb) * _F(30) + per_image(dh), _F(180)) / _F(30)
    light = _clip(light + per_image(dl) / _F(255), 0, 1)
    sat = _clip(sat + per_image(ds) / _F(255), 0, 1)
    c = (_F(1) - np.abs(_F(2) * light - _F(1))) * sat
    xx = c * (_F(1) - np.abs(_floor_mod(h, _F(2)) - _F(1)))
    m = light - c / _F(2)
    sector = h.astype(np.int32) % 6
    zero = np.zeros_like(c)
    pick = lambda *v: np.select([sector == k for k in range(5)], v[:5], v[5])
    rgb = [pick(c, xx, zero, zero, xx, c), pick(xx, c, c, xx, zero, zero),
           pick(zero, zero, xx, c, c, xx)]
    out = []
    for k, v in enumerate(rgb):
        v = _clip((v + m) * _F(255), 0, 255) - _F(mean_rgb[k])
        v = v * per_image(alpha) + per_image(beta)
        out.append(v * _F(1.0 / float(std_rgb[k])))
    return np.stack(out, axis=-1), delta


def _near_grey_case(n=8, hc=40, wc=48, seed=3):
    """Canvases whose channels differ by 0-2 levels, on a third of the
    pixels, and crops of any position and scale: sampled pixels whose
    channels lie within a small fraction of a level of each other, where
    the hue's division takes its smallest divisors. The last two images
    shift the hue by 180-540 degrees."""
    rng = np.random.default_rng(seed)
    grey = rng.integers(0, 254, (n, hc, wc, 1))
    spread = rng.integers(0, 3, (n, hc, wc, 3)) * (
        rng.random((n, hc, wc, 1)) < 1 / 3)
    canvas = (grey + spread).astype(np.uint8)
    u = lambda lo, hi: rng.uniform(lo, hi, n)
    ch, cw = u(1.5, hc), u(1.5, wc)
    y0, x0 = u(0, 1) * (hc - ch), u(0, 1) * (wc - cw)
    dh = u(-36, 36)
    dh[-2:] = [300.0, -200.0]
    cols = [y0, x0, ch, cw, (np.arange(n) % 2).astype(float),
            np.full(n, hc), np.full(n, wc), dh, u(-50, 50), u(-50, 50),
            u(0.7, 1.3), u(-20, 20)]
    return canvas, np.stack(cols, axis=1).astype(_F)


def test_kernel_is_the_per_pixel_form_bit_for_bit_on_near_grey_pixels(cuda):
    """The kernel's divisions (a fast sequence where it is exact, ``/``
    elsewhere) against IEEE division, pixel by pixel, where the hue's
    divisor ``delta + 1e-8`` is smallest: the float32 outputs must be the
    same bits."""
    canvas, rows = _near_grey_case()
    d = DataConfig()
    want, delta = _per_pixel_form(canvas, rows, (48, 48), d.mean_rgb,
                                  d.std_rgb)
    assert int(((delta > 1e-8) & (delta < 1e-4)).sum()) >= 100
    got = fused_crop_mirror_normalize(
        torch.from_numpy(canvas).to(cuda), torch.from_numpy(rows).to(cuda),
        (48, 48), d.mean_rgb, d.std_rgb, torch.float32, **_ALL_FLAGS)
    got = got.cpu().numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32)), (
        int((got != want).sum()), float(np.abs(got - want).max()))


def test_kernel_rejects_bad_input(cuda):
    canvas, rows = _inputs(cuda)
    d = DataConfig()
    with pytest.raises(ValueError):
        fused_crop_mirror_normalize(canvas[:, :, ::2], rows, (32, 32),
                                    d.mean_rgb, d.std_rgb)
    with pytest.raises(ValueError):
        fused_crop_mirror_normalize(canvas, rows[:, :11], (32, 32),
                                    d.mean_rgb, d.std_rgb)


def test_pool_backward_ties_match_cpu(cuda):
    from resnet_tpu_torch.ops.pool import stem_max_pool
    g = torch.Generator().manual_seed(0)
    x = torch.relu(torch.randn(2, 4, 9, 10, generator=g))
    x[0, :, :4, :4] = 0.5
    dy = torch.randn(2, 4, 5, 5, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).contiguous(memory_format=torch.channels_last)
        xd.requires_grad_()
        stem_max_pool(xd).backward(dy.to(dev))
        grads.append(xd.grad.cpu())
    assert torch.equal(grads[0], grads[1])


def test_train_step_launches_the_kernel(cuda):
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.resnet import ResNet
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    cfg = imagenet_resnet50()
    cfg.data.image_shape = (32, 32, 3)
    model = ResNet(units=(1, 1, 1, 1), filters=(8, 16, 32, 64, 128),
                   num_classes=1000, bottleneck=True, bn_ema=True,
                   stem_s2d=True, dtype=torch.bfloat16)
    state = create_train_state(cfg, device=cuda, model=model)
    step = make_train_step(augment_fn=make_augment_fn(cfg),
                           steps_per_dispatch=2)
    batch = {"image": torch.randint(0, 256, (2, 4, 40, 48, 3),
                                    dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 1000, (2, 4), device=cuda)}
    before = fused_crop_mirror_normalize.launches
    state, m = step(state, batch)
    assert fused_crop_mirror_normalize.launches == before + 2
    assert state.step == 2 and float(m["count"]) == 8
    assert torch.isfinite(m["loss_sum"])


# ---------------------------------------------------------------------------
# the fused 1x1-conv kernels (csrc/matmul_stats.cu, matmul_stats_bwd.cu)
# against their plain versions
# ---------------------------------------------------------------------------

# elementwise outputs: one bf16 ulp (2^-7) where the two round on either
# side of a boundary, summation order only in float32; sums: 2e-5 of the
# sum of the terms' magnitudes, bounded from above by Cauchy-Schwarz where
# the terms are products
_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
# (M, K, N): one block and less, ragged M over several blocks with K, N off
# the tile, and a shape with several dW splits; then the bf16 kernels'
# edges: a K that wraps the forward's 4-stage ring four times (with 128 x 64
# forward tiles), a K tail off the 64-deep stage with N not a multiple of
# 128, an M under one tile with K and N off both tile widths, and a grid
# whose blocks walk several output tiles each (K = 64: one stage a tile)
# with uneven dW splits (the last one ends inside a stage)
MM_SHAPES = [(96, 32, 64), (333, 72, 40), (4100, 64, 128),
             (4100, 1024, 256), (4100, 200, 136), (40, 136, 200),
             (70000, 64, 64)]
# every distinct 1x1 conv of a ResNet-50 train step at batch 128
# (tests/test_torch_port_tile_plan.py holds it against the model)
R50_SHAPES = [(6272, 512, 2048), (6272, 1024, 2048), (6272, 2048, 512),
              (25088, 256, 1024), (25088, 512, 1024), (25088, 1024, 256),
              (25088, 1024, 512), (100352, 128, 512), (100352, 256, 512),
              (100352, 512, 128), (100352, 512, 256), (401408, 64, 64),
              (401408, 64, 256), (401408, 256, 64), (401408, 256, 128)]


def _mm_inputs(device, m, k, n, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    randn = lambda *s: torch.randn(s, generator=g)
    x = randn(m, k).to(dtype)
    w = (randn(n, k) * (2.0 / k) ** 0.5).to(dtype).t()
    bn = dict(mean=randn(k) * 0.2, var=randn(k).abs() + 0.5,
              gamma=1 + 0.1 * randn(k), beta=0.1 * randn(k))
    cots = dict(gy=randn(m, n).to(dtype), gs=randn(n) * 0.1,
                gss=randn(n) * 0.01)
    to = lambda d: {name: v.to(device) for name, v in d.items()}
    return x.to(device), w.to(device), to(bn), to(cots)


def _assert_elementwise(got, want, dtype):
    want = want.float()
    torch.testing.assert_close(got.float(), want, rtol=_RTOL[dtype],
                               atol=1e-5 * float(want.abs().max()))


def _assert_sums(got, want, terms):
    assert bool(((got - want).abs() <= 2e-5 * terms).all()), \
        float(((got - want).abs() / terms).max())


def _consts(bn, eps=2e-5):
    inv = torch.rsqrt(bn["var"] + eps)
    a = bn["gamma"] * inv
    return a, bn["beta"] - bn["mean"] * a, inv, -bn["mean"] * inv


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MM_SHAPES + R50_SHAPES, ids=str)
@pytest.mark.parametrize("mode", ["plain", "norm", "norm-relu"])
def test_forward_kernel_matches_plain_version(cuda, mode, shape, dtype):
    from resnet_tpu_torch.ops import fused_chain as fc
    from resnet_tpu_torch.ops import fused_convbn as cb
    from resnet_tpu_torch.ops import fused_unit as fu
    x, w, bn, _ = _mm_inputs(cuda, *shape, dtype)
    if mode == "plain":
        pairs = [(cb.matmul_with_stats, lambda: cb.matmul_with_stats(x, w)),
                 (fu.matmul_stats, lambda: fu.matmul_stats(x, w))]
        want = cb.matmul_with_stats_plain(x, w)
    else:
        relu = mode == "norm-relu"
        pairs = [(fc.normalized_matmul_with_stats,
                  lambda: fc.normalized_matmul_with_stats(x, w, **bn,
                                                          relu=relu)),
                 (fu.norm_relu_matmul_stats,
                  lambda: fu.norm_relu_matmul_stats(x, w, *bn.values(), 2e-5,
                                                    relu))]
        want = fc.normalized_matmul_with_stats_plain(x, w, **bn, relu=relu)
    for wrapper, call in pairs:
        before = wrapper.launches
        got = call()
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert got[0].dtype == dtype and got[1].dtype == torch.float32
        _assert_elementwise(got[0], want[0], dtype)
        yf = want[0].float()
        _assert_sums(got[1], want[1], yf.abs().sum(0))
        _assert_sums(got[2], want[2], (yf * yf).sum(0))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", MM_SHAPES + R50_SHAPES, ids=str)
@pytest.mark.parametrize("mode", ["plain", "norm", "norm-relu"])
def test_backward_kernel_matches_plain_version(cuda, mode, shape, dtype):
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops import matmul_stats_cuda as mk
    x, w, bn, cots = _mm_inputs(cuda, *shape, dtype, seed=1)
    consts = None if mode == "plain" else _consts(bn)
    relu = mode == "norm-relu"
    a, b = (None, None) if consts is None else consts[:2]
    y = mk.forward_plain(x, w, a, b, relu)[0]
    args = (cots["gy"], cots["gs"], cots["gss"], y, x, w, consts, relu)
    before = fu.fused_backward.launches
    got = fu.fused_backward(*args)
    torch.cuda.synchronize()
    assert fu.fused_backward.launches == before + 1
    want = fu.fused_backward_plain(*args)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert got[1].shape == (shape[1], shape[2])
    _assert_elementwise(got[0], want[0], dtype)
    g = mk.folded_cotangent(cots["gy"], cots["gs"], cots["gss"], y).float()
    act = mk.activation(x, a, b, relu).float()
    _assert_sums(got[1], want[1], torch.outer(act.norm(dim=0), g.norm(dim=0)))
    if consts is None:
        assert got[2] is None and got[3] is None
    else:
        gxh = want[0].float().abs() / a.abs()
        xhat = (x.float() * consts[2] + consts[3]).abs()
        _assert_sums(got[2], want[2], (gxh * xhat).sum(0))
        _assert_sums(got[3], want[3], gxh.sum(0))


@pytest.mark.parametrize("mode", ["plain", "norm-relu"])
def test_backward_kernel_is_deterministic(cuda, mode):
    """Two launches on one input give the same bits: dW's splits are
    summed in a fixed order, the dgamma/dbeta partials too, no atomics."""
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops import matmul_stats_cuda as mk
    m, k, n = 70000, 64, 256
    assert mk.dw_plan(m, k, n)[1] > 1
    x, w, bn, cots = _mm_inputs(cuda, m, k, n, torch.bfloat16, seed=3)
    consts = None if mode == "plain" else _consts(bn)
    a, b = (None, None) if consts is None else consts[:2]
    y = mk.forward_plain(x, w, a, b, mode == "norm-relu")[0]
    args = (cots["gy"], cots["gs"], cots["gss"], y, x, w, consts,
            mode == "norm-relu")
    first, second = fu.fused_backward(*args), fu.fused_backward(*args)
    torch.cuda.synchronize()
    for got, again in zip(first, second):
        assert (got is None and again is None) or torch.equal(got, again)


@pytest.mark.parametrize("mode", ["plain", "norm-relu"])
def test_forward_kernel_is_deterministic(cuda, mode):
    """Two launches on one input give the same bits: y, and the column
    sums of partials summed in a fixed order, with blocks that walk
    several tiles each."""
    from resnet_tpu_torch.ops import fused_unit as fu
    m, k, n = 70000, 200, 136
    x, w, bn, _ = _mm_inputs(cuda, m, k, n, torch.bfloat16, seed=4)
    with torch.no_grad():
        call = (lambda: fu.matmul_stats(x, w)) if mode == "plain" else \
            (lambda: fu.norm_relu_matmul_stats(x, w, *bn.values(), 2e-5,
                                               True))
        first, second = call(), call()
    torch.cuda.synchronize()
    for got, again in zip(first, second):
        assert torch.equal(got, again)


def test_matmul_wrappers_reject_bad_input(cuda):
    from resnet_tpu_torch.ops import fused_convbn as cb
    from resnet_tpu_torch.ops import fused_unit as fu
    x, w, bn, cots = _mm_inputs(cuda, 96, 32, 64, torch.bfloat16)
    with pytest.raises(ValueError, match="bfloat16 and float32"):
        cb.matmul_with_stats(x.half(), w.half())
    with pytest.raises(ValueError, match="w must be"):
        cb.matmul_with_stats(x, w.float())
    with pytest.raises(ValueError, match="w must be"):
        cb.matmul_with_stats(x, w.cpu())
    with pytest.raises(ValueError, match="multiples of 8"):
        cb.matmul_with_stats(x[:, :20].contiguous(), w[:20])
    with pytest.raises(ValueError, match="contiguous"):
        cb.matmul_with_stats(x[::2], w)
    with pytest.raises(ValueError, match="x \\(M, K\\) and w \\(K, N\\)"):
        cb.matmul_with_stats(x, w[:16])
    with pytest.raises(ValueError, match="bfloat16 and float32"):
        fu.matmul_stats(x.double(), w.double())
    y = cb.matmul_with_stats(x, w)[0]
    with pytest.raises(ValueError, match="gy must be"):
        fu.fused_backward(cots["gy"][:, :32], cots["gs"], cots["gss"], y, x,
                          w)
    with pytest.raises(ValueError, match="gs must be"):
        fu.fused_backward(cots["gy"], cots["gs"][:8], cots["gss"], y, x, w)
    # the tensor maps' alignment: refused, not copied
    def shifted(t):   # t's values, one bf16 (2 bytes) past an aligned start
        buf = torch.empty(t.numel() + 8, dtype=t.dtype, device=t.device)
        return buf[1:1 + t.numel()].view(t.shape).copy_(t)

    x_off = shifted(x)
    assert x_off.is_contiguous() and x_off.data_ptr() % 16 == 2
    with pytest.raises(ValueError, match="x must start on a 16-byte"):
        cb.matmul_with_stats(x_off, w)
    with pytest.raises(ValueError, match="gy must start on a 16-byte"):
        fu.fused_backward(shifted(cots["gy"]), cots["gs"], cots["gss"], y,
                          x, w)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_autograd_functions_match_autograd_through_the_plain_ops(cuda, relu):
    """The two ``autograd.Function``s with the CUDA backward against
    ``backend="xla"`` (plain forward, plain backward) in float32, all six
    gradients, under random cotangents for y and both sums."""
    from resnet_tpu_torch.ops import fused_unit as fu
    x, w, bn, cots = _mm_inputs(cuda, 333, 72, 40, torch.float32, seed=2)

    def grads(backend):
        leaves = [t.clone().requires_grad_() for t in
                  (x, w.contiguous(), *bn.values())]
        out_a = fu.matmul_stats(leaves[0], leaves[1], backend)
        out_b = fu.norm_relu_matmul_stats(*leaves, 2e-5, relu, backend)
        loss = sum((o * c).sum() for out in (out_a, out_b)
                   for o, c in zip(out, cots.values()))
        return torch.autograd.grad(loss, leaves)

    for got, want in zip(grads("pallas"), grads("xla")):
        torch.testing.assert_close(got, want, rtol=1e-4,
                                   atol=1e-5 * float(want.abs().max()))


def test_chain_train_step_launches_the_kernels(cuda):
    """One train call of a small v1 bottleneck net (two stages of two
    units, kernel-sized widths) through the chain: per step K4f runs once
    for every conv1 and projection (4 + 2) and every conv3 (4), K4b once
    for each of them."""
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.resnet import ResNet
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    cfg = imagenet_resnet50()
    cfg.train.bn_ema = False
    cfg.train.unit_chain = "pallas"
    cfg.data.image_shape = (32, 32, 3)
    model = ResNet(units=(2, 2), filters=(32, 64, 128), num_classes=1000,
                   bottleneck=True, stem_s2d=True, dtype=torch.bfloat16,
                   unit_chain="pallas")
    state = create_train_state(cfg, device=cuda, model=model)
    step = make_train_step(augment_fn=make_augment_fn(cfg),
                           steps_per_dispatch=2)
    batch = {"image": torch.randint(0, 256, (2, 8, 40, 48, 3),
                                    dtype=torch.uint8, device=cuda),
             "label": torch.randint(0, 1000, (2, 8), device=cuda)}
    wrappers = (fu.matmul_stats, fu.norm_relu_matmul_stats, fu.fused_backward)
    before = [w.launches for w in wrappers]
    state, m = step(state, batch)
    torch.cuda.synchronize()
    assert [w.launches - b for w, b in zip(wrappers, before)] == [12, 8, 20]
    assert state.step == 2 and torch.isfinite(m["loss_sum"])


# ---------------------------------------------------------------------------
# K5, the BatchNorm backward's sum pair (csrc/bn_sums.cu), and the probes
# ---------------------------------------------------------------------------

# one block with idle row lanes; C = 200 (25 threads a row, 6 idle threads)
# with ragged rows over several splits; C = 4096, two blocks across a row
K5_SHAPES = [(37, 64), (5000, 200), (1500, 4096)]


def _k5_inputs(device, m, c, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    gy = torch.randn(m, c, generator=g).to(dtype)
    x = torch.randn(m, c, generator=g).to(dtype)
    mean = torch.randn(c, generator=g) * 0.2
    inv = 0.5 + 1.5 * torch.rand(c, generator=g)
    return tuple(t.to(device) for t in (gy, x, mean, inv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", K5_SHAPES, ids=str)
def test_bn_sums_kernel_matches_plain_version(cuda, shape, dtype):
    """Each sum within 1e-5 of the sum of its terms' magnitudes per column
    (float32 sums in another order), and the same bits on a second run."""
    from resnet_tpu_torch.tools import reduce_probe as rp
    args = _k5_inputs(cuda, *shape, dtype)
    before = rp.cuda_sums.launches
    got = rp.cuda_sums(*args)
    torch.cuda.synchronize()
    assert rp.cuda_sums.launches == before + 1
    want = rp.torch_sums(*args)
    for g, w, bound in zip(got, want, rp.sum_bounds(*args)):
        assert g.dtype == torch.float32 and tuple(g.shape) == (shape[1],)
        assert bool(((g - w).abs() <= bound).all()), \
            float(((g - w).abs() / bound).max())
    again = rp.cuda_sums(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_bn_sums_wrapper_rejects_bad_input(cuda):
    from resnet_tpu_torch.tools import reduce_probe as rp
    gy, x, mean, inv = _k5_inputs(cuda, 64, 32, torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 8"):
        rp.cuda_sums(gy[:, :12].contiguous(), x[:, :12].contiguous(),
                     mean[:12].contiguous(), inv[:12].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        rp.cuda_sums(gy[::2], x[::2], mean, inv)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        rp.cuda_sums(gy.half(), x.half(), mean, inv)


def test_reduce_probe_check_prints_parity_ok(cuda, capsys):
    from resnet_tpu_torch.tools import reduce_probe as rp
    assert rp.main(["--check"]) == 0
    assert "parity ok" in capsys.readouterr().out


def test_trace_probe_reads_the_cards_kernel_events(cuda, tmp_path, capsys):
    """A small program of the trace probe on the card: its chrome trace
    holds kernel events, the augmentation kernel among them, once a
    step."""
    from resnet_tpu_torch.tools import trace_probe as tp
    tp.trace_train_step(steps=2, warmup=1, batch_size=8, depth=18,
                        logdir=str(tmp_path), device=cuda, image_side=64)
    summary = tp.parse_trace(str(tmp_path), top=1000, steps=2)
    assert summary is not None and summary["ms_per_step"] > 0
    assert "fused_crop_mirror_normalize_kernel" in summary["groups"]
    k1 = [e for e in summary["top"] if "fused_crop_mirror" in e["name"]]
    assert k1 and k1[0]["count"] == 2


# -- the training entry point's card paths ----------------------------------

def test_prefetch_yields_device_batches_equal_to_the_host(cuda, monkeypatch):
    from resnet_tpu_torch.data.prefetch import (prefetch_grouped,
                                                prefetch_to_device)
    recorded = []
    record_stream = torch.Tensor.record_stream

    def spy(self, stream):
        recorded.append(stream)
        return record_stream(self, stream)
    monkeypatch.setattr(torch.Tensor, "record_stream", spy)
    rng = np.random.default_rng(0)
    host = [{"image": rng.integers(0, 256, (4, 8, 8, 3), np.uint8),
             "label": rng.integers(0, 9, 4).astype(np.int32)}
            for _ in range(5)]
    single = list(prefetch_to_device(iter(host), size=2, device=cuda))
    grouped = list(prefetch_grouped(iter(host), 2, size=2, device=cuda))
    assert [n for _, n in grouped] == [2, 2, 1]
    torch.cuda.synchronize()
    for got, want in zip(single, host):
        for k in want:
            assert got[k].is_cuda
            np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    for (got, n), i in zip(grouped, (0, 2, 4)):
        for k in host[0]:
            want = (np.stack([b[k] for b in host[i:i + n]]) if n > 1
                    else host[i][k])
            np.testing.assert_array_equal(got[k].cpu().numpy(), want)
    # every tensor handed out is tied to the consuming stream
    assert len(recorded) == 2 * (5 + 3)
    assert all(s == torch.cuda.current_stream() for s in recorded)


def _small_fit_cfg(prefix):
    from resnet_tpu_torch.config import imagenet_resnet50
    cfg = imagenet_resnet50()
    cfg.model.depth = 18
    cfg.data.image_shape, cfg.data.num_classes = (64, 64, 3), 10
    cfg.data.num_examples, cfg.data.pipeline = 64, "memory"
    cfg.train.batch_size, cfg.train.steps_per_dispatch = 16, 2
    cfg.train.num_epochs, cfg.train.bn_ema_warmup = 1, 2
    cfg.train.model_prefix, cfg.train.frequent = prefix, 2
    return cfg


def test_two_dispatch_fit_runs_on_the_card_with_k1(cuda, tmp_path):
    from resnet_tpu_torch.data.loader import make_train_iter, make_val_iter
    from resnet_tpu_torch.train.solver import Solver
    cfg = _small_fit_cfg(str(tmp_path / "r18"))
    before = fused_crop_mirror_normalize.launches
    solver = Solver(cfg)
    state = solver.fit(make_train_iter(cfg), make_val_iter(cfg))
    assert solver.device.type == "cuda" and state.step == 4
    assert fused_crop_mirror_normalize.launches - before == 4
    assert np.isfinite(solver.last_train_metrics["cross-entropy"])
    assert all(m.is_cuda for m in state.momentum)


def test_checkpoint_restores_momentum_and_step_on_the_card(cuda, tmp_path):
    from resnet_tpu_torch.train import checkpoint as ckpt
    from resnet_tpu_torch.train.state import create_train_state
    cfg = _small_fit_cfg(str(tmp_path / "ck"))
    state = create_train_state(cfg)
    for i, m in enumerate(state.momentum):
        m.fill_(i * 0.5 + 0.25)
    state.step = 17
    ckpt.save_checkpoint(cfg.train.model_prefix, 3, state,
                         iter_state={"epoch": 3, "batch": 5})
    payload = torch.load(f"{cfg.train.model_prefix}/3.pt", map_location="cpu",
                         weights_only=True)
    assert payload["step"] == 17 and payload["iter_state"]["batch"] == 5
    fresh = create_train_state(cfg)
    fresh, iter_state = ckpt.load_checkpoint(cfg.train.model_prefix, 3, fresh)
    assert fresh.step == 17 and iter_state == {"epoch": 3, "batch": 5}
    for a, b in zip(fresh.momentum, state.momentum):
        assert a.is_cuda and torch.equal(a, b)


def test_augment_impl_xla_takes_the_plain_version(cuda):
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    canvas, _ = _inputs(cuda, hc=64, wc=64)
    outs = {}
    for impl in ("auto", "xla"):
        cfg = imagenet_resnet50()
        cfg.data.image_shape, cfg.train.dtype = (32, 32, 3), "float32"
        cfg.data.augment_impl = impl
        before = fused_crop_mirror_normalize.launches
        gen = torch.Generator(device=cuda).manual_seed(0)
        outs[impl] = make_augment_fn(cfg)(canvas, gen)
        outs[impl + " launches"] = fused_crop_mirror_normalize.launches - before
    assert outs["auto launches"] == 1 and outs["xla launches"] == 0
    # the same sampled values through the kernel and its plain version
    torch.testing.assert_close(outs["auto"], outs["xla"], rtol=1e-4,
                               atol=5e-2)


# ---------------------------------------------------------------------------
# the model family and the augmentation variants on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_mode_of_the_kernel_matches_plain_version(cuda, dtype):
    """K1 in the split mode (identity normalization, no photometric
    flags, float32 out) against its plain version; then the split
    augmenter against the fused one on the same rows."""
    from resnet_tpu_torch.ops.augment_fused import augment_imagenet_fused
    canvas, rows = _inputs(cuda)
    args = (canvas, rows, (32, 32), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0),
            torch.float32)
    for s2d in (False, True):
        got = fused_crop_mirror_normalize(*args, s2d=s2d)
        want = fused_crop_mirror_normalize_reference(*args, s2d=s2d)
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
        d = DataConfig(max_random_contrast=0.3, max_random_illumination=20.0)
        before = fused_crop_mirror_normalize.launches
        outs = [augment_imagenet_fused(canvas, None, d, (32, 32), dtype,
                                       s2d=s2d, rows=rows, split=split)
                for split in (True, False)]
        assert fused_crop_mirror_normalize.launches == before + 2
        rtol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(outs[0].float(), outs[1].float(),
                                   atol=5e-2, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("merge", [1, 2, 8])
def test_block_diagonal_conv_matches_grouped_conv(cuda, merge, dtype):
    """The block-diagonal lowering against cuDNN's grouped convolution at
    G=8: outputs and the weight's gradient."""
    from resnet_tpu_torch.models.resnet import Conv, GroupedConvDense
    g = torch.Generator().manual_seed(merge)
    x = torch.randn(4, 64, 14, 14, generator=g).to(cuda).contiguous(
        memory_format=torch.channels_last)
    w = torch.randn(64, 8, 3, 3, generator=g) * 0.2
    dy = torch.randn(4, 64, 7, 7, generator=g).to(cuda)
    outs = []
    for mod in (GroupedConvDense(64, 64, 3, 2, 1, 8, merge, dtype=dtype),
                Conv(64, 64, 3, 2, 1, dtype=dtype, groups=8)):
        mod = mod.to(cuda)
        with torch.no_grad():
            mod.weight.copy_(w)
        y = mod(x)
        y.backward(dy.to(dtype))
        outs.append((y.float(), mod.weight.grad))
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else \
        dict(atol=5e-2, rtol=2.0 ** -6)
    torch.testing.assert_close(outs[0][0], outs[1][0], **tol)
    torch.testing.assert_close(outs[0][1], outs[1][1],
                               **({"atol": 1e-3, "rtol": 1e-4}
                                  if dtype == torch.float32 else
                                  {"atol": 0.5, "rtol": 2.0 ** -5}))


def test_mask_pool_backward_matches_cpu(cuda):
    from resnet_tpu_torch.ops.pool import stem_max_pool
    g = torch.Generator().manual_seed(1)
    x = torch.relu(torch.randn(2, 4, 9, 10, generator=g))
    x[0, :, :4, :4] = 0.5
    dy = torch.randn(2, 4, 5, 5, generator=g)
    grads = []
    for dev in ("cpu", cuda):
        xd = x.to(dev).contiguous(memory_format=torch.channels_last)
        xd.requires_grad_()
        stem_max_pool(xd, "mask").backward(dy.to(dev))
        grads.append(xd.grad.cpu())
    torch.testing.assert_close(grads[1], grads[0], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("remat", [dict(remat=True),
                                   dict(remat_policy="conv")],
                         ids=["remat", "policy_conv"])
def test_remat_step_equals_the_plain_step(cuda, remat):
    """One bn-ema ResNeXt train step with remat against the same step
    without: gradients equal, running statistics refreshed once."""
    from resnet_tpu_torch.models.resnet import ResNet
    kw = dict(units=(1, 1, 1, 1), filters=(8, 16, 32, 64, 128),
              num_classes=10, bottleneck=True, cardinality=4,
              group_width=8, grouped_dense=True, grouped_merge=2,
              bn_ema=True, stem_s2d=True)
    torch.manual_seed(0)
    base = ResNet(**kw).to(cuda, memory_format=torch.channels_last)
    other = ResNet(**kw, **remat).to(cuda, memory_format=torch.channels_last)
    other.load_state_dict(base.state_dict())
    x = torch.randn(8, 32, 32, 12, device=cuda)
    for m in (base, other):
        m.train()
        m(x).square().mean().backward()
    for (n, p), (_, q) in zip(base.named_parameters(),
                              other.named_parameters()):
        torch.testing.assert_close(q.grad, p.grad, atol=1e-5, rtol=1e-5,
                                   msg=n)
    for (n, b), (_, c) in zip(base.named_buffers(), other.named_buffers()):
        assert torch.equal(b, c), n


def test_rotate_images_on_the_card_matches_cpu(cuda):
    from resnet_tpu_torch.ops.augment import rotate_images
    g = torch.Generator().manual_seed(2)
    images = torch.randint(0, 256, (8, 64, 80, 3), generator=g,
                           dtype=torch.uint8)
    angles = (torch.rand(8, generator=g) - 0.5) * 0.6
    shears = (torch.rand(8, generator=g) - 0.5) * 0.4
    want = rotate_images(images, angles, shears)
    got = rotate_images(images.to(cuda), angles.to(cuda), shears.to(cuda))
    torch.testing.assert_close(got.cpu(), want, atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("dp_mode", ["shard_map", "jit"])
def test_world_size_1_nccl_step_equals_the_plain_step(cuda, dp_mode,
                                                      monkeypatch):
    """One rank joined over NCCL: the data-parallel step (its reductions
    over one rank, its weights exactly 1) equals the plain step from the
    same seeded state bit for bit, on deterministic cuDNN."""
    import torch.distributed as dist
    from resnet_tpu_torch.config import cifar10_resnet18
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.parallel.dist import (maybe_init_distributed,
                                                world_group)
    from resnet_tpu_torch.tools.launch import ENV_KEYS, free_port
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    for key, value in zip(ENV_KEYS, (f"127.0.0.1:{free_port()}", "1", "0")):
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    assert maybe_init_distributed()
    try:
        assert dist.get_backend() == "nccl"
        group = world_group()
        cfg = cifar10_resnet18()
        cfg.model.depth, cfg.train.batch_size = 8, 16
        g = torch.Generator(device=cuda).manual_seed(0)
        batch = {"image": torch.randint(0, 256, (16, 32, 32, 3), generator=g,
                                        device=cuda, dtype=torch.uint8),
                 "label": torch.randint(0, 10, (16,), generator=g,
                                        device=cuda)}
        runs = []
        for dp in (False, True):
            state = create_train_state(
                cfg, device=cuda,
                bn_group=group if dp and dp_mode == "jit" else None)
            step = make_train_step(augment_fn=make_augment_fn(cfg),
                                   group=group if dp else None,
                                   dp_mode=dp_mode)
            runs.append(step(state, batch))
        (plain, m_plain), (st, m) = runs
        for k in m:
            assert torch.equal(m[k], m_plain[k]), k
        for a, b in zip([*st.model.parameters(), *st.momentum,
                         *st.model.buffers()],
                        [*plain.model.parameters(), *plain.momentum,
                         *plain.model.buffers()]):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def _serving_case(tmp_path, dtype="bfloat16"):
    """The imagenet_resnet50 preset at depth 18, 64x64, random weights from
    its seed, and a symbolic-batch artifact written from its CPU copy."""
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.utils.serving import export_serving
    cfg = imagenet_resnet50()
    cfg.model.depth, cfg.train.dtype = 18, dtype
    cfg.data.num_classes, cfg.data.image_shape = 10, (64, 64, 3)
    model = get_model(cfg)
    prefix = str(tmp_path / "serve")
    export_serving(cfg, model, prefix)
    return cfg, model, prefix


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_written_artifact_serves_on_the_card_at_any_batch(cuda, tmp_path,
                                                             dtype):
    from resnet_tpu_torch.utils.serving import load_serving, make_serving_fn
    cfg, model, prefix = _serving_case(tmp_path, dtype)
    serve, manifest = load_serving(prefix)          # device=None: the card
    assert manifest["platforms"] == ["cpu", "cuda"]
    live = make_serving_fn(cfg, model.to(cuda, memory_format=torch.channels_last))
    x = torch.randint(0, 256, (7, 64, 64, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(0)).to(cuda)
    for b in (1, 7):
        got = serve(x[:b])
        with torch.inference_mode():
            want = live(x[:b])
        assert got.device.type == "cuda" and got.dtype == torch.float32
        assert got.shape == (b, 10)
        torch.testing.assert_close(got, want, atol=1e-3, rtol=1e-3)
    # the same file on the CPU gives the CPU module's logits
    cpu_serve, _ = load_serving(prefix, device="cpu")
    assert cpu_serve(x[:1].cpu()).device.type == "cpu"


def test_two_device_artifact_needs_two_cards(cuda, tmp_path):
    from resnet_tpu_torch.utils.serving import export_serving, load_serving
    cfg, model, _ = _serving_case(tmp_path)
    export_serving(cfg, model, str(tmp_path / "two"), num_devices=2)
    if torch.cuda.device_count() >= 2:
        serve, _ = load_serving(str(tmp_path / "two"))
        assert serve(torch.zeros(4, 64, 64, 3, dtype=torch.uint8)).shape \
            == (4, 10)
    else:
        with pytest.raises(ValueError, match="exported for 2 devices"):
            load_serving(str(tmp_path / "two"))


def test_backend_options_switch_the_cards_float32_convolutions(cuda):
    """``--xla-opts tf32=0`` makes a float32 convolution on the card agree
    with the CPU's to float32 rounding; ``tf32=1`` lets cuDNN take TF32
    (about three decimal digits); each setting is put back."""
    from resnet_tpu_torch.utils.xla_opts import (apply_backend_options,
                                                 compiler_options)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 64, 28, 28, generator=g)
    w = torch.randn(64, 64, 3, 3, generator=g)
    want = torch.nn.functional.conv2d(x, w, padding=1)
    before = (torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    errs = {}
    for tf32 in ("0", "1"):
        restore = apply_backend_options(
            compiler_options(f"tf32={tf32}", backend="cuda"))
        try:
            assert torch.backends.cudnn.benchmark is True   # the default
            assert torch.backends.cudnn.allow_tf32 is (tf32 == "1")
            got = torch.nn.functional.conv2d(x.to(cuda), w.to(cuda),
                                             padding=1)
            errs[tf32] = float((got.cpu() - want).abs().max()
                               / want.abs().max())
        finally:
            restore()
        assert (torch.backends.cudnn.benchmark,
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == before
    assert errs["0"] < 1e-5, errs
    assert errs["1"] < 1e-2, errs


def test_bench_input_quick_runs_both_legs_through_k1(cuda, capsys):
    """``bench_input --quick`` on the card: ResNet-18 at 64x64 bs16 over
    128 records; K1 launches once a step: 2 warm-up steps, 1 on the pool,
    8 a leg."""
    import json
    from resnet_tpu_torch.tools import bench_input
    before = fused_crop_mirror_normalize.launches
    assert bench_input.main(["--quick"]) == 0
    assert fused_crop_mirror_normalize.launches - before == 3 + 2 * 8
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["decoder"] in ("native", "python")
    assert rec["step_ms_device_data"] > 0 and rec["step_ms_end_to_end"] > 0
    assert rec["cores_needed_for_device_rate"] > 0
