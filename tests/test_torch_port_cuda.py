"""Tests of the port that need the CUDA card; each skips without one.

They import nothing of JAX, so they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py

The kernel is held against its plain PyTorch version (itself held against
the JAX kernel by tests/test_torch_port_augment.py), and the card's
max-pool backward against the CPU's tie routing.
"""

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
@pytest.mark.parametrize("shape", MM_SHAPES, ids=str)
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
@pytest.mark.parametrize("shape", MM_SHAPES, ids=str)
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
