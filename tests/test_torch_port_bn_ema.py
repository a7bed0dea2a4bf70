"""The bn-ema BatchNorm's kernel path (``ops/bn_ema.py``) on the CPU, where
``BatchNormEmaTrain`` runs the kernels' plain versions.

The plain versions are held against the eager bn-ema branch of
``BatchNorm._forward`` (the same module on the same input in standard NCHW
memory, which that branch takes): output, refreshed running statistics and
the gradients of x, weight and bias. float32 agrees within 1e-5, the order
of the sums being the only difference; a bf16 output or input gradient
within one bf16 ulp besides, where that difference moves a value across a
rounding boundary. Each mode the kernels do not take keeps the
eager code; the step shapes and the launch functions' C signatures are
held against the models and ``csrc/bn_sums.cu``.
"""

import copy
import re
from pathlib import Path

import pytest
import torch
import torch.distributed as dist
import torch.nn as nn

from resnet_tpu_torch import _build
from resnet_tpu_torch.config import imagenet_resnet50, imagenet_resnext50
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.models.resnet import BatchNorm, remat_unit
from resnet_tpu_torch.ops import bn_ema
from resnet_tpu_torch.tools import reduce_probe as rp
from resnet_tpu_torch.utils.op_count import fake_process_group

EPS = 2e-5
# float32: sums of up to 60 terms a channel in two orders, 1e-5 of the
# largest value (dx cancels its mean out of terms that size); bf16 besides
# one ulp (at most 2^-7 of the value) of a rounding that the float32
# difference can flip
F32_TOL = dict(rtol=1e-5, atol=1e-6)
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}


def _close(got, want, dtype):
    want = want.detach().float()
    torch.testing.assert_close(got.detach().float(), want, rtol=RTOL[dtype],
                               atol=1e-5 * float(want.abs().max()))


def _module(c, clamp, use_scale, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    bn = BatchNorm(c, eps=EPS, ema=True, ema_clamp=clamp,
                   use_scale=use_scale, dtype=dtype)
    with torch.no_grad():
        if use_scale:
            bn.weight.copy_(1 + 0.2 * torch.randn(c, generator=g))
        bn.bias.copy_(0.2 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.5 + 0.3 * torch.randn(c, generator=g))
        bn.running_var.copy_(4 * (torch.randn(c, generator=g).abs() + 0.5))
    return bn.train()


def _run(bn, x, cot):
    """Forward and backward of ``bn`` on a leaf copy of ``x``: (output,
    input gradient) in float32, the input's memory format kept."""
    x = x.detach().clone(memory_format=torch.preserve_format)
    x.requires_grad_()
    y = bn(x)
    (y.float() * cot).sum().backward()
    return y, x.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("c", [64, 256])
@pytest.mark.parametrize("use_scale", [True, False],
                         ids=["scale", "no_scale"])
@pytest.mark.parametrize("clamp", [1.0, 2.0, 0.0])
def test_plain_versions_match_the_eager_branch(clamp, use_scale, c, dtype):
    g = torch.Generator().manual_seed(1)
    x = (0.5 + 2.0 * torch.randn(4, c, 3, 5, generator=g)).to(dtype)
    cot = torch.randn(4, c, 3, 5, generator=g)
    fused = _module(c, clamp, use_scale, dtype)
    eager = copy.deepcopy(fused)
    counts = BatchNorm.fused_forwards, BatchNorm.eager_forwards
    got, gx = _run(fused, x.contiguous(memory_format=torch.channels_last),
                   cot)
    want, wx = _run(eager, x.contiguous(), cot)
    assert (BatchNorm.fused_forwards, BatchNorm.eager_forwards) == (
        counts[0] + 1, counts[1] + 1)
    assert got.dtype == want.dtype == dtype and gx.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    _close(got, want, dtype)
    _close(gx, wx, dtype)
    for name in ("running_mean", "running_var"):
        torch.testing.assert_close(getattr(fused, name),
                                   getattr(eager, name), **F32_TOL)
    torch.testing.assert_close(fused.bias.grad, eager.bias.grad, rtol=1e-5,
                               atol=1e-5)
    if use_scale:
        torch.testing.assert_close(fused.weight.grad, eager.weight.grad,
                                   rtol=1e-5, atol=1e-5)
    else:
        assert fused.weight is None


def _step(bn, x):
    bn(x).float().sum().backward()


def _eval(bn, x):
    _step(bn.eval(), x)


def _remat(bn, x):
    remat_unit(nn.Sequential(bn), x).float().sum().backward()


def _in_group(bn, x):
    with fake_process_group(1):
        bn.group = dist.group.WORLD
        try:
            _step(bn, x)
        finally:
            bn.group = None


def _standard_layout(bn, x):
    _step(bn, x.contiguous())


# mode -> (BatchNorm arguments, input channels, forward and backward, eager
# forwards it runs: remat's recomputation is one more)
EXCLUDED = {
    "eval": (dict(ema=True), 16, _eval, 1),
    "grouped": (dict(ema=False, grouped=True, subsample=2), 16, _step, 1),
    "subsample": (dict(ema=True, subsample=2), 16, _step, 1),
    "stride": (dict(ema=True, stat_stride=2), 16, _step, 1),
    "group": (dict(ema=True), 16, _in_group, 1),
    "remat": (dict(ema=True), 16, _remat, 2),
    "c3": (dict(ema=True), 3, _step, 1),
    "batch_statistics": (dict(ema=False), 16, _step, 1),
    "standard_layout": (dict(ema=True), 16, _standard_layout, 1),
}


@pytest.mark.parametrize("mode", list(EXCLUDED))
def test_modes_the_kernels_do_not_take_run_the_eager_code(mode):
    kw, c, run, forwards = EXCLUDED[mode]
    bn = BatchNorm(c, eps=EPS, **kw).train()
    x = torch.randn(4, c, 4, 4).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    before = (BatchNorm.fused_forwards, BatchNorm.eager_forwards,
              bn_ema.cuda_sums.launches)
    run(bn, x)
    assert (BatchNorm.fused_forwards, BatchNorm.eager_forwards) == (
        before[0], before[1] + forwards)
    assert bn_ema.cuda_sums.launches == before[2]
    assert x.grad is not None and torch.isfinite(x.grad).all()


def test_kernel_path_saves_x_as_it_came_and_no_float32_copy():
    """The function keeps the bf16 input itself for its backward (and its
    (3, C) float32 vectors), where the eager branch kept a float32 copy of
    it."""
    bn = _module(16, 1.0, True, torch.bfloat16)
    x = torch.randn(4, 16, 4, 4).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    saved = []

    def pack(t):
        saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        bn(x)
    big = [t for t in saved if t.numel() == x.numel()]
    assert len(big) == 1 and big[0].dtype == torch.bfloat16
    assert big[0].data_ptr() == x.data_ptr()
    assert [(tuple(t.shape), t.dtype) for t in saved
            if t.numel() != x.numel()] == [((3, 16), torch.float32)]


@pytest.mark.parametrize("model", sorted(rp.STEP_SHAPES))
def test_step_shapes_are_the_models_batchnorm_inputs(model):
    """``STEP_SHAPES`` (the timing and card tests' (M, C) at batch 256)
    against the BatchNorm inputs of one CPU forward of the preset's model;
    each shape's splits cover its rows with a few blocks an SM."""
    cfg = {"resnet50": imagenet_resnet50,
           "resnext50": imagenet_resnext50}[model]()
    net = get_model(cfg).train()
    seen = {}

    def hook(mod, inputs):
        n, c, h, w = inputs[0].shape
        key = (256 // n * n * h * w, c)
        seen[key] = seen.get(key, 0) + 1

    bns = [m for m in net.modules() if isinstance(m, BatchNorm)]
    handles = [m.register_forward_pre_hook(hook) for m in bns]
    try:
        with torch.no_grad():
            net(torch.zeros((1, 224, 224, 3), dtype=torch.uint8))
    finally:
        for h in handles:
            h.remove()
    assert len(bns) == 53 and seen == rp.STEP_SHAPES[model]
    for m, c in seen:
        splits, rows = bn_ema.sum_splits(m, c)
        assert splits * rows >= m > (splits - 1) * rows
        assert splits * -(-c // (bn_ema.COLS * bn_ema.BLOCK_THREADS)) \
            >= 2 * 132


_KINDS = {"void*": _build.ctypes.c_void_p, "int": _build.ctypes.c_int,
          "float": _build.ctypes.c_float}


def _c_signatures(source: Path):
    """``extern "C"`` function name -> its parameters' ctypes, read from a
    kernel source (every pointer a ``void*``)."""
    text = re.sub(r"//[^\n]*", "", source.read_text())
    out = {}
    for name, params in re.findall(
            r'extern "C" int (\w+)\(([^)]*)\)', text):
        kinds = []
        for p in params.split(","):
            p = " ".join(p.split())
            kind = "void*" if "*" in p else p.rsplit(" ", 1)[0]
            kinds.append(_KINDS[kind.replace("const ", "")])
        out[name] = kinds
    return out


def test_launch_signatures_match_the_kernel_source():
    declared = {fn: argtypes for fn, (argtypes, _)
                in _build.SIGNATURES["bn_sums"].items()}
    assert _c_signatures(_build.CSRC / "bn_sums.cu") == declared


def test_kernel_wrappers_on_cpu_tensors_launch_nothing():
    """On CPU tensors the wrappers are their plain versions: the function
    runs them and launches no kernel."""
    wrappers = (bn_ema.cuda_sums, bn_ema.bn_ema_forward,
                bn_ema.bn_ema_backward)
    launches = [f.launches for f in wrappers]
    bn = _module(8, 1.0, True, torch.float32)
    _run(bn, torch.randn(2, 8, 3, 3).contiguous(
        memory_format=torch.channels_last), torch.randn(2, 8, 3, 3))
    assert launches == [f.launches for f in wrappers]
