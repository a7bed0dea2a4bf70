"""The port's fused 1x1-conv ops against the JAX package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as its own tests do
(tests/test_fused_convbn.py, test_fused_chain.py, test_fused_unit.py); the
port's wrappers take their plain PyTorch versions because the tensors lie on
the CPU. Inputs and cotangents are numpy arrays from a seed, handed to both.

Tolerances. float64: rtol 1e-9 (observed: agreement to 1e-13 or better; the
two sides differ by summation order only). float32: rtol 1e-5 (observed
below 3e-6). Each bound is relative to the largest magnitude of the array
compared (``atol = rtol * max|want|``): an entry of a sum over hundreds of
random terms can land near zero, where a bound relative to the entry itself
measures nothing.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.ops import fused_chain as jfc
from resnet_tpu.ops import fused_convbn as jcb
from resnet_tpu.ops import fused_unit as jfu
from resnet_tpu_torch.ops import fused_chain as fc
from resnet_tpu_torch.ops import fused_convbn as cb
from resnet_tpu_torch.ops import fused_unit as fu

RTOL = {"float32": 1e-5, "float64": 1e-9}
DTYPES = ["float32", "float64"]


@contextlib.contextmanager
def _precision(dtype):
    """jax_enable_x64 for the float64 cases only, restored afterwards: a
    global flip would leak into every other test of the worker."""
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", dtype == "float64")
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _close(got, want, rtol, name=""):
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def _normal(rng, shape, dtype, scale=1.0):
    return (rng.normal(0, 1, shape) * scale).astype(dtype)


def _bn_vectors(rng, k, dtype):
    return (_normal(rng, (k,), dtype, 0.2),                    # mean
            (np.abs(rng.normal(0, 1, (k,))) + 0.5).astype(dtype),   # var
            (1.0 + 0.1 * rng.normal(0, 1, (k,))).astype(dtype),     # gamma
            _normal(rng, (k,), dtype, 0.1))                    # beta


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# fused_convbn: matmul_with_stats, conv1x1_bn_stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m", [384, 135], ids=["m384", "m135-no-tile-divides"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_with_stats_matches_jax(dtype, m):
    rng = np.random.default_rng(0)
    x, w = _normal(rng, (m, 64), dtype), _normal(rng, (64, 128), dtype)
    with _precision(dtype):
        want = jcb.matmul_with_stats(jnp.asarray(x), jnp.asarray(w),
                                     interpret=True)
        want = [np.asarray(v) for v in want]
    got = cb.matmul_with_stats(_t(x), _t(w))
    assert got[0].dtype == _t(x).dtype
    for name, g, r in zip(("y", "sum", "sumsq"), got, want):
        _close(g, r, RTOL[dtype], name)


@pytest.mark.parametrize("dtype", DTYPES)
def test_conv1x1_bn_stats_forward_and_vjp_match_jax(dtype):
    rng = np.random.default_rng(1)
    x, w = _normal(rng, (96, 32), dtype), _normal(rng, (32, 16), dtype)

    def jloss(f):
        def loss(x, w):
            y, mean, var = f(x, w)
            return (jnp.sum(jnp.sin(y)) + jnp.sum(mean * 3.0)
                    + jnp.sum(jnp.sqrt(var + 1.0)))
        return loss

    with _precision(dtype):
        jx, jw = jnp.asarray(x), jnp.asarray(w)
        want_out = [np.asarray(v) for v in jcb.conv1x1_bn_stats(jx, jw, True)]
        want = [np.asarray(g) for g in jax.grad(
            jloss(lambda a, b: jcb.conv1x1_bn_stats(a, b, True)),
            argnums=(0, 1))(jx, jw)]
    for f in (cb.conv1x1_bn_stats, cb.reference_conv1x1_bn_stats):
        tx, tw = _t(x, True), _t(w, True)
        y, mean, var = f(tx, tw)
        for name, g, r in zip(("y", "mean", "var"), (y, mean, var), want_out):
            _close(g, r, RTOL[dtype], f"{f.__name__} {name}")
        (torch.sin(y).sum() + (mean * 3.0).sum()
         + torch.sqrt(var + 1.0).sum()).backward()
        _close(tx.grad, want[0], RTOL[dtype], f"{f.__name__} dx")
        _close(tw.grad, want[1], RTOL[dtype], f"{f.__name__} dw")


def test_conv1x1_bn_stats_unused_outputs_read_as_zero_cotangents():
    rng = np.random.default_rng(2)
    x, w = _t(_normal(rng, (40, 16), "float32"), True), \
        _t(_normal(rng, (16, 8), "float32"), True)
    y, _, _ = cb.conv1x1_bn_stats(x, w)
    y.sum().backward()
    _close(x.grad, np.broadcast_to(w.detach().numpy().sum(1), (40, 16)),
           1e-6)


# ---------------------------------------------------------------------------
# fused_chain: normalized_matmul_with_stats (forward only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_normalized_matmul_with_stats_matches_jax(relu):
    rng = np.random.default_rng(3)
    x = _normal(rng, (256, 64), "float32", 2.0)
    w = _normal(rng, (64, 128), "float32", 0.1)
    mean = _normal(rng, (64,), "float32")
    var = rng.uniform(0.5, 2, (64,)).astype(np.float32)
    gamma = (1 + 0.1 * rng.normal(0, 1, (64,))).astype(np.float32)
    beta = _normal(rng, (64,), "float32", 0.1)
    args = (x, w, mean, var, gamma, beta)
    want = jfc.normalized_matmul_with_stats(
        *map(jnp.asarray, args), relu=relu, bm=64, bn=128, interpret=True)
    targs = tuple(map(_t, args))
    for f in (fc.normalized_matmul_with_stats, fc.reference_chain):
        got = f(*targs, relu=relu)
        for name, g, r in zip(("y", "sum", "sumsq"), got, want):
            _close(g, np.asarray(r), 1e-5, f"{f.__name__} {name}")


# ---------------------------------------------------------------------------
# fused_unit: op A and op B, forward and every gradient
# ---------------------------------------------------------------------------

def _weighted(outs, cots, xp):
    return sum(xp.sum(o * c) for o, c in zip(outs, cots))


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_stats_forward_and_vjp_match_jax(dtype, backend):
    rng = np.random.default_rng(4)
    x, w = _normal(rng, (72, 8), dtype), _normal(rng, (8, 16), dtype)
    cots = [_normal(rng, s, dtype) for s in ((72, 16), (16,), (16,))]
    with _precision(dtype):
        jx, jw = jnp.asarray(x), jnp.asarray(w)
        jcots = list(map(jnp.asarray, cots))
        want_out = [np.asarray(v) for v in
                    jfu.matmul_stats(jx, jw, "pallas", True)]
        want = [np.asarray(g) for g in jax.grad(
            lambda a, b: _weighted(jfu.matmul_stats(a, b, "pallas", True),
                                   jcots, jnp), argnums=(0, 1))(jx, jw)]
    tx, tw = _t(x, True), _t(w, True)
    out = fu.matmul_stats(tx, tw, backend)
    for name, g, r in zip(("y", "sum", "sumsq"), out, want_out):
        _close(g, r, RTOL[dtype], name)
    _weighted(out, list(map(_t, cots)), torch).backward()
    _close(tx.grad, want[0], RTOL[dtype], "dx")
    _close(tw.grad, want[1], RTOL[dtype], "dw")


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_norm_relu_matmul_stats_forward_and_vjp_match_jax(dtype, backend,
                                                          relu):
    rng = np.random.default_rng(5)
    x, w = _normal(rng, (48, 8), dtype), _normal(rng, (8, 24), dtype)
    args = (x, w, *_bn_vectors(rng, 8, dtype))
    cots = [_normal(rng, s, dtype) for s in ((48, 24), (24,), (24,))]
    with _precision(dtype):
        jargs = list(map(jnp.asarray, args))
        jcots = list(map(jnp.asarray, cots))
        op = lambda *a: jfu.norm_relu_matmul_stats(*a, 2e-5, relu, "pallas",
                                                   True)
        want_out = [np.asarray(v) for v in op(*jargs)]
        want = [np.asarray(g) for g in jax.grad(
            lambda *a: _weighted(op(*a), jcots, jnp),
            argnums=tuple(range(6)))(*jargs)]
    targs = [_t(a, True) for a in args]
    out = fu.norm_relu_matmul_stats(*targs, 2e-5, relu, backend)
    for name, g, r in zip(("y", "sum", "sumsq"), out, want_out):
        _close(g, r, RTOL[dtype], name)
    _weighted(out, list(map(_t, cots)), torch).backward()
    names = ("dx", "dw", "dmean", "dvar", "dgamma", "dbeta")
    for name, t, r in zip(names, targs, want):
        _close(t.grad, r, RTOL[dtype], f"{name} ({backend}, relu={relu})")


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "norelu"])
def test_kernel_functions_match_autograd_of_the_references(relu):
    """The hand-derived backward (both backends) against autograd through
    the port's own differentiable references, float64, rtol 1e-9."""
    rng = np.random.default_rng(6)
    args = (_normal(rng, (40, 8), "float64"), _normal(rng, (8, 16), "float64"),
            *_bn_vectors(rng, 8, "float64"))
    cots = [_t(_normal(rng, s, "float64")) for s in ((40, 16), (16,), (16,))]

    def grads(f, n):
        targs = [_t(a, True) for a in args[:n]]
        _weighted(f(*targs), cots, torch).backward()
        return [t.grad for t in targs]

    want_a = grads(fu.reference_matmul_stats, 2)
    want_b = grads(lambda *a: fu.reference_norm_relu_matmul_stats(
        *a, relu=relu), 6)
    for backend in fu.BACKENDS:
        for g, r in zip(grads(lambda *a: fu.matmul_stats(*a, backend), 2),
                        want_a):
            _close(g, r.numpy(), 1e-9, f"op A {backend}")
        for g, r in zip(grads(lambda *a: fu.norm_relu_matmul_stats(
                *a, 2e-5, relu, backend), 6), want_b):
            _close(g, r.numpy(), 1e-9, f"op B {backend}")


def test_bf16_statistics_come_from_the_float32_accumulator():
    """bf16 inputs: the kernels' column sums are those of the float32
    accumulator, not of the bf16 ``y`` that is stored. The port's plain
    version must side with the JAX kernel (interpret mode) and visibly not
    with the sums of the rounded output; ``backend="xla"`` and the
    references take them from the rounded output, as in the JAX package.
    Sums: rtol 1e-5 of their largest magnitude (float32 sums in another
    order, observed below 2e-6); y: equal up to one bf16 ulp (2^-7 relative)."""
    rng = np.random.default_rng(7)
    x32, w32 = _normal(rng, (512, 64), "float32"), \
        _normal(rng, (64, 32), "float32")
    jx, jw = jnp.asarray(x32, jnp.bfloat16), jnp.asarray(w32, jnp.bfloat16)
    want = [np.asarray(v, np.float32) for v in
            jfu.matmul_stats(jx, jw, "pallas", True)]
    tx, tw = _t(x32).bfloat16(), _t(w32).bfloat16()
    for got in (fu.matmul_stats(tx, tw, "pallas"),
                cb.matmul_with_stats(tx, tw)):
        assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
        np.testing.assert_allclose(got[0].float().numpy(), want[0],
                                   rtol=2.0 ** -7, atol=1e-6)
        _close(got[1], want[1], 1e-5, "sum")
        _close(got[2], want[2], 1e-5, "sumsq")
    rounded = fu.matmul_stats(tx, tw, "xla")
    jrounded = jfu.matmul_stats(jx, jw, "xla", True)
    _close(rounded[1], np.asarray(jrounded[1]), 1e-5, "xla sum")
    _close(rounded[2], np.asarray(jrounded[2]), 1e-5, "xla sumsq")
    # the two sources differ by far more than the bar above
    gap = np.abs(rounded[2].numpy() - want[2]).max() / np.abs(want[2]).max()
    assert gap > 1e-4, gap


def test_unknown_backend_raises():
    x = torch.zeros(8, 8)
    with pytest.raises(ValueError, match="backend"):
        fu.matmul_stats(x, x, "cuda")


def test_dw_splits_cover_every_row():
    from resnet_tpu_torch.ops.matmul_stats_cuda import DW_ROW_STEP, dw_plan
    for m, k, n in [(401408, 64, 64), (6272, 1024, 2048), (25088, 256, 1024),
                    (135, 8, 8), (1, 8, 8), (100352, 512, 128)]:
        _, splits, rows, _ = dw_plan(m, k, n)
        assert splits >= 1 and rows % DW_ROW_STEP == 0
        assert splits * rows >= m > (splits - 1) * rows
