"""The port's BatchNorm statistic modes against the JAX package's
``SubsampleBatchNorm``, and the registry's guards against the JAX
registry's.

Both sides get the same numpy input (N=8, C=4, 4x4, NHWC for flax and its
NCHW view for the port), the same scale, bias and running statistics, and
the same output cotangent. Outputs, refreshed running statistics and the
gradients of x, scale and bias agree at rtol/atol 1e-4: float32 sums in two
orders over as few as 8 values per channel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.config import Config as JaxConfig
from resnet_tpu.models.registry import get_model as jax_get_model
from resnet_tpu.models.resnet import SubsampleBatchNorm
from resnet_tpu_torch.config import Config
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.models.resnet import BatchNorm

EPS = 2e-5
# (subsample, grouped, stat_stride, ema, ema_clamp)
MODES = {
    "sub2": (2, False, 1, False, 1.0),
    "sub4": (4, False, 1, False, 1.0),
    "grouped2": (2, True, 1, False, 1.0),
    "grouped4": (4, True, 1, False, 1.0),
    "stride2": (1, False, 2, False, 1.0),
    "grouped2_stride2": (2, True, 2, False, 1.0),
    "ema_sub2": (2, False, 1, True, 1.0),
    "ema_sub4_clamp1.5": (4, False, 1, True, 1.5),
}
# bn-ema over the whole batch, which the kernels take
KERNEL_MODES = {
    "ema": (1, False, 1, True, 1.0),
    "ema_clamp2": (1, False, 1, True, 2.0),
    "ema_clamp0": (1, False, 1, True, 0.0),
}
MODES.update(KERNEL_MODES)


def _pair(mode, c=4):
    sub, grouped, stride, ema, clamp = MODES[mode]
    jm = SubsampleBatchNorm(momentum=0.9, epsilon=EPS, subsample=sub,
                            grouped=grouped, stat_stride=stride,
                            ema_normalize=ema, ema_clamp=clamp)
    bn = BatchNorm(c, momentum=0.9, eps=EPS, ema=ema, ema_clamp=clamp,
                   subsample=sub, grouped=grouped, stat_stride=stride)
    return jm, bn


def _data(n=8, seed=0, c=4):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    x = f32(rng.normal(0.5, 2.0, (n, 4, 4, c)))
    cot = f32(rng.normal(0, 1, (n, 4, 4, c)))
    params = {"scale": f32(1 + 0.2 * rng.normal(size=c)),
              "bias": f32(0.2 * rng.normal(size=c))}
    stats = {"mean": f32(0.5 + 0.3 * rng.normal(size=c)),
             "var": f32(4 * (np.abs(rng.normal(size=c)) + 0.5))}
    return x, cot, params, stats


def _load(bn, params, stats):
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))


def _close(got, want, name):
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4,
                               err_msg=name)


def _check_train_mode(mode, c=4):
    """One train-mode forward and backward of the port's module and of
    ``SubsampleBatchNorm`` on the same data; returns the port's module."""
    x, cot, params, stats = _data(c=c)
    jm, bn = _pair(mode, c)

    def loss_fn(xj, p):
        out, mut = jm.apply({"params": p, "batch_stats": stats}, xj,
                            use_running_average=False,
                            mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut["batch_stats"])

    (_, (want, want_stats)), (gx, gp) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(jnp.asarray(x), params)

    _load(bn, params, stats)
    bn.train()
    xt = torch.from_numpy(x).requires_grad_()
    out = bn(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), want, "output")
    _close(bn.running_mean.numpy(), want_stats["mean"], "running mean")
    _close(bn.running_var.numpy(), want_stats["var"], "running var")
    _close(xt.grad.numpy(), gx, "grad x")
    _close(bn.weight.grad.numpy(), gp["scale"], "grad scale")
    _close(bn.bias.grad.numpy(), gp["bias"], "grad bias")
    return bn


@pytest.mark.parametrize("mode", list(MODES))
def test_train_mode_matches_subsample_batchnorm(mode):
    _check_train_mode(mode)


@pytest.mark.parametrize("mode", list(KERNEL_MODES))
def test_kernel_path_matches_subsample_batchnorm(mode):
    """bn-ema over the whole batch at 8 channels: the NHWC input's NCHW
    view is channels-last, so the module runs ``ops/bn_ema.py``'s function
    (its plain versions on the CPU)."""
    before = BatchNorm.fused_forwards
    _check_train_mode(mode, c=8)
    assert BatchNorm.fused_forwards == before + 1


@pytest.mark.parametrize("mode", ["sub4", "grouped4", "stride2", "ema_sub2"])
def test_eval_mode_uses_the_running_statistics(mode):
    x, _, params, stats = _data(seed=1)
    jm, bn = _pair(mode)
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                    use_running_average=True)
    _load(bn, params, stats)
    bn.eval()
    with torch.no_grad():
        got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(got.numpy(), want, "eval output")
    # the running statistics are read, not refreshed
    np.testing.assert_array_equal(bn.running_mean.numpy(), stats["mean"])


def test_grouped_batch_not_divisible_by_groups_raises():
    x, _, params, stats = _data(n=6)
    jm, bn = _pair("grouped4")
    with pytest.raises(ValueError, match="not divisible by 4 groups"):
        jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                 use_running_average=False, mutable=["batch_stats"])
    _load(bn, params, stats)
    with pytest.raises(ValueError, match="not divisible by 4 groups"):
        bn.train()(torch.from_numpy(x).permute(0, 3, 1, 2))


def test_default_mode_keeps_the_full_batch_path():
    """subsample = stat_stride = 1 takes the whole batch: the same output,
    bit for bit, as the statistics written out over every image."""
    x, _, params, stats = _data(seed=2)
    bn = BatchNorm(4, eps=EPS)
    _load(bn, params, stats)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = bn.train()(xt)
    mean = xt.mean((0, 2, 3))
    var = ((xt * xt).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
    inv = torch.rsqrt(var + EPS) * bn.weight
    want = (xt - mean[:, None, None]) * inv[:, None, None] \
        + bn.bias[:, None, None]
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the registry's guards
# ---------------------------------------------------------------------------

# (train fields, message of the guard, or None where both registries build)
GUARDS = {
    "grouped_without_subsample": (dict(bn_grouped=True),
                                  "--bn-grouped needs --bn-subsample > 1"),
    "ema_with_grouped": (dict(bn_ema=True, bn_grouped=True, bn_subsample=8),
                         "--bn-ema does not compose"),
    "chain_with_subsample": (dict(unit_chain="pallas", bn_subsample=8),
                             "--unit-chain does not compose"),
    "chain_with_stat_stride": (dict(unit_chain="xla", bn_stat_stride=2),
                               "--unit-chain does not compose"),
    "grouped_subsample": (dict(bn_grouped=True, bn_subsample=8), None),
    "ema_subsample_stride": (dict(bn_ema=True, bn_subsample=8,
                                  bn_stat_stride=2), None),
    "fused_subsample": (dict(fused_convbn=True, bn_subsample=8), None),
}


@pytest.mark.parametrize("case", list(GUARDS))
def test_registry_guards_match_jax(case):
    fields, message = GUARDS[case]
    cfgs = (JaxConfig(), Config())
    for cfg in cfgs:
        cfg.model.depth = 18
        for name, value in fields.items():
            setattr(cfg.train, name, value)
    if message is None:
        jax_get_model(cfgs[0])
        model = get_model(cfgs[1])
        bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
        assert len(bns) == 21 and all(
            (b.subsample, b.grouped, b.stat_stride, b.ema)
            == (fields.get("bn_subsample", 1), fields.get("bn_grouped", False),
                fields.get("bn_stat_stride", 1), fields.get("bn_ema", False))
            for b in bns)
        return
    with pytest.raises(ValueError, match=message):
        jax_get_model(cfgs[0])
    with pytest.raises(ValueError, match=message):
        get_model(cfgs[1])
