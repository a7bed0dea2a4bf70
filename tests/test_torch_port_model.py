"""The port's ResNet against the JAX package's, through the weight bridge.

Both sides build a tiny v1 ResNet directly from ``ResNet(...)`` (one unit
per stage, narrow filters, 10 classes); the JAX variables are randomized
(as tests/test_torch_oracle.py does, so transposed layouts or mean/var
mix-ups cannot hide behind symmetric init values), exported as the MXNet
name table by the JAX package's own ``export_mxnet_params`` and loaded
into the port by its ``load_mxnet_params``. Inputs are numpy from a seed.
float32 comparisons hold at rtol/atol 1e-4: the two frameworks sum
convolutions and BN statistics in different orders.
"""

from functools import partial

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from resnet_tpu.models.resnet import ResNet as JaxResNet
from resnet_tpu.ops.metrics import cross_entropy_loss as jax_ce
from resnet_tpu.utils.export import export_mxnet_params as jax_export
from resnet_tpu_torch.models.resnet import ResNet
from resnet_tpu_torch.ops.metrics import cross_entropy_loss
from resnet_tpu_torch.utils.export import (_tensors, export_mxnet_params,
                                           load_mxnet_params)

UNITS = (1, 1, 1, 1)
FILTERS = {True: (8, 16, 32, 64, 128), False: (8, 8, 16, 32, 64)}
LABELS = np.array([1, 7, 3, 0, 9, 2, 5, 4])
# train mode: 8 pre-blocked 32x32 inputs leave 8*2*2 values per channel for
# the last stage's BN statistics; with fewer, E[x^2] - mean^2 cancels badly
# enough in float32 that the two summation orders part beyond 1e-4
TRAIN_X = (8, 32, 32, 12)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _randomize(variables, seed=0):
    """Random values for every variable; kernels keep the MSRA scale
    (HWIO fan-in) so that activations stay of order 1 through the net."""
    rng = np.random.default_rng(seed)

    def rand(path, leaf):
        keys = "/".join(str(getattr(k, "key", k)) for k in path)
        a = rng.normal(0, 0.5, leaf.shape)
        if keys.endswith("kernel"):
            a = a * np.sqrt(8.0 / np.prod(leaf.shape[:-1]))
        elif keys.endswith("var"):
            a = np.abs(a) + 0.5
        elif keys.endswith("mean"):
            a = a * 0.2
        return jnp.asarray(a, leaf.dtype)

    return jax.tree_util.tree_map_with_path(rand, variables)


def _pair(x, bottleneck=True, stem_s2d=True, bn_ema=False,
          dtype=(jnp.float32, torch.float32), **bn_modes):
    """(jax module, jax variables, port model) with one set of weights;
    ``bn_modes``: ``bn_subsample``, ``bn_grouped``, ``bn_stat_stride``."""
    kw = dict(units=UNITS, filters=FILTERS[bottleneck], num_classes=10,
              bottleneck=bottleneck, bn_ema=bn_ema, stem_s2d=stem_s2d,
              **bn_modes)
    jm = JaxResNet(dtype=dtype[0], **kw)
    shapes = jax.eval_shape(partial(jm.init, train=False),
                            jax.random.key(0), jnp.asarray(x))
    variables = _randomize(shapes)
    model = ResNet(dtype=dtype[1], **kw).to(memory_format=torch.channels_last)
    load_mxnet_params(model, *jax_export(variables["params"],
                                         variables["batch_stats"]))
    return jm, variables, model


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def test_bridge_round_trip_is_exact():
    jm, variables, model = _pair(_x((4, 16, 16, 12)))
    args, auxs = jax_export(variables["params"], variables["batch_stats"])
    got_args, got_auxs = export_mxnet_params(model)
    assert set(got_args) == set(args) and set(got_auxs) == set(auxs)
    for name in args:
        np.testing.assert_array_equal(got_args[name], args[name])
    for name in auxs:
        np.testing.assert_array_equal(got_auxs[name], auxs[name])


@pytest.mark.parametrize("shape,bottleneck,stem_s2d", [
    ((4, 16, 16, 12), True, True),     # pre-blocked s2d input
    ((4, 32, 32, 3), True, True),      # s2d stem, regrouped inside
    ((4, 32, 32, 3), True, False),     # plain 7x7/2 stem
    ((4, 32, 32, 3), False, False),    # basic units
], ids=["preblocked", "s2d", "plain", "basic"])
def test_eval_logits_match(shape, bottleneck, stem_s2d):
    x = _x(shape)
    jm, variables, model = _pair(x, bottleneck, stem_s2d)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("bn", [
    dict(),
    dict(bn_ema=True),
    dict(bn_subsample=4),
    dict(bn_subsample=4, bn_grouped=True),
    dict(bn_stat_stride=2),
], ids=["full", "ema", "sub4", "grouped4", "stride2"])
def test_train_logits_stats_and_grads_match(bn):
    x = _x(TRAIN_X)
    jm, variables, model = _pair(x, **bn)

    def loss_fn(params):
        logits, mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(LABELS)), (logits, mut)

    # XLA's backend optimisation takes ~5 s of a ~12 s compile on one core
    # and nothing of the comparison needs it
    (_, (want_logits, mut)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True)).lower(variables["params"]).compile(
            compiler_options=FAST_COMPILE)(variables["params"])
    want_grads, want_stats = jax_export(jgrads, mut["batch_stats"])

    model.train()
    logits = model(torch.from_numpy(x))
    cross_entropy_loss(logits, torch.from_numpy(LABELS)).backward()
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), rtol=1e-4, atol=1e-4)
    got_stats = export_mxnet_params(model)[1]
    for name, want in want_stats.items():
        np.testing.assert_allclose(got_stats[name], want, rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    n_grads = 0
    for name, aux, t in _tensors(model):
        if not aux:
            np.testing.assert_allclose(t.grad.numpy(), want_grads[name],
                                       rtol=1e-4, atol=1e-4, err_msg=name)
            n_grads += 1
    assert n_grads == len(want_grads)


def test_bf16_forward_matches():
    """bf16 compute, train-mode bn-ema. Tolerance 2e-2 of the logit scale:
    bf16 keeps 8 significant bits (2^-8 relative per rounding), and the
    two frameworks round the conv outputs at different points of their
    accumulations, through eleven conv-BN layers."""
    x = _x(TRAIN_X)
    jm, variables, model = _pair(x, bn_ema=True,
                                 dtype=(jnp.bfloat16, torch.bfloat16))
    want, _ = jax.jit(jm.apply, static_argnames=("train", "mutable"))(
        variables, jnp.asarray(x), train=True, mutable=("batch_stats",))
    model.train()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    assert got.dtype == np.float32            # fp32 head
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)


@pytest.mark.parametrize("seed", [0, 1])
def test_stem_pool_ties_route_like_jax(seed):
    """Post-ReLU windows tie at 0; the whole cotangent goes to the first
    maximum in scan order on both sides, forward and backward bitwise."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 1, (2, 9, 10, 4)), 0).astype(np.float32)
    x[0, :4, :4] = 0.5                          # ties at a positive value
    dy = rng.normal(0, 1, (2, 5, 5, 4)).astype(np.float32)

    def jpool(v):
        return fnn.max_pool(v, (3, 3), strides=(2, 2),
                            padding=((1, 1), (1, 1)))

    want_y, vjp = jax.vjp(jpool, jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    from resnet_tpu_torch.ops.pool import stem_max_pool
    y = stem_max_pool(xt)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_y))
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 1).numpy(),
                                  want_dx)


@pytest.mark.parametrize("hwio", [(7, 7, 3, 64), (3, 3, 128, 128),
                                  (1, 1, 1024, 2048), (2048, 1000)],
                         ids=["stem", "conv3x3", "conv1x1", "fc"])
def test_init_distribution_matches_jax(hwio):
    """MSRA init: the port draws other values than flax, from the same
    distribution: flax's variance_scaling(scale, "fan_in", "normal") is an
    untruncated normal with variance scale/fan_in, fan-in on HWIO."""
    from resnet_tpu.models.resnet import conv_init, dense_init
    from resnet_tpu_torch.models.resnet import Conv, Dense
    g = torch.Generator().manual_seed(0)
    if len(hwio) == 2:
        w = np.asarray(dense_init(jax.random.key(0), hwio))
        mod, scale = Dense(*hwio), 1.0
    else:
        w = np.asarray(conv_init(jax.random.key(0), hwio))
        mod, scale = Conv(hwio[2], hwio[3], hwio[0]), 2.0
    mod.reset_parameters(g)
    got = mod.weight.detach().numpy()
    assert got.size == w.size
    std = np.sqrt(scale / np.prod(hwio[:-1]))
    for a in (got, w):
        assert np.std(a) == pytest.approx(std, rel=0.05)
        # untruncated: 4.55% of a normal lies beyond two std
        assert np.mean(np.abs(a) > 2 * std) == pytest.approx(0.0455,
                                                              abs=0.012)
