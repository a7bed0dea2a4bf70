"""The rest of the model family against the JAX package: ResNeXt's grouped
3x3 and its block-diagonal lowering, v2 units, the CIFAR stem and nets,
remat, the mask max-pool backward, the registries and the optimizer on
what these nets add.

Both sides build a tiny net from ``ResNet(...)`` with the same switches;
the JAX variables are randomized and carried across by the weight bridge
(JAX ``export_mxnet_params`` into the port's ``load_mxnet_params``), as
tests/test_torch_port_model.py does. Inputs are numpy from a seed. float32
comparisons hold at rtol/atol 1e-4 (the two frameworks sum convolutions
and BN statistics in other orders); the port with remat against the port
without at 1e-6, with the running statistics bit-equal.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resnet_tpu import config as jax_config
from resnet_tpu.models.registry import get_model as jax_get_model
from resnet_tpu.models.resnet import ResNet as JaxResNet
from resnet_tpu.models.resnet import _GroupedConvDense
from resnet_tpu.ops.metrics import cross_entropy_loss as jax_ce
from resnet_tpu.ops.pool import max_pool_mask as jax_max_pool_mask
from resnet_tpu.train import optim as jax_optim
from resnet_tpu.utils.export import export_mxnet_params as jax_export
from resnet_tpu_torch import config
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.models.resnet import (CIFAR_FILTERS_BASIC, BatchNorm,
                                            Conv, GroupedConvDense, ResNet)
from resnet_tpu_torch.ops.metrics import cross_entropy_loss
from resnet_tpu_torch.ops.pool import max_pool_mask
from resnet_tpu_torch.train.optim import MXNetSGD
from resnet_tpu_torch.utils.export import (_tensors, export_mxnet_params,
                                           load_mxnet_params)
from test_torch_port_model import FAST_COMPILE, LABELS, _randomize, _x

NARROW_BASIC = (8, 8, 16, 32, 64)
# ResNeXt at cardinality 4, group width 8 over narrow filters: the width
# rule gives middles of 4, 4, 8 and 16 channels, 1, 1, 2 and 4 a group
RESNEXT = dict(units=(1, 1, 1, 1), filters=(8, 16, 32, 64, 128),
               bottleneck=True, cardinality=4, group_width=8)
NETS = {
    "resnext_grouped": dict(RESNEXT, stem_s2d=True),
    "resnext_merge1": dict(RESNEXT, stem_s2d=True, grouped_dense=True,
                           grouped_merge=1),
    "resnext_merge2_ema": dict(RESNEXT, stem_s2d=True, grouped_dense=True,
                               grouped_merge=2, bn_ema=True),
    "resnext_merge4": dict(RESNEXT, stem_s2d=True, grouped_dense=True,
                           grouped_merge=4),
    # the ImageNet stem with the mask pool backward
    "v2_bottleneck": dict(units=(1, 1, 1, 1), filters=(8, 16, 32, 64, 128),
                          bottleneck=True, version=2, pool_grad="mask"),
    "v2_basic_cifar": dict(units=(1, 1, 1), filters=CIFAR_FILTERS_BASIC,
                           bottleneck=False, version=2, cifar_stem=True),
    # depth 8 = 6n+2 with n = 1
    "cifar8": dict(units=(1, 1, 1), filters=CIFAR_FILTERS_BASIC,
                   bottleneck=False, cifar_stem=True),
    # ImageNet depth 18 with the CIFAR stem, as cifar10_resnet18
    "cifar_stem_r18": dict(units=(2, 2, 2, 2), filters=NARROW_BASIC,
                           bottleneck=False, cifar_stem=True),
}


def _shape(name):
    """8 images: 64x64 for the ImageNet stems (pre-blocked for the s2d
    ones), 16x16 for the CIFAR stem; the last BN then sees 2x2 or more
    values an image."""
    kw = NETS[name]
    if kw.get("cifar_stem"):
        return (8, 16, 16, 3)
    return (8, 32, 32, 12) if kw.get("stem_s2d") else (8, 64, 64, 3)


def _pair(name, x, **extra):
    """(jax module, jax variables, port model) of net ``name`` with one
    set of weights; ``extra`` switches apply to both sides."""
    kw = dict(NETS[name], num_classes=10, **extra)
    jm = JaxResNet(dtype=jnp.float32, **kw)
    shapes = jax.eval_shape(partial(jm.init, train=False),
                            jax.random.key(0), jnp.asarray(x))
    variables = _randomize(shapes)
    model = ResNet(**kw).to(memory_format=torch.channels_last)
    load_mxnet_params(model, *jax_export(variables["params"],
                                         variables["batch_stats"]))
    return jm, variables, model


def _jax_train_step(jm, variables, x):
    def loss_fn(params):
        logits, mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(LABELS)), (logits, mut)

    (loss, (logits, mut)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True)).lower(variables["params"]).compile(
            compiler_options=FAST_COMPILE)(variables["params"])
    want_grads, want_stats = jax_export(grads, mut["batch_stats"])
    return float(loss), np.asarray(logits), want_grads, want_stats


def _port_train_step(model, x):
    model.train()
    logits = model(torch.from_numpy(x))
    loss = cross_entropy_loss(logits, torch.from_numpy(LABELS))
    loss.backward()
    grads = {name: t.grad.numpy() for name, aux, t in _tensors(model)
             if not aux}
    return float(loss.detach()), logits.detach().numpy(), grads, \
        export_mxnet_params(model)[1]


def _close(got, want, name, tol=1e-4):
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


def _assert_step_matches(got, want):
    (loss, logits, grads, stats), (wloss, wlogits, wgrads, wstats) = got, want
    _close(loss, wloss, "loss")
    _close(logits, wlogits, "logits")
    assert set(grads) == set(wgrads) and set(stats) == set(wstats)
    for name in wgrads:
        _close(grads[name], wgrads[name], name)
    for name in wstats:
        _close(stats[name], wstats[name], name)


# ---------------------------------------------------------------------------
# the grouped 3x3 and its block-diagonal lowering
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", [1, 2, 4])
@pytest.mark.parametrize("stride", [1, 2])
def test_grouped_conv_dense_matches_jax(merge, stride):
    """G=4 groups of 3 input and 2 output channels: the port's
    block-diagonal weight, its convolution and the weight's gradient
    against ``_GroupedConvDense``, and against the plain grouped conv."""
    g, cin, cout = 4, 12, 8
    rng = np.random.default_rng(merge * 10 + stride)
    x = rng.normal(0, 1, (2, 7, 9, cin)).astype(np.float32)
    k = rng.normal(0, 0.3, (3, 3, cin // g, cout)).astype(np.float32)
    cot = rng.normal(0, 1, (2, (7 - 1) // stride + 1, (9 - 1) // stride + 1,
                            cout)).astype(np.float32)
    jm = _GroupedConvDense(features=cout, kernel_size=(3, 3),
                           strides=(stride, stride), groups=g, merge=merge,
                           padding=((1, 1), (1, 1)))

    def jf(kernel):
        return jm.apply({"params": {"kernel": kernel}}, jnp.asarray(x))

    want, vjp = jax.vjp(jf, jnp.asarray(k))
    want_dk = np.asarray(vjp(jnp.asarray(cot))[0])

    outs = []
    for mod in (GroupedConvDense(cin, cout, 3, stride, 1, g, merge),
                Conv(cin, cout, 3, stride, 1, groups=g)):
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        y = mod(xt)
        y.backward(torch.from_numpy(cot).permute(0, 3, 1, 2))
        outs.append((y.detach().permute(0, 2, 3, 1).numpy(),
                     mod.weight.grad.numpy().transpose(2, 3, 1, 0)))
    for y, dk in outs:
        _close(y, want, "y", 1e-5)
        _close(dk, want_dk, "dkernel", 1e-5)
    # the dense weight is the block-diagonal one: zero off the blocks,
    # the grouped weight on them
    dense = GroupedConvDense(cin, cout, 3, stride, 1, g, merge)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    w = dense.dense_weight().detach().numpy()
    cg, cog = cin // g, cout // g
    for o in range(cout):
        grp = o // cog
        for i in range(merge * cg):
            src = (grp // merge) * merge + i // cg
            want_w = k[:, :, i % cg, o] if src == grp else 0.0
            np.testing.assert_array_equal(w[o, i], want_w)


# ---------------------------------------------------------------------------
# whole nets: eval logits and one train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(NETS))
def test_eval_logits_match(name):
    x = _x((4,) + _shape(name)[1:])
    jm, variables, model = _pair(name, x)
    want = np.asarray(jax.jit(jm.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False))
    model.eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    _close(got, want, "logits")


@pytest.mark.parametrize("name", list(NETS))
def test_train_step_matches(name):
    """Loss, logits, every gradient and every refreshed running
    statistic of one train-mode step."""
    x = _x(_shape(name))
    jm, variables, model = _pair(name, x)
    _assert_step_matches(_port_train_step(model, x),
                         _jax_train_step(jm, variables, x))


@pytest.mark.parametrize("name,remat", [
    ("resnext_merge2_ema", dict(remat=True)),
    ("v2_bottleneck", dict(remat_policy="conv")),
    ("cifar8", dict(remat=True)),
], ids=["resnext_ema_remat", "v2_policy_conv", "cifar8_remat"])
def test_remat_step(name, remat, monkeypatch):
    """The port with remat equals the port without at 1e-6, running
    statistics bit for bit (the recomputation refreshes nothing, and in
    bn-ema reads the pre-step statistics); the JAX remat net agrees with
    both at 1e-4. Remat's BatchNorms run the eager code, so both steps do:
    the bn-ema kernels' path (``ops/bn_ema.py``) is switched off."""
    monkeypatch.setattr(BatchNorm, "_takes_kernels", lambda self, x: False)
    x = _x(_shape(name))
    jm, variables, model = _pair(name, x, **remat)
    plain = ResNet(**NETS[name], num_classes=10).to(
        memory_format=torch.channels_last)
    plain.load_state_dict(model.state_dict())
    got = _port_train_step(model, x)
    base = _port_train_step(plain, x)
    _close(got[0], base[0], "loss", 1e-6)
    for name_, g in base[2].items():
        _close(got[2][name_], g, name_, 1e-6)
    for name_, s in base[3].items():
        np.testing.assert_array_equal(got[3][name_], s, err_msg=name_)
    _assert_step_matches(got, _jax_train_step(jm, variables, x))


@pytest.mark.parametrize("seed", [0, 1])
def test_max_pool_mask_splits_ties_like_jax(seed):
    """Post-ReLU windows tie at 0, a block ties at 0.5: forward and the
    tie-split backward against ``resnet_tpu.ops.pool.max_pool_mask``."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 1, (2, 9, 10, 4)), 0).astype(np.float32)
    x[0, :4, :4] = 0.5
    dy = rng.normal(0, 1, (2, 5, 5, 4)).astype(np.float32)
    want_y, vjp = jax.vjp(jax_max_pool_mask, jnp.asarray(x))
    want_dx = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = max_pool_mask(xt)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(y.detach().permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want_y))
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), want_dx, "dx", 1e-6)
    # ties were split: the first-maximum routing gives another gradient
    xs = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    torch.nn.functional.max_pool2d(xs, 3, 2, 1).backward(
        torch.from_numpy(dy).permute(0, 3, 1, 2))
    assert not torch.allclose(xs.grad, xt.grad)


# a ResNeXt as wide as the stem-gradient gap of ROADMAP Queue 3 needs:
# group width 2, filters up to 512 (middles of 4-8 channels, 1-2 a group)
WIDE_RESNEXT = dict(units=(1, 1, 1, 1), filters=(8, 64, 128, 256, 512),
                    bottleneck=True, cardinality=4, group_width=2,
                    stem_s2d=True)


def _float64_train_grads(x_blocked, args, auxs, kw):
    """Loss and gradients of one train-mode step of the v1 ResNeXt ``kw``
    in float64, written from the exported name table with
    ``torch.nn.functional`` and sharing no code with either model: BN on
    the batch statistics (biased variance), the 7x7/2 stem on the image
    the (N, H/2, W/2, 12) blocks unfold to, the grouped 3x3s as grouped
    convolutions."""
    import torch.nn.functional as F
    p = {k: torch.tensor(np.asarray(v), dtype=torch.float64,
                         requires_grad=True) for k, v in args.items()}
    eps = 2e-5
    n, hb, wb, _ = x_blocked.shape
    x = (torch.from_numpy(x_blocked).double().permute(0, 3, 1, 2)
         .reshape(n, 2, 2, 3, hb, wb).permute(0, 3, 4, 1, 5, 2)
         .reshape(n, 3, 2 * hb, 2 * wb))

    def conv(x, name, stride=1, pad=0, groups=1):
        return F.conv2d(x, p[name + "_weight"], stride=stride, padding=pad,
                        groups=groups)

    def bn(x, name):
        mean = x.mean((0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean((0, 2, 3), keepdim=True)
        return ((x - mean) * torch.rsqrt(var + eps)
                * p[name + "_gamma"][:, None, None]
                + p[name + "_beta"][:, None, None])

    x = F.max_pool2d(F.relu(bn(conv(x, "conv0", 2, 3), "bn0")), 3, 2, 1)
    c = kw["cardinality"]
    for stage, f in enumerate(kw["filters"][1:]):
        s = 2 if stage > 0 else 1
        u = f"stage{stage + 1}_unit1_"
        y = F.relu(bn(conv(x, u + "conv1"), u + "bn1"))
        y = F.relu(bn(conv(y, u + "conv2", s, 1, c), u + "bn2"))
        y = bn(conv(y, u + "conv3"), u + "bn3")
        x = F.relu(y + bn(conv(x, u + "sc", s), u + "sc_bn"))
    logits = F.linear(x.mean((2, 3)), p["fc1_weight"], p["fc1_bias"])
    loss = F.cross_entropy(logits, torch.from_numpy(LABELS))
    loss.backward()
    return float(loss.detach()), {k: t.grad.numpy() for k, t in p.items()}


@pytest.mark.parametrize("lowering", [{}, dict(grouped_dense=True,
                                               grouped_merge=2)],
                         ids=["grouped", "dense_merge2"])
def test_wide_resnext_step_against_float64(lowering):
    """The wide ResNeXt's train-step gradients, the port's and the JAX
    package's in float32, against a float64 evaluation of the same
    weights and inputs: the port's every gradient within the 1e-4 bar;
    JAX's within 1e-3, since its float32 sums over the stem and the first
    stage part from the float64 ones by up to 5x the bar (ROADMAP Queue
    3), which is why the nets above are narrower."""
    kw = dict(WIDE_RESNEXT, **lowering)
    x = _x((8, 32, 32, 12))
    jm = JaxResNet(dtype=jnp.float32, num_classes=10, **kw)
    variables = _randomize(jax.eval_shape(
        partial(jm.init, train=False), jax.random.key(0), jnp.asarray(x)))
    model = ResNet(num_classes=10, **kw).to(
        memory_format=torch.channels_last)
    args, auxs = jax_export(variables["params"], variables["batch_stats"])
    load_mxnet_params(model, args, auxs)
    loss, _, grads, _ = _port_train_step(model, x)
    jloss, _, jgrads, _ = _jax_train_step(jm, variables, x)
    want_loss, want = _float64_train_grads(x, args, auxs, WIDE_RESNEXT)
    assert set(grads) == set(jgrads) == set(want)
    _close(loss, want_loss, "loss", 1e-5)
    _close(jloss, want_loss, "jax loss", 1e-5)
    for name in want:
        _close(grads[name], want[name], name)
        _close(jgrads[name], want[name], "jax " + name, 1e-3)


# ---------------------------------------------------------------------------
# the bridge, the registries, parameter counts, the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["resnext_merge2_ema", "v2_bottleneck",
                                  "v2_basic_cifar"])
def test_bridge_round_trip_is_exact(name):
    jm, variables, model = _pair(name, _x((2,) + _shape(name)[1:]))
    args, auxs = jax_export(variables["params"], variables["batch_stats"])
    got_args, got_auxs = export_mxnet_params(model)
    assert set(got_args) == set(args) and set(got_auxs) == set(auxs)
    assert "bn_data_gamma" not in got_args
    for name_ in args:
        np.testing.assert_array_equal(got_args[name_], args[name_])
    for name_ in auxs:
        np.testing.assert_array_equal(got_auxs[name_], auxs[name_])
    if NETS[name].get("version") == 2:
        assert "bn_data_beta" in got_args and model.bn_data.weight is None
        # an MXNet v2 file carries bn_data_gamma; the model has no place
        # for it and ignores it
        load_mxnet_params(model, dict(args, bn_data_gamma=np.ones(3)), auxs)


def _jax_param_count(cfg):
    shapes = jax.eval_shape(
        partial(jax_get_model(cfg).init, train=False), jax.random.key(0),
        jnp.zeros((1, 32, 32, 3), jnp.float32))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))


@pytest.mark.parametrize("preset,depth", [
    ("imagenet_resnext50", None), ("cifar10_resnet18", None),
    ("imagenet_resnet50", 152)], ids=["resnext50", "cifar_r18", "r152"])
def test_param_counts_match_jax(preset, depth):
    cfg, jcfg = config.PRESETS[preset](), jax_config.PRESETS[preset]()
    if depth:
        cfg.model.depth = jcfg.model.depth = depth
    got = sum(p.numel() for p in get_model(cfg).parameters())
    assert got == _jax_param_count(jcfg)
    if preset == "imagenet_resnext50":
        assert got == 25_028_904


@pytest.mark.parametrize("model,train", [
    (dict(network="resnext", depth=18), {}),
    (dict(network="resnext", depth=20, dataset="cifar10"), {}),
    (dict(depth=21, dataset="cifar10"), {}),
    (dict(depth=37), {}),
    ({}, dict(unit_chain="xla", remat_policy="conv")),
    ({}, dict(unit_chain="pallas", bn_stat_stride=2)),
    (dict(network="resnext"), dict(grouped_dense=True, grouped_merge=3)),
    (dict(version=2, depth=18), dict(remat=True, pool_grad="mask")),
    (dict(dataset="cifar10", depth=8), dict(remat_policy="conv")),
], ids=["resnext18", "resnext_cifar20", "cifar21", "depth37",
        "chain_policy", "chain_stride", "merge3", "v2_remat_mask",
        "cifar8_policy"])
def test_registries_raise_alike(model, train):
    """Both registries build, or both raise, on the same switches."""
    cfg, jcfg = config.Config(), jax_config.Config()
    for c in (cfg, jcfg):
        for k, v in model.items():
            setattr(c.model, k, v)
        for k, v in train.items():
            setattr(c.train, k, v)
    try:
        _jax_param_count(jcfg)
        jax_err = None
    except (ValueError, AssertionError) as e:
        jax_err = e
    if jax_err is None:
        get_model(cfg)
    else:
        with pytest.raises(ValueError):
            get_model(cfg)


def test_radial_projection_and_decay_on_grouped_and_fixed_gamma_params():
    """Three projected SGD updates of a v2 ResNeXt's parameter list (grouped
    OIHW 3x3s, no ``bn_data`` gamma) against the JAX optimizer on the same
    tree (grouped HWIO kernels)."""
    name = "resnext_grouped"
    kw = dict(NETS[name], version=2, stem_s2d=False)
    x = _x((2, 32, 32, 3))
    jm = JaxResNet(num_classes=10, **kw)
    variables = _randomize(jax.eval_shape(
        partial(jm.init, train=False), jax.random.key(0), jnp.asarray(x)))
    model = ResNet(num_classes=10, **kw)
    load_mxnet_params(model, *jax_export(variables["params"],
                                         variables["batch_stats"]))
    rng = np.random.default_rng(3)
    jgrads = [jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.normal(0, 1, a.shape), a.dtype),
        variables["params"]) for _ in range(3)]
    schedule = lambda count: 0.1
    tx = optax.chain(jax_optim.radial_projection(),
                     jax_optim.mxnet_sgd(schedule, momentum=0.9,
                                         weight_decay=1e-4))
    jp = variables["params"]
    opt = tx.init(jp)

    @jax.jit
    def update(g, opt, p):
        upd, opt = tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt

    for g in jgrads:
        jp, opt = update(g, opt, jp)

    names = [n for n, aux, _ in _tensors(model) if not aux]
    params = [t for _, aux, t in _tensors(model) if not aux]
    assert len(params) == len(list(model.parameters()))
    assert "bn_data_gamma" not in names
    sgd = MXNetSGD(schedule, momentum=0.9, weight_decay=1e-4, project=True)
    moms = [torch.zeros_like(p) for p in params]
    for count, g in enumerate(jgrads):
        table = jax_export(g, {})[0]
        sgd.update_(params, [torch.from_numpy(np.array(table[n]))
                             for n in names], moms, count)
    want = jax_export(jp, {})[0]
    assert set(want) == set(names)
    for n, p in zip(names, params):
        _close(p.detach().numpy(), want[n], n, 1e-5)
