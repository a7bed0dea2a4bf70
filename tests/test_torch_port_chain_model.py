"""The port's chain and fused conv+BN execution paths against the JAX
package's, at model level and through a whole train call, on the CPU.

Both sides build a tiny v1 bottleneck net (two stages of two units, so
strided and unstrided projection shortcuts and identity units all occur,
ImageNet stem, 8 inputs of 32x32) from one set of randomized variables
carried by the weight bridge (``utils/export.py``), under ``unit_chain`` in
{xla, pallas} and under ``fused``. The JAX model runs its Pallas kernels in
interpret mode; the port's wrappers take their plain versions because the
tensors lie on the CPU.

float32 comparisons hold at rtol/atol 1e-4, the bar of
tests/test_torch_port_model.py (the two frameworks sum convolutions and BN
statistics in different orders); the JAX package's own bar between its chain
and its standard path is looser on gradients (rtol 1e-3,
tests/test_chain_model.py).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resnet_tpu.config import imagenet_resnet50 as jax_preset
from resnet_tpu.models.resnet import ResNet as JaxResNet
from resnet_tpu.ops.augment_pallas import fused_crop_mirror_normalize as jax_k1
from resnet_tpu.ops.metrics import cross_entropy_loss as jax_ce
from resnet_tpu.train import optim as jax_optim
from resnet_tpu.train.schedule import schedule_from_config as jax_schedule
from resnet_tpu.train.state import TrainState as JaxTrainState
from resnet_tpu.train.steps import make_train_step as jax_make_train_step
from resnet_tpu.utils.export import export_mxnet_params as jax_export
from resnet_tpu_torch.config import imagenet_resnet50
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.models.resnet import ResNet
from resnet_tpu_torch.ops.augment_fused import make_augment_fn
from resnet_tpu_torch.ops.metrics import cross_entropy_loss
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.train.steps import make_train_step
from resnet_tpu_torch.utils.export import (_tensors, export_mxnet_params,
                                           load_mxnet_params)
# the sibling test modules' input makers: randomized variables, and the
# 3-step call's canvases' augmentation rows with its sizes
from test_torch_port_model import _randomize
from test_torch_port_step import FILTERS, HC, K, N, OUT, UNITS, WC, _rows

NET = dict(units=(2, 2), filters=(8, 16, 32), num_classes=10, bottleneck=True)
SHAPE = (8, 32, 32, 3)
LABELS = np.array([1, 7, 3, 0, 9, 2, 5, 4])
# the execution-path switches, by the ResNet keyword arguments of both sides
SWITCHES = {"chain-xla": dict(unit_chain="xla"),
            "chain-pallas": dict(unit_chain="pallas"),
            "fused": dict(fused=True)}
switches = pytest.mark.parametrize("switch", list(SWITCHES))


def _x(seed=1):
    return np.random.default_rng(seed).normal(0, 1, SHAPE).astype(np.float32)


def _pair(x, **switch):
    """(jax module, jax variables, port model) with one set of weights."""
    jm = JaxResNet(pallas_interpret=True, **NET, **switch)
    shapes = jax.eval_shape(partial(jm.init, train=False),
                            jax.random.key(0), jnp.asarray(x))
    variables = _randomize(shapes)
    model = ResNet(**NET, **switch).to(memory_format=torch.channels_last)
    load_mxnet_params(model, *jax_export(variables["params"],
                                         variables["batch_stats"]))
    return jm, variables, model


@switches
def test_train_loss_logits_stats_and_grads_match_jax(switch):
    x = _x()
    jm, variables, model = _pair(x, **SWITCHES[switch])

    def loss_fn(params):
        logits, mut = jm.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), train=True, mutable=["batch_stats"])
        return jax_ce(logits, jnp.asarray(LABELS)), (logits, mut)

    (want_loss, (want_logits, mut)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    want_grads, want_stats = jax_export(jgrads, mut["batch_stats"])

    model.train()
    logits = model(torch.from_numpy(x))
    loss = cross_entropy_loss(logits, torch.from_numpy(LABELS))
    loss.backward()
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(loss.item(), float(want_loss), **tol)
    np.testing.assert_allclose(logits.detach().numpy(),
                               np.asarray(want_logits), **tol)
    got_stats = export_mxnet_params(model)[1]
    assert set(got_stats) == set(want_stats)
    for name, want in want_stats.items():
        np.testing.assert_allclose(got_stats[name], want, err_msg=name, **tol)
    n_grads = 0
    for name, aux, t in _tensors(model):
        if not aux:
            np.testing.assert_allclose(t.grad.numpy(), want_grads[name],
                                       err_msg=name, **tol)
            n_grads += 1
    assert n_grads == len(want_grads)


@switches
def test_eval_takes_the_standard_path_bitwise(switch):
    x = _x(2)
    _, variables, model = _pair(x, **SWITCHES[switch])
    standard = ResNet(**NET).to(memory_format=torch.channels_last)
    standard.load_state_dict(model.state_dict())
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
        want = standard.eval()(torch.from_numpy(x))
    assert torch.equal(got, want)


@switches
def test_parameter_tree_and_weight_bridge_do_not_change(switch):
    """Same ``state_dict()`` keys and shapes, and the same exported table,
    under every switch: a train step on one path leaves a model that the
    weight bridge carries to any other."""
    x = _x(3)
    _, variables, model = _pair(x, **SWITCHES[switch])
    standard = ResNet(**NET)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in standard.state_dict().items()}
    want = jax_export(variables["params"], variables["batch_stats"])
    for got_table, want_table in zip(export_mxnet_params(model), want):
        assert set(got_table) == set(want_table)
        for name in want_table:
            np.testing.assert_array_equal(got_table[name], want_table[name])
    model.train()(torch.from_numpy(x))          # refreshes running stats
    standard.train()
    load_mxnet_params(standard, *export_mxnet_params(model))
    for (ka, a), (kb, b) in zip(model.state_dict().items(),
                                standard.state_dict().items()):
        assert ka == kb and torch.equal(a, b)


@pytest.mark.parametrize("field,value", [("fused_convbn", True),
                                         ("unit_chain", "xla"),
                                         ("unit_chain", "pallas")])
def test_registry_guards_bn_ema_with_either_switch(field, value):
    cfg = imagenet_resnet50()                   # bn_ema=True
    setattr(cfg.train, field, value)
    with pytest.raises(ValueError, match="--bn-ema does not compose"):
        get_model(cfg)
    jcfg = jax_preset()
    setattr(jcfg.train, field, value)
    from resnet_tpu.models.registry import get_model as jax_get_model
    with pytest.raises(ValueError, match="--bn-ema does not compose"):
        jax_get_model(jcfg)


def test_registry_passes_the_switches_and_rejects_unknown_chain():
    cfg = imagenet_resnet50()
    cfg.train.bn_ema = False
    cfg.model.depth = 50
    cfg.train.unit_chain, cfg.train.fused_convbn = "pallas", True
    unit = get_model(cfg).units()[0]
    assert unit.unit_chain == "pallas" and unit.fused is True
    assert cfg.train.__class__().unit_chain == "off"
    assert cfg.train.__class__().fused_convbn is False
    cfg.train.unit_chain = "triton"
    with pytest.raises(ValueError, match="off|xla|pallas"):
        get_model(cfg)


def test_three_step_chain_train_call_matches_jax():
    """``make_train_step(steps_per_dispatch=3)`` with ``unit_chain="pallas"``
    and full-batch BN (``bn_ema=False``, so no radial projection) against
    the JAX step, from one JAX-initialised state, at rtol 2e-4 (the bar of
    tests/test_torch_port_step.py), atol 1e-6 for entries near zero."""
    rng = np.random.default_rng(7)
    canvas = rng.integers(0, 256, (K, N, HC, WC, 3), np.uint8)
    labels = rng.integers(0, 10, (K, N)).astype(np.int32)
    rows = _rows(rng)

    jcfg = jax_preset()
    jcfg.train.dtype = "float32"
    jcfg.train.bn_ema = False
    jcfg.data.num_classes = 10
    net = dict(units=UNITS, filters=FILTERS, num_classes=10, bottleneck=True,
               stem_s2d=True, unit_chain="pallas")
    jm = JaxResNet(pallas_interpret=True, **net)
    key = jax.random.key(0)
    variables = jax.jit(jm.init, static_argnames="train")(
        key, jnp.zeros((1, OUT[0] // 2, OUT[1] // 2, 12)), train=False)
    # the JAX step donates its state: take the table before it runs
    init_table = jax_export(variables["params"], variables["batch_stats"])
    tx = jax_optim.mxnet_sgd(jax_schedule(jcfg), momentum=0.9,
                             weight_decay=1e-4)
    jstate = JaxTrainState(
        step=jnp.zeros([], jnp.int32), params=variables["params"],
        batch_stats=variables["batch_stats"],
        opt_state=tx.init(variables["params"]),
        rng=jax.random.key_data(key), apply_fn=jm.apply, tx=tx)
    k1 = jax.jit(lambda c, r: jax_k1(
        c, tuple(r[:, i] for i in range(4)), r[:, 4], OUT,
        jcfg.data.mean_rgb, jcfg.data.std_rgb, jnp.float32, interpret=True,
        valid_hw=(r[:, 5], r[:, 6]),
        photometric={"dh": r[:, 7], "ds": r[:, 8], "dl": r[:, 9]}, s2d=True))
    images = jnp.stack([k1(jnp.asarray(canvas[s]), jnp.asarray(rows[s]))
                        for s in range(K)])
    jstate, jmetrics = jax_make_train_step(steps_per_dispatch=K)(
        jstate, {"image": images, "label": jnp.asarray(labels)})

    cfg = imagenet_resnet50()
    cfg.train.dtype = "float32"
    cfg.train.bn_ema = False
    cfg.train.unit_chain = "pallas"
    cfg.data.num_classes = 10
    cfg.data.image_shape = OUT + (3,)
    model = ResNet(**net)
    load_mxnet_params(model, *init_table)
    state = create_train_state(cfg, device="cpu", model=model)
    assert state.tx.project is False
    step = make_train_step(augment_fn=make_augment_fn(cfg),
                           steps_per_dispatch=K)
    state, got_metrics = step(state, {
        "image": torch.from_numpy(canvas), "label": torch.from_numpy(labels),
        "rows": torch.from_numpy(rows)})
    assert state.step == K

    tol = dict(rtol=2e-4, atol=1e-6)
    for name, want in jmetrics.items():
        np.testing.assert_allclose(float(got_metrics[name]), float(want),
                                   err_msg=name, **tol)
    want_args, want_auxs = jax_export(jstate.params, jstate.batch_stats)
    got_args, got_auxs = export_mxnet_params(state)
    for name in want_args:
        np.testing.assert_allclose(got_args[name], want_args[name],
                                   err_msg=name, **tol)
    for name in want_auxs:
        np.testing.assert_allclose(got_auxs[name], want_auxs[name],
                                   err_msg=name, **tol)
    want_mom, _ = jax_export(jstate.opt_state.momentum, jstate.batch_stats)
    name_of = {id(t): name for name, aux, t in _tensors(model) if not aux}
    for p, m in zip(model.parameters(), state.momentum):
        np.testing.assert_allclose(m.numpy(), want_mom[name_of[id(p)]],
                                   err_msg=name_of[id(p)], **tol)
