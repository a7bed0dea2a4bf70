"""The port's optimizer, schedule, loss and metrics, and its whole train
step, against the JAX package's.

The whole-slice test runs the port's ``make_train_step(steps_per_dispatch=3)``
on uint8 canvases with explicit per-step augmentation rows, and the JAX
``make_train_step(steps_per_dispatch=3, augment_fn=None)`` on the images
the JAX Pallas augmentation kernel (interpret mode) made from the same
rows; both start from one JAX-initialised state carried by the weight
bridge. It compares at rtol 2e-4, the bar of
tests/test_golden_imagenet_path.py, with atol 1e-6 for entries near zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from resnet_tpu.config import imagenet_resnet50 as jax_preset
from resnet_tpu.models.resnet import ResNet as JaxResNet
from resnet_tpu.ops.augment_pallas import fused_crop_mirror_normalize as jax_k1
from resnet_tpu.ops import metrics as jax_metrics
from resnet_tpu.train import optim as jax_optim
from resnet_tpu.train.schedule import (schedule_from_config as jax_schedule,
                                       warmup_multifactor as jax_warmup)
from resnet_tpu.train.state import TrainState as JaxTrainState
from resnet_tpu.train.steps import make_train_step as jax_make_train_step
from resnet_tpu.utils.export import export_mxnet_params as jax_export
from resnet_tpu_torch.config import imagenet_resnet50
from resnet_tpu_torch.models.resnet import ResNet
from resnet_tpu_torch.ops import metrics
from resnet_tpu_torch.ops.augment_fused import make_augment_fn
from resnet_tpu_torch.train.optim import MXNetSGD, mxnet_sgd_, radial_projection
from resnet_tpu_torch.train.schedule import warmup_multifactor
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.train.steps import make_train_step
from resnet_tpu_torch.utils.export import (_tensors, export_mxnet_params,
                                           load_mxnet_params)

# one conv kernel (port OIHW, JAX HWIO), one fc weight, one BN vector
SHAPES = {"conv": (6, 4, 3, 3), "fc": (5, 7), "bn": (6,)}


def _to_jax(name, a):
    return jnp.asarray(a.transpose(2, 3, 1, 0) if name == "conv" else a)


def _from_jax(name, a):
    a = np.asarray(a)
    return a.transpose(3, 2, 0, 1) if name == "conv" else a


@pytest.mark.parametrize("nesterov,project", [
    (False, True), (False, False), (True, False)],
    ids=["sgd+projection", "sgd", "nag"])
def test_optimizer_matches_optax_over_three_updates(nesterov, project):
    rng = np.random.default_rng(0)
    params = {k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: rng.normal(0, 1, s).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(3)]
    schedule = dict(base_lr=0.1, steps=[2], factor=0.1)

    tx = jax_optim.mxnet_sgd(jax_warmup(**schedule), momentum=0.9,
                             weight_decay=1e-4, nesterov=nesterov)
    if project:
        tx = optax.chain(jax_optim.radial_projection(), tx)
    jp = {k: _to_jax(k, v) for k, v in params.items()}
    opt = tx.init(jp)
    for g in grads:
        upd, opt = tx.update({k: _to_jax(k, v) for k, v in g.items()},
                             opt, jp)
        jp = optax.apply_updates(jp, upd)
    jmom = (opt[1] if project else opt).momentum

    names = list(SHAPES)
    tp = [torch.from_numpy(params[k].copy()) for k in names]
    moms = [torch.zeros_like(p) for p in tp]
    sgd = MXNetSGD(warmup_multifactor(**schedule), momentum=0.9,
                   weight_decay=1e-4, nesterov=nesterov, project=project)
    for count, g in enumerate(grads):
        sgd.update_(tp, [torch.from_numpy(g[k]) for k in names], moms, count)
    for k, p, m in zip(names, tp, moms):
        np.testing.assert_allclose(p.numpy(), _from_jax(k, jp[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(m.numpy(), _from_jax(k, jmom[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_radial_projection_removes_the_radial_component():
    rng = np.random.default_rng(1)
    p = torch.from_numpy(rng.normal(0, 1, SHAPES["conv"]).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, SHAPES["conv"]).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (6,)).astype(np.float32))
    pg, pv = radial_projection([g, v], [p, v])
    assert pv is v
    radial = (pg * p).sum(dim=(1, 2, 3)) / (p * p).sum(dim=(1, 2, 3))
    assert radial.abs().max() < 1e-6


def test_plain_sgd_update_rule():
    p = torch.tensor([1.0, -2.0])
    m = torch.tensor([0.5, 0.0])
    g = torch.tensor([0.1, 0.2])
    mxnet_sgd_([p], [g], [m], lr=0.1, momentum=0.9, weight_decay=0.01)
    want_m = 0.9 * np.array([0.5, 0.0]) - 0.1 * (np.array([0.1, 0.2])
                                                 + 0.01 * np.array([1, -2]))
    np.testing.assert_allclose(m.numpy(), want_m, rtol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.array([1, -2]) + want_m,
                               rtol=1e-6)


def test_warmup_multifactor_matches_jax():
    kw = dict(base_lr=0.4, steps=[5, 8], factor=0.1, warmup=True,
              warmup_lr=0.05, warmup_steps=4)
    got = [warmup_multifactor(**kw)(c) for c in range(11)]
    want = [float(jax_warmup(**kw)(c)) for c in range(11)]
    np.testing.assert_allclose(got, want, rtol=1e-7)
    assert got[0] == pytest.approx(0.05) and got[4] == pytest.approx(0.4)
    assert got[10] == pytest.approx(0.004, rel=1e-6)


@pytest.mark.parametrize("label_smooth", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_metric_sums_match_jax(label_smooth, masked):
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (16, 10)).astype(np.float32)
    labels = rng.integers(0, 10, 16).astype(np.int32)
    mask = (rng.random(16) < 0.7).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    want_loss = jax_metrics.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), label_smooth, mask=jm)
    want = jax_metrics.metric_sums(jnp.asarray(logits), jnp.asarray(labels),
                                   want_loss, mask=jm)
    loss = metrics.cross_entropy_loss(torch.from_numpy(logits),
                                      torch.from_numpy(labels), label_smooth,
                                      mask=tm)
    got = metrics.metric_sums(torch.from_numpy(logits),
                              torch.from_numpy(labels), loss, mask=tm)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6,
                                   err_msg=k)
    acc = metrics.MetricAccumulator()
    acc.update(got)
    acc.update(got)
    assert acc.get()["cross-entropy"] == pytest.approx(float(loss), rel=1e-6)


K, N, HC, WC, OUT = 3, 8, 72, 80, (64, 64)
UNITS, FILTERS = (1, 1, 1, 1), (8, 16, 32, 64, 128)


def _rows(rng):
    """(K, N, 12) per-step augmentation rows: random boxes, mixed flips,
    a letterboxed extent on half the images, HSL deltas."""
    rows = np.zeros((K, N, 12), np.float32)
    vh = np.where(np.arange(N) % 2, 56.0, HC)
    vw = np.where(np.arange(N) % 2, 80.0, WC)
    for s in range(K):
        ch = np.round(rng.uniform(16, vh))
        cw = np.round(rng.uniform(16, vw))
        rows[s, :, 0] = np.floor(rng.uniform(0, vh - ch + 1))
        rows[s, :, 1] = np.floor(rng.uniform(0, vw - cw + 1))
        rows[s, :, 2], rows[s, :, 3] = ch, cw
        rows[s, :, 4] = rng.random(N) < 0.5
        rows[s, :, 5], rows[s, :, 6] = vh, vw
        rows[s, :, 7] = rng.uniform(-36, 36, N)
        rows[s, :, 8] = rng.uniform(-50, 50, N)
        rows[s, :, 9] = rng.uniform(-50, 50, N)
    return rows


def test_three_step_train_call_matches_jax():
    rng = np.random.default_rng(7)
    canvas = rng.integers(0, 256, (K, N, HC, WC, 3), np.uint8)
    labels = rng.integers(0, 10, (K, N)).astype(np.int32)
    rows = _rows(rng)

    jcfg = jax_preset()
    jcfg.train.dtype = "float32"
    jcfg.data.num_classes = 10
    jm = JaxResNet(units=UNITS, filters=FILTERS, num_classes=10,
                   bottleneck=True, bn_ema=True, stem_s2d=True)
    key = jax.random.key(0)
    variables = jax.jit(jm.init, static_argnames="train")(
        key, jnp.zeros((1, OUT[0] // 2, OUT[1] // 2, 12)), train=False)
    # the JAX step donates its state: take the table before it runs
    init_table = jax_export(variables["params"], variables["batch_stats"])
    tx = optax.chain(jax_optim.radial_projection(),
                     jax_optim.mxnet_sgd(jax_schedule(jcfg), momentum=0.9,
                                         weight_decay=1e-4))
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
    cfg.data.num_classes = 10
    cfg.data.image_shape = OUT + (3,)
    model = ResNet(units=UNITS, filters=FILTERS, num_classes=10,
                   bottleneck=True, bn_ema=True, stem_s2d=True)
    load_mxnet_params(model, *init_table)
    state = create_train_state(cfg, device="cpu", model=model)
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
    want_mom, _ = jax_export(jstate.opt_state[1].momentum,
                             jstate.batch_stats)
    name_of = {id(t): name for name, aux, t in _tensors(model) if not aux}
    for p, m in zip(model.parameters(), state.momentum):
        np.testing.assert_allclose(m.numpy(), want_mom[name_of[id(p)]],
                                   err_msg=name_of[id(p)], **tol)
