"""The port's Solver fit loop against the JAX package's, and the port's
checkpoints, kill and resume, ``.params`` resume and Speedometer.

Fit-loop parity. Both Solvers train a v1 ResNet-18 with the ImageNet
stem (standard 7x7 stem, float32) on 32x32 in-memory images: batch 8,
5 steps an epoch, ``steps_per_dispatch=2`` (each epoch ends in a one-step
tail), 2 epochs, bn-ema with ``bn_ema_warmup=3``, which the loop rounds up
to step 4, inside epoch 0. The random transforms are off, so both
augmenters are the same deterministic centre crop, whatever their random
streams. The JAX-initialised state enters the port as an MXNet
``.params`` file (``--load-epoch 0``). The JAX Solver runs its K-step
call as K of its one-step calls (scan == sequential, pinned by
tests/test_multistep.py), to compile one program a mode on the CPU.

- The loop: every dispatch of the port (its step, its K, the BatchNorm
  mode, its batches byte for byte) equals the JAX Solver's, and both
  end at step 10.
- The numbers: every step the port's Solver takes is held against one
  JAX train step (the JAX Solver's one-step program for that mode) from
  the port's state before it. The metric sums (loss, top-1, top-5, count)
  agree at rtol 2e-4, the bar of tests/test_golden_imagenet_path.py, and
  so do the epochs' train metrics against the sums of those JAX steps.
  Params, BN running stats and momentum agree per tensor within 1e-2 of
  the tensor's L2 norm.

Why not the elementwise rtol 2e-4 / atol 1e-6 on the state. Measured on
this run: 8 of the 10 synced steps hold it on every tensor; on the other
two (steps 1 and 5) the stem and first stages miss it, at most 3.1e-2 of
a tensor's largest entry and 7.4e-3 of its L2 norm. The JAX CPU reference
is the less accurate side there: against a float64 evaluation of the same
step at 64x64, the gradient of ``bn0_beta`` (a sum over N*H*W with heavy
cancellation) is off by 1.8e-3 of its norm in JAX and 5.7e-6 in the port.
Free-running fits part further still (a shared state's second step
already ends 10^2 times the elementwise bar apart), so the two Solvers'
final states are not compared.

Kill and resume is the port's alone and bitwise: a SIGTERM flag raised
in-process on either side of the bn-ema switch, then ``--auto-resume``,
must end bit-equal to the uninterrupted run (as tests/test_midepoch_resume.py
pins for the JAX package).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import resnet_tpu_torch.train.steps as port_steps
from resnet_tpu.config import Config as JaxConfig
from resnet_tpu.data.loader import MemoryIter as JaxMemoryIter
from resnet_tpu.data.loader import synthetic_cifar
from resnet_tpu.ops.metrics import MetricAccumulator as JaxMetricAccumulator
from resnet_tpu.train.callback import BatchEndParam as JaxBatchEndParam
from resnet_tpu.train.callback import Speedometer as JaxSpeedometer
from resnet_tpu.train.solver import Solver as JaxSolver
import resnet_tpu.train.state as jax_state_module
from resnet_tpu.utils.export import export_mxnet_params as jax_export
from resnet_tpu.utils.export import import_mxnet_params as jax_import
from resnet_tpu.utils.export import save_mxnet_style as jax_save_mxnet
from resnet_tpu_torch.config import Config
from resnet_tpu_torch.data.loader import MemoryIter
from resnet_tpu_torch.models.resnet import BatchNorm
from resnet_tpu_torch.train import checkpoint as ckpt
from resnet_tpu_torch.train.callback import BatchEndParam, Speedometer
from resnet_tpu_torch.train.solver import Solver
from resnet_tpu_torch.train.state import create_train_state
from resnet_tpu_torch.utils.export import (_tensors, export_mxnet_params,
                                           save_mxnet_style)

RTOL, ATOL = 2e-4, 1e-6
# a synced step's params, BN stats and momentum, per tensor, in L2 (why:
# module docstring)
STATE_L2 = 1e-2
N_EXAMPLES, BATCH, HW = 40, 8, 32


def _setup(cfg, prefix):
    d, m, t = cfg.data, cfg.model, cfg.train
    d.num_classes, d.num_examples, d.image_shape = 10, N_EXAMPLES, (HW, HW, 3)
    d.pipeline = "memory"
    d.rand_crop = d.rand_mirror = False
    d.random_h = d.random_s = d.random_l = 0
    m.depth = 18
    t.batch_size, t.steps_per_dispatch, t.num_epochs = BATCH, 2, 2
    t.bn_ema, t.bn_ema_warmup, t.num_devices = True, 3, 1
    t.dtype, t.model_prefix, t.frequent = "float32", prefix, 2
    t.lr = 0.01
    return cfg


def _data():
    return synthetic_cifar(N_EXAMPLES, 10, (HW, HW, 3), seed=0)


def _momentum_table(state):
    """MXNet name -> momentum buffer of a port state."""
    index = {id(p): i for i, p in enumerate(state.model.parameters())}
    return {name: state.momentum[index[id(t)]]
            for name, aux, t in _tensors(state.model) if not aux}


def _port_snapshot(state):
    """Copies: a numpy view of a CPU tensor shares its buffer, which the
    next step overwrites."""
    args, auxs = export_mxnet_params(state)
    mom = {k: v.numpy() for k, v in _momentum_table(state).items()}
    copy = lambda table: {k: np.array(v, copy=True) for k, v in table.items()}
    return {"args": copy(args), "auxs": copy(auxs), "mom": copy(mom),
            "step": state.step}


def _record_epochs(solver):
    out = []
    train_epoch = solver.train_epoch

    def wrapped(*a, **k):
        state = train_epoch(*a, **k)
        out.append(dict(solver.last_train_metrics))
        return state
    solver.train_epoch = wrapped
    return out


def _record_dispatches(solver, log, mode_of):
    """Route every dispatch of ``solver`` (the K-step call and the lazily
    built one-step call) through a recorder of (step, K, mode, batch)."""
    def wrap(fn, k):
        def step(state, batch):
            host = {name: np.array(v) for name, v in batch.items()}
            if k == 1:
                host = {name: v[None] for name, v in host.items()}
            log.append(dict(step=int(state.step), k=k, ema=mode_of(state),
                            batch=host))
            return fn(state, batch)
        return step
    solver.train_step = wrap(solver.train_step, solver._spd)
    make = solver._mk_step
    solver._mk_step = lambda k: wrap(make(k), k)


def _port_ema(state):
    modes = {m.ema for m in state.model.modules() if isinstance(m, BatchNorm)}
    assert len(modes) == 1
    return modes.pop()


def _numpy_init(monkeypatch):
    """The JAX Solver's initial variables drawn with numpy from their
    shapes (MSRA-scaled normal kernels, unit scales, zero shifts and
    means, unit variances): the JAX package's own init runs op by op or
    compiles, either costing the CPU tens of seconds. The port starts
    from whatever the JAX state holds."""
    get_model = jax_state_module.get_model
    rng = np.random.default_rng(0)

    def draw(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            fan_in = np.prod(leaf.shape[:-1])
            return jnp.asarray(rng.normal(0, np.sqrt(2.0 / fan_in),
                                          leaf.shape), leaf.dtype)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return jnp.full(leaf.shape, fill, leaf.dtype)

    def with_numpy_init(cfg):
        model = get_model(cfg)
        init = model.init
        object.__setattr__(model, "init", lambda *a, **k: (
            jax.tree_util.tree_map_with_path(draw, jax.eval_shape(
                lambda *a: init(*a, **k), *a))))
        return model
    monkeypatch.setattr(jax_state_module, "get_model", with_numpy_init)


def _sequential_calls(solver):
    """Run the JAX Solver's K-step call as K of its one-step calls, summing
    the metrics, as the scan does (tests/test_multistep.py pins scan ==
    sequential): one compiled program a BatchNorm mode instead of three,
    shared with the step-by-step reference below."""
    single = solver._mk_step(1)

    def make(k):
        if k == 1:
            return single

        def call(state, batches):
            total = None
            for i in range(k):
                state, m = single(state, jax.tree.map(lambda v: v[i],
                                                      batches))
                total = m if total is None else jax.tree.map(
                    lambda a, b: a + b, total, m)
            return state, total
        return call
    solver._mk_step = make
    solver.train_step = make(solver._spd)
    return single


def test_fit_loop_matches_jax_solver(tmp_path, monkeypatch):
    images, labels = _data()
    _numpy_init(monkeypatch)
    jcfg = _setup(JaxConfig(), "")
    jax_solver = JaxSolver(jcfg)
    jax_step = _sequential_calls(jax_solver)
    jax_epochs = _record_epochs(jax_solver)
    jax_log = []
    _record_dispatches(jax_solver, jax_log,
                       lambda s: s.apply_fn is jax_solver._bn_ema_apply)
    # the JAX-initialised state enters the port as an MXNet .params file,
    # written before the first (donating) dispatch
    prefix = str(tmp_path / "port")
    first = jax_solver.train_step

    def save_init(state, batch):
        if not jax_log:
            jax_save_mxnet(prefix, 0, state.params, state.batch_stats,
                           fmt="params")
        return first(state, batch)
    jax_solver.train_step = save_init
    jax_final = jax_solver.fit(JaxMemoryIter(images, labels, BATCH, seed=0),
                               None)

    # every single step the port takes, with the state around it
    port_steps_log = []
    one_step = port_steps.train_step

    def recording_step(state, batch, **kw):
        pre = _port_snapshot(state)
        ema = _port_ema(state)
        host = {k: v.numpy().copy() for k, v in batch.items()}
        state, m = one_step(state, batch, **kw)
        port_steps_log.append(dict(pre=pre, post=_port_snapshot(state),
                                   ema=ema, batch=host,
                                   metrics={k: v.item()
                                            for k, v in m.items()}))
        return state, m
    monkeypatch.setattr(port_steps, "train_step", recording_step)
    pcfg = _setup(Config(), prefix)
    pcfg.train.load_epoch = 0
    solver = Solver(pcfg, device="cpu")
    port_epochs = _record_epochs(solver)
    port_log = []
    _record_dispatches(solver, port_log, _port_ema)
    port_final = solver.fit(MemoryIter(images, labels, BATCH, seed=0), None)

    # the loop: 2 epochs of (2 + 2 + a one-step tail), the switch at step 4
    assert [(r["step"], r["k"], r["ema"]) for r in jax_log] == [
        (0, 2, False), (2, 2, False), (4, 1, True),
        (5, 2, True), (7, 2, True), (9, 1, True)]
    assert len(port_log) == len(jax_log)
    for i, (p, j) in enumerate(zip(port_log, jax_log)):
        assert (p["step"], p["k"], p["ema"]) == (j["step"], j["k"], j["ema"])
        assert set(p["batch"]) == set(j["batch"]), i
        for k in j["batch"]:
            np.testing.assert_array_equal(p["batch"][k], j["batch"][k],
                                          err_msg=f"dispatch {i} {k}")
    assert port_final.step == int(jax_final.step) == 10
    assert len(port_epochs) == len(jax_epochs) == 2

    # the numbers: each port step against one JAX step from its state
    apply_fns = {False: jax_solver._bn_ema_warmup_apply,
                 True: jax_solver._bn_ema_apply}
    assert len(port_steps_log) == 10
    # the JAX step donates its state: every call gets arrays of its own
    tmpl = jax.device_get((jax_final.params, jax_final.batch_stats))
    rng = np.array(jax_final.rng)
    epoch_sums = [JaxMetricAccumulator(), JaxMetricAccumulator()]
    for i, rec in enumerate(port_steps_log):
        pre = rec["pre"]
        params, stats = jax_import(pre["args"], pre["auxs"], *tmpl)
        mom, _ = jax_import(pre["mom"], pre["auxs"], *tmpl)
        opt = (jax_final.opt_state[0], jax_final.opt_state[1]._replace(
            count=jnp.asarray(pre["step"], jnp.int32), momentum=mom))
        state = jax_final.replace(step=jnp.asarray(pre["step"], jnp.int32),
                                  params=params, batch_stats=stats,
                                  opt_state=opt, rng=jnp.asarray(rng),
                                  apply_fn=apply_fns[rec["ema"]])
        state, m = jax_step(state, {k: jnp.asarray(v)
                                    for k, v in rec["batch"].items()})
        args, auxs = jax_export(state.params, state.batch_stats)
        moms, _ = jax_export(state.opt_state[1].momentum, state.batch_stats)
        assert rec["post"]["step"] == int(state.step) == pre["step"] + 1
        for part, want in (("args", args), ("auxs", auxs), ("mom", moms)):
            for name, w in want.items():
                err = np.linalg.norm(rec["post"][part][name] - w)
                assert err <= STATE_L2 * np.linalg.norm(w), \
                    f"step {i} {part} {name}: {err / np.linalg.norm(w)}"
        m = jax.device_get(m)
        for k, w in m.items():
            np.testing.assert_allclose(rec["metrics"][k], w, rtol=RTOL,
                                       err_msg=f"step {i} {k}")
        epoch_sums[i // (N_EXAMPLES // BATCH)].update(m)
    # the epochs' train metrics, against the JAX steps' sums
    for got, want in zip(port_epochs, epoch_sums):
        for k, w in want.get().items():
            np.testing.assert_allclose(got[k], w, rtol=RTOL, err_msg=k)


# -- the port alone ----------------------------------------------------------

def _port_cfg(prefix, num_epochs=2):
    cfg = _setup(Config(), prefix)
    cfg.train.num_epochs = num_epochs
    cfg.train.lr = 0.05
    return cfg


class _InterruptingIter(MemoryIter):
    """Raises the solver's SIGTERM flag when batch ``at`` of epoch
    ``epoch`` is PRODUCED: an in-process stand-in for an external kill."""

    def __init__(self, *a, solver=None, epoch=0, at=1, **k):
        super().__init__(*a, **k)
        self.solver, self.kill_epoch, self.at = solver, epoch, at

    def epoch_iter(self, epoch):
        for i, b in enumerate(super().epoch_iter(epoch)):
            if epoch == self.kill_epoch and i == self.at:
                self.solver._sigterm = True
            yield b


def _assert_states_equal(a, b):
    assert a.step == b.step
    for (ka, va), (kb, vb) in zip(a.model.state_dict().items(),
                                  b.model.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    for ma, mb in zip(a.momentum, b.momentum):
        assert torch.equal(ma, mb)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    images, labels = _data()
    prefix = str(tmp_path_factory.mktemp("ref") / "ref")
    return Solver(_port_cfg(prefix), device="cpu").fit(
        MemoryIter(images, labels, BATCH, seed=0), None)


@pytest.mark.parametrize("kill_epoch,at,switched", [(0, 1, False),
                                                    (1, 2, True)],
                         ids=["kill_in_warmup", "kill_after_switch"])
def test_kill_and_resume_is_bit_equal(tmp_path, uninterrupted, kill_epoch,
                                      at, switched):
    images, labels = _data()
    ref = uninterrupted

    cfg = _port_cfg(str(tmp_path / "killed"))
    solver = Solver(cfg, device="cpu")
    it = _InterruptingIter(images, labels, BATCH, seed=0, solver=solver,
                           epoch=kill_epoch, at=at)
    with pytest.raises(SystemExit) as exc:
        solver.fit(it, None)
    assert exc.value.code == 143
    assert (solver._host_step > solver._bn_ema_switch) == switched
    assert ckpt.latest_epoch(cfg.train.model_prefix) == kill_epoch

    cfg2 = _port_cfg(str(tmp_path / "killed"))
    cfg2.train.auto_resume = True
    solver2 = Solver(cfg2, device="cpu")
    resumed = solver2.fit(MemoryIter(images, labels, BATCH, seed=0), None)
    assert solver2._bn_ema_pending is False
    assert all(m.ema for m in resumed.model.modules()
               if isinstance(m, BatchNorm))
    _assert_states_equal(resumed, ref)


def test_profile_env_traces_the_first_epoch(tmp_path, monkeypatch):
    logdir = tmp_path / "trace"
    monkeypatch.setenv("RESNET_TPU_PROFILE", str(logdir))
    cfg = _port_cfg("", num_epochs=2)
    cfg.data.num_examples = 2 * BATCH
    images, labels = _data()
    Solver(cfg, device="cpu").fit(
        MemoryIter(images[:2 * BATCH], labels[:2 * BATCH], BATCH, seed=0),
        None)
    traces = list(logdir.glob("*.pt.trace.json.gz"))
    assert len(traces) == 1    # the first epoch only


def test_check_numerics_stops_on_a_non_finite_loss():
    cfg = _port_cfg("", num_epochs=1)
    cfg.train.check_numerics = True
    solver = Solver(cfg, device="cpu")
    step = solver.train_step

    def poisoned(state, batch):
        state, m = step(state, batch)
        return state, dict(m, loss_sum=m["loss_sum"] * float("nan"))
    solver.train_step = poisoned
    images, labels = _data()
    with pytest.raises(FloatingPointError, match="step 0"):
        solver.fit(MemoryIter(images, labels, BATCH, seed=0), None)
    assert not torch.is_anomaly_enabled()


def test_checkpoint_frequent_saves_mid_epoch(tmp_path):
    cfg = _port_cfg(str(tmp_path / "freq"), num_epochs=1)
    cfg.train.checkpoint_frequent = 3
    images, labels = _data()
    Solver(cfg, device="cpu").fit(MemoryIter(images, labels, BATCH, seed=0),
                                  None)
    # dispatches end at batches 2, 4 and 5: only 4 crosses a multiple of 3.
    # That save went to epoch 0's file with the cursor; the epoch end to 1.
    prefix = cfg.train.model_prefix
    assert ckpt.latest_epoch(prefix) == 1
    state = create_train_state(cfg, device="cpu")
    state, iter_state = ckpt.load_checkpoint(prefix, 0, state)
    assert iter_state == {"epoch": 0, "batch": 4}
    assert state.step == 4
    _, iter_state = ckpt.load_checkpoint(prefix, 1, state)
    assert iter_state == {"epoch": 0, "batch": 5} and state.step == 5


def test_max_to_keep_and_overwrite(tmp_path):
    cfg = _port_cfg(str(tmp_path / "keep"))
    state = create_train_state(cfg, device="cpu")
    prefix = cfg.train.model_prefix
    for epoch in (1, 2, 3):
        state.step = epoch
        ckpt.save_checkpoint(prefix, epoch, state, max_to_keep=2)
    assert ckpt.latest_epoch(prefix) == 3
    assert not ckpt.has_epoch(prefix, 1) and ckpt.has_epoch(prefix, 2)
    state.step = 7
    ckpt.save_checkpoint(prefix, 3, state, iter_state={"batch": 1})
    fresh = create_train_state(cfg, device="cpu")
    fresh, iter_state = ckpt.load_checkpoint(prefix, 3, fresh)
    assert fresh.step == 7 and iter_state == {"batch": 1}
    assert sorted(p.name for p in (tmp_path / "keep").iterdir()) == \
        ["2.pt", "3.pt"]


def test_params_resume_sets_step_and_zero_momentum(tmp_path):
    cfg = _port_cfg(str(tmp_path / "mx"))
    src = create_train_state(cfg, device="cpu")
    with torch.no_grad():
        for p in src.model.parameters():
            p.add_(0.5)
    save_mxnet_style(cfg.train.model_prefix, 1, src, fmt="params")
    cfg.train.load_epoch = 1
    solver = Solver(cfg, device="cpu")
    state = solver.init_state()
    assert solver.begin_epoch == 1
    assert state.step == 1 * (N_EXAMPLES // BATCH)
    assert all(not m.any() for m in state.momentum)
    for a, b in zip(src.model.state_dict().values(),
                    state.model.state_dict().values()):
        assert torch.equal(a, b)


def test_speedometer_line_matches_jax(monkeypatch, caplog):
    clock = iter(np.arange(0.0, 100.0, 0.5))
    monkeypatch.setattr("time.perf_counter", lambda: float(next(clock)))
    lines = {}
    for name, meter, param in (
            ("resnet_tpu", JaxSpeedometer(32, 2, auto_reset=True),
             JaxBatchEndParam),
            ("resnet_tpu_torch", Speedometer(32, 2, auto_reset=True),
             BatchEndParam)):
        logger = logging.getLogger(name)
        monkeypatch.setattr(logger, "propagate", True)
        caplog.clear()
        resets = []
        with caplog.at_level(logging.INFO, logger=name):
            for nb in (2, 4, 5, 7, 9):
                meter(param(epoch=3, nbatch=nb,
                            metrics={"accuracy": 0.25,
                                     "cross-entropy": 1.5}, lr=0.1),
                      reset_fn=lambda: resets.append(nb))
        lines[name] = ([r.getMessage() for r in caplog.records
                        if r.name == name], resets)
    assert lines["resnet_tpu_torch"] == lines["resnet_tpu"]
    assert lines["resnet_tpu"][0][0].startswith(
        "Epoch[3] Batch [4]\tSpeed: 128.00 samples/sec\taccuracy=0.250000")
