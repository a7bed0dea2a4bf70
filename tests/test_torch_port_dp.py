"""The port's data-parallel train step over 2 gloo ranks against the JAX
package's over a 2-device mesh.

Two ranks of the port (this file run as a script: they import no JAX) are
spawned once for the module. Each starts from one state, written by the
port and carried to both sides by the weight bridge, trains its block of
one global batch of 8 CIFAR images at 16x16 (the ResNet of depth 8, the
smallest 6n+2 net, as tests/test_dp_sync.py cuts it), and writes its
params, momentum, BN running stats and metric sums to an ``.npz``. The
JAX side runs its ``make_train_step`` on the same state and batch over
``make_mesh(2)`` (tests/conftest.py's virtual CPU devices), with its own
augmentation; the ranks take the rows of values that augmentation draws
(its key folded with the step, and under ``shard_map`` with the replica),
so both sides see the same images.

Held against JAX at rtol 2e-4 / atol 1e-6, the bar of
tests/test_golden_imagenet_path.py: ``shard_map`` in float32 and with
bf16 gradient communication, ``jit`` (global-batch BN) in full-batch,
bn-ema and ``bn_subsample=2``, and ``dispatch`` with K=3. Held within
the port: the two ranks' states are bit-equal, ``dispatch`` at K=1 equals
step-sync, every BatchNorm mode and the xla chain of a bottleneck unit
under a group equal the one-process module on the global batch,
``Solver.validate`` over the ranks' uneven, padded parts equals one
process's over the whole split, and the guards that need two ranks raise
where JAX raises.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD, BATCH, HW, K = 2, 8, 16, 3
LR = 0.05
TOL = dict(rtol=2e-4, atol=1e-6)
# bf16 communication: the largest ratio, per tensor, of the L2 distance
# between the two sides' updates to the distance between the port's
# float32 update and JAX's bf16 one (test_step_matches_jax_mesh)
BF16_GAP = 0.25
# dispatch K=3: three unsynchronized steps at lr 0.05 carry the stem's
# parting past the elementwise bar (conv0_weight, bn0_beta: at most
# 2.4e-3 of the tensor's L2 norm). Those are the tensors whose float32
# sums part in the JAX CPU reference on a train step (ROADMAP Queue 3);
# they are held, as tests/test_torch_port_solver.py holds them, within
# 1e-2 of the tensor's L2 norm
STEM_L2 = ("dispatch_k3",)
STATE_L2 = 1e-2
# (name, dp_mode, steps a call, dp_sync, comm dtype, train overrides)
CASES = {
    "shard_map": ("shard_map", 1, "step", None, {}),
    "shard_map_bf16_comm": ("shard_map", 1, "step", "bfloat16", {}),
    "jit": ("jit", 1, "step", None, {}),
    "jit_bn_ema": ("jit", 1, "step", None, {"bn_ema": True}),
    "jit_bn_subsample2": ("jit", 1, "step", None, {"bn_subsample": 2}),
    "dispatch_k3": ("shard_map", K, "dispatch", None, {}),
    "dispatch_k1": ("shard_map", 1, "dispatch", None, {}),
}
JAX_CASES = [c for c in CASES if c != "dispatch_k1"]
BN_MODES = {
    "full": {}, "ema": {"ema": True}, "subsample2": {"subsample": 2},
    "subsample8": {"subsample": 8}, "stride2": {"stat_stride": 2},
    "grouped2": {"grouped": True, "subsample": 2},
    "grouped4_stride2": {"grouped": True, "subsample": 4, "stat_stride": 2},
}


def _val_cfg():
    """The in-memory val split of 9 images (``make_val_iter``: a tenth of
    ``num_examples``, at least a global batch of 8)."""
    cfg = _cfg()
    cfg.data.pipeline, cfg.data.num_examples = "memory", 90
    return cfg


def _cfg(**train):
    from resnet_tpu_torch.config import Config
    cfg = Config()
    cfg.data.num_classes, cfg.data.image_shape = 10, (HW, HW, 3)
    cfg.model.depth, cfg.model.dataset = 8, "cifar10"
    cfg.train.batch_size, cfg.train.lr = BATCH, LR
    for k, v in train.items():
        setattr(cfg.train, k, v)
    return cfg


# ---------------------------------------------------------------------------
# The ranks (no JAX): python tests/test_torch_port_dp.py <workdir>
# ---------------------------------------------------------------------------

def _rank_state(cfg, args, auxs, group):
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.utils.export import load_mxnet_params
    model = get_model(cfg, bn_group=group)
    load_mxnet_params(model, args, auxs)
    return create_train_state(cfg, device="cpu", model=model)


def _snapshot(prefix, state, metrics):
    from resnet_tpu_torch.utils.export import _tensors, export_mxnet_params
    args, auxs = export_mxnet_params(state)
    out = {f"{prefix}/arg:{k}": v for k, v in args.items()}
    out.update({f"{prefix}/aux:{k}": v for k, v in auxs.items()})
    index = {id(p): i for i, p in enumerate(state.model.parameters())}
    for name, aux, t in _tensors(state.model):
        if not aux:
            out[f"{prefix}/mom:{name}"] = \
                state.momentum[index[id(t)]].numpy().copy()
    out.update({f"{prefix}/metric:{k}": float(v) for k, v in metrics.items()})
    return out


def _bn_mode_checks(rank, group):
    """Each BatchNorm mode under ``group`` against the same module without
    one on the global batch: outputs, input and parameter gradients,
    running statistics."""
    from resnet_tpu_torch.models.resnet import BatchNorm
    from resnet_tpu_torch.parallel.dist import all_reduce_sum
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(BATCH, 6, 4, 4, generator=gen) * 2 + 1
    gy = torch.randn(BATCH, 6, 4, 4, generator=gen)
    block = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
    out = {}
    for name, kw in BN_MODES.items():
        runs = []
        for g, xs, gys in ((None, x, gy), (group, x[block], gy[block])):
            bn = BatchNorm(6, group=g, **kw)
            with torch.no_grad():
                bn.weight.uniform_(0.5, 1.5, generator=torch.Generator()
                                   .manual_seed(4))
            bn.train()
            xi = xs.clone().requires_grad_()
            y = bn(xi)
            y.backward(gys)
            pg = torch.cat([bn.weight.grad, bn.bias.grad])
            if g is not None:
                pg = all_reduce_sum(pg, g)
            runs.append((y.detach(), xi.grad, pg, bn.running_mean,
                         bn.running_var))
        (y1, gx1, pg1, rm1, rv1), (y2, gx2, pg2, rm2, rv2) = runs
        for part, a, b in (("y", y1[block], y2), ("gx", gx1[block], gx2),
                           ("gparams", pg1, pg2), ("mean", rm1, rm2),
                           ("var", rv1, rv2)):
            out[f"bn/{name}/{part}/want"] = a.numpy().copy()
            out[f"bn/{name}/{part}/got"] = b.numpy().copy()
    return out


def _chain_checks(rank, group):
    """The xla chain of a bottleneck unit whose BatchNorms carry ``group``
    against the same unit without one on the global batch: output, input
    and parameter gradients, running statistics."""
    from resnet_tpu_torch.models.resnet import Conv, ResidualUnit
    from resnet_tpu_torch.parallel.dist import all_reduce_sum
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(BATCH, 8, 6, 6, generator=gen) * 2 + 1
    gy = torch.randn(BATCH, 16, 3, 3, generator=gen)
    block = slice(rank * BATCH // WORLD, (rank + 1) * BATCH // WORLD)
    runs = []
    for g, xs, gys in ((None, x, gy), (group, x[block], gy[block])):
        unit = ResidualUnit(8, 16, 2, False, True, {"group": g},
                            unit_chain="xla")
        init = torch.Generator().manual_seed(6)
        for mod in unit.modules():
            if isinstance(mod, Conv):
                mod.reset_parameters(init)
        unit.train()
        xi = xs.clone().requires_grad_()
        y = unit(xi)
        y.backward(gys)
        pg = torch.cat([p.grad.flatten() for p in unit.parameters()])
        if g is not None:
            pg = all_reduce_sum(pg, g)
        stats = torch.cat([b.flatten() for b in unit.buffers()])
        runs.append((y.detach(), xi.grad, pg, stats))
    (y1, gx1, pg1, st1), (y2, gx2, pg2, st2) = runs
    out = {}
    for part, a, b in (("y", y1[block], y2), ("gx", gx1[block], gx2),
                       ("gparams", pg1, pg2), ("stats", st1, st2)):
        out[f"chain/{part}/want"] = a.numpy().copy()
        out[f"chain/{part}/got"] = b.numpy().copy()
    return out


def _validate(group):
    """``Solver.validate`` on this rank's part of the in-memory val split:
    9 images, so rank 0 holds 5 (two batches of 4, the second padded) and
    rank 1 four (one batch)."""
    from resnet_tpu_torch.data.loader import make_val_iter
    from resnet_tpu_torch.parallel.dist import proc_info
    from resnet_tpu_torch.train.solver import Solver
    world, rank = proc_info()
    cfg = _val_cfg()
    solver = Solver(cfg, device="cpu")
    val = make_val_iter(cfg, world, rank)
    m = solver.validate(solver.init_state(), val, 0)
    out = {f"val/{k}": v for k, v in m.items()}
    out["val_batches"] = len(list(val.epoch_iter(0)))
    return out


def _guards(group):
    """The guards that need more than one rank: message, or '' if none
    raised."""
    from resnet_tpu_torch.config import Config
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.train.solver import Solver
    from resnet_tpu_torch.train.steps import make_train_step
    out = {}

    def check(name, fn):
        try:
            fn()
            out[f"guard/{name}"] = ""
        except ValueError as e:
            out[f"guard/{name}"] = str(e)

    def solver(augment_impl="auto", **train):
        cfg = _cfg(**train)
        cfg.model.dataset, cfg.model.depth = "imagenet", 18
        cfg.data.augment_impl = augment_impl
        return lambda: Solver(cfg, device="cpu")

    check("batch_not_divisible", solver(batch_size=7))
    check("num_devices_not_world", solver(num_devices=4))
    check("sync_bn_shard_map", solver(sync_bn=True, dp_mode="shard_map"))
    check("pallas_augment_jit", solver("pallas", dp_mode="jit"))
    check("auto_augment_jit", solver(dp_mode="jit"))
    check("pallas_augment_shard_map", solver("pallas", dp_mode="shard_map"))
    check("dispatch_jit", lambda: make_train_step(
        group=group, dp_mode="jit", dp_sync="dispatch"))
    for flags in ({"fused_convbn": True}, {"unit_chain": "pallas"},
                  {"unit_chain": "xla"}):
        cfg = Config()
        for k, v in flags.items():
            setattr(cfg.train, k, v)
        check("jit_" + "_".join(map(str, flags.values())),
              lambda: get_model(cfg, bn_group=group))
    return out


def _rank_main(workdir):
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.parallel.dist import (finalize_distributed,
                                                maybe_init_distributed,
                                                proc_info, world_group)
    from resnet_tpu_torch.parallel.mesh import replica_block
    from resnet_tpu_torch.train.steps import make_train_step
    torch.set_num_threads(2)
    maybe_init_distributed("cpu")
    world, rank = proc_info()
    group = world_group()
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    args = {k[4:]: inp[k] for k in inp.files if k.startswith("arg:")}
    auxs = {k[4:]: inp[k] for k in inp.files if k.startswith("aux:")}
    block = replica_block(BATCH, rank, world)
    out = {}
    for case, (mode, k, dp_sync, comm, train) in CASES.items():
        cfg = _cfg(**train)
        state = _rank_state(cfg, args, auxs,
                            group if mode == "jit" else None)
        step = make_train_step(
            augment_fn=make_augment_fn(cfg), steps_per_dispatch=k,
            group=group, dp_mode=mode, dp_sync=dp_sync,
            comm_dtype=None if comm is None else getattr(torch, comm))
        rows = (inp[f"rows/{case}"][:, rank] if mode == "shard_map"
                else inp[f"rows/{case}"][:, block])
        batch = {"image": torch.from_numpy(inp["image"][:k, block]),
                 "label": torch.from_numpy(inp["label"][:k, block]),
                 "rows": torch.from_numpy(rows[:k])}
        if k == 1:
            batch = {name: v[0] for name, v in batch.items()}
        state, metrics = step(state, batch)
        out.update(_snapshot(case, state, metrics))
    out.update(_validate(group))
    out.update(_bn_mode_checks(rank, group))
    out.update(_chain_checks(rank, group))
    guards = _guards(group)
    finalize_distributed()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out,
             **{k: np.array(v) for k, v in guards.items()})


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1])
    sys.exit(0)


# ---------------------------------------------------------------------------
# The test process: inputs, the ranks, the JAX side
# ---------------------------------------------------------------------------

def spawn_ranks(cmd, world, timeout, workdir):
    """Run ``cmd`` as ``world`` ranks of one process group, rank r's output
    in ``workdir/rank{r}.log``; returns the outputs. A rank that fails, or
    a run past ``timeout`` (a hung collective), kills every rank and fails
    the test."""
    from resnet_tpu_torch.tools.launch import ENV_KEYS, free_port, wait_all
    coord = f"127.0.0.1:{free_port()}"
    paths = [pathlib.Path(workdir) / f"rank{r}.log" for r in range(world)]
    procs = []
    for rank, path in enumerate(paths):
        env = dict(os.environ, OMP_NUM_THREADS="2")
        env.update(zip(ENV_KEYS, (coord, str(world), str(rank))))
        with open(path, "w") as log:
            procs.append(subprocess.Popen(cmd, env=env, cwd=ROOT, stdout=log,
                                          stderr=subprocess.STDOUT))
    try:
        rc = wait_all(procs, timeout=timeout)
    except TimeoutError as e:
        pytest.fail(str(e))
    outs = [p.read_text() for p in paths]
    assert rc == 0, "\n".join(o[-3000:] for o in outs)
    return outs


def _jax_cifar_rows(key, cfg, n):
    """The values the JAX ``augment_cifar`` draws from ``key``, as the
    port's (n, 5) rows: dy, dx, flip, alpha, beta."""
    import jax
    import jax.numpy as jnp
    pad = int(cfg.pad)
    r_crop, r_mirror = jax.random.split(key)
    dy = jax.random.randint(r_crop, (n,), 0, 2 * pad + 1)
    dx = jax.random.randint(jax.random.fold_in(r_crop, 1), (n,), 0,
                            2 * pad + 1)
    flip = (jax.random.bernoulli(r_mirror, 0.5, (n,)) if cfg.rand_mirror
            else jnp.zeros((n,), bool))
    return np.stack([np.asarray(v, np.float32) for v in
                     (dy, dx, flip, np.ones(n), np.zeros(n))], 1)


def _jax_cfg(case):
    from resnet_tpu.config import Config as JaxConfig
    cfg = JaxConfig()
    cfg.data.num_classes, cfg.data.image_shape = 10, (HW, HW, 3)
    cfg.model.depth, cfg.model.dataset = 8, "cifar10"
    cfg.train.batch_size, cfg.train.lr = BATCH, LR
    for k, v in CASES[case][4].items():
        setattr(cfg.train, k, v)
    return cfg


def _jax_state(cfg, args, auxs):
    """The JAX package's ``create_train_state`` with the bridge's weights
    in place of its own init (the variable tree from ``eval_shape``)."""
    import jax
    import jax.numpy as jnp
    import optax
    from resnet_tpu.models.registry import get_model
    from resnet_tpu.train.optim import mxnet_sgd, radial_projection
    from resnet_tpu.train.schedule import schedule_from_config
    from resnet_tpu.train.state import TrainState
    from resnet_tpu.utils.export import import_mxnet_params
    model = get_model(cfg)
    key = jax.random.key(cfg.train.seed)
    shapes = jax.eval_shape(lambda: model.init(
        key, jnp.zeros((1, HW, HW, 3)), train=False))
    params, stats = import_mxnet_params(args, auxs, shapes["params"],
                                        shapes["batch_stats"])
    tx = mxnet_sgd(schedule_from_config(cfg), momentum=cfg.train.mom,
                   weight_decay=cfg.train.wd)
    if cfg.train.bn_ema:
        tx = optax.chain(radial_projection(), tx)
    return TrainState(step=jnp.zeros([], jnp.int32), params=params,
                      batch_stats=stats, opt_state=tx.init(params),
                      rng=jax.random.key_data(jax.random.fold_in(key, 1)),
                      apply_fn=model.apply, tx=tx)


def _rows(case, base_key, cfg):
    """(steps, 2, 4, 5) per-replica rows (shard_map) or (steps, 8, 5)
    global rows (jit), as the JAX step draws them."""
    import jax
    mode, k = CASES[case][:2]
    per_step = []
    for s in range(K):
        key = jax.random.fold_in(base_key, s)
        if mode == "shard_map":
            per_step.append(np.stack([_jax_cifar_rows(
                jax.random.fold_in(key, r), cfg.data, BATCH // WORLD)
                for r in range(WORLD)]))
        else:
            per_step.append(_jax_cifar_rows(key, cfg.data, BATCH))
    return np.stack(per_step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' results, the inputs and the initial weights."""
    import jax
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.utils.export import export_mxnet_params
    work = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    args, auxs = export_mxnet_params(get_model(_cfg()))
    inputs = {"image": rng.integers(0, 256, (K, BATCH, HW, HW, 3), np.uint8),
              "label": rng.integers(0, 10, (K, BATCH)).astype(np.int64)}
    for case in CASES:
        cfg = _jax_cfg(case if case in JAX_CASES else "shard_map")
        base = jax.random.wrap_key_data(_jax_state_rng(cfg))
        inputs[f"rows/{case}"] = _rows(case, base, cfg)
    inputs.update({f"arg:{k}": v for k, v in args.items()})
    inputs.update({f"aux:{k}": v for k, v in auxs.items()})
    np.savez(work / "inputs.npz", **inputs)
    spawn_ranks([sys.executable, __file__, str(work)], WORLD, 240, work)
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(WORLD)]
    return {"ranks": ranks, "inputs": inputs, "args": args, "auxs": auxs}


def _jax_state_rng(cfg):
    import jax
    return jax.random.key_data(jax.random.fold_in(
        jax.random.key(cfg.train.seed), 1))


def _case(rank_out, case):
    p = f"{case}/"
    return {k[len(p):]: v for k, v in rank_out.items() if k.startswith(p)}


@pytest.mark.parametrize("case", list(CASES))
def test_ranks_hold_one_state(runs, case):
    a, b = (_case(r, case) for r in runs["ranks"])
    assert a.keys() == b.keys() and a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("case", JAX_CASES)
def test_step_matches_jax_mesh(runs, case):
    import jax
    import jax.numpy as jnp
    from resnet_tpu.ops import augment as jax_augment
    from resnet_tpu.parallel.mesh import (batch_sharded, make_mesh,
                                          stacked_batch_sharded)
    from resnet_tpu.train.steps import make_train_step as jax_make_step
    from resnet_tpu.utils.export import export_mxnet_params as jax_export
    mode, k, dp_sync, comm, _ = CASES[case]
    cfg = _jax_cfg(case)
    mesh = make_mesh(WORLD)
    aug = lambda imgs, rng, dims=None: jax_augment.augment_cifar(
        imgs, rng, cfg.data, jnp.float32)
    step = jax_make_step(mesh, dp_mode=mode, augment_fn=aug,
                         steps_per_dispatch=k, dp_sync=dp_sync,
                         comm_dtype=None if comm is None else jnp.bfloat16)
    inp = runs["inputs"]
    batch = {"image": inp["image"][:k], "label":
             inp["label"][:k].astype(np.int32)}
    if k == 1:
        batch = jax.device_put({n: v[0] for n, v in batch.items()},
                               batch_sharded(mesh))
    else:
        batch = jax.device_put(batch, stacked_batch_sharded(mesh))
    state, metrics = step(_jax_state(cfg, runs["args"], runs["auxs"]), batch)
    got = _case(runs["ranks"][0], case)
    for name, v in jax.device_get(metrics).items():
        np.testing.assert_allclose(got[f"metric:{name}"], v, err_msg=name,
                                   **TOL)
    args, auxs = jax_export(state.params, state.batch_stats)
    mom, _ = jax_export(state.opt_state[-1].momentum if cfg.train.bn_ema
                        else state.opt_state.momentum, state.batch_stats)
    f32 = _case(runs["ranks"][0], "shard_map")
    for prefix, table in (("arg", args), ("aux", auxs), ("mom", mom)):
        for name, want in table.items():
            have, key = got[f"{prefix}:{name}"], f"{prefix}:{name}"
            if comm == "bfloat16" and prefix != "aux":
                # each rank's gradient and their sum are rounded to bf16
                # on both sides, from float32 gradients that agree to
                # ~1e-6, so a few roundings land a step apart (a step of
                # the larger local gradient, not of the mean). Per tensor:
                # the port's update lies far closer to JAX's bf16 one than
                # its own float32 update does (measured 0.057 at worst);
                # an update that skipped or misplaced the rounding would
                # lie as far
                gap = np.linalg.norm(have - want)
                assert gap <= BF16_GAP * np.linalg.norm(f32[key] - want), key
            elif case in STEM_L2 and name.startswith(("conv0_", "bn0_")):
                np.testing.assert_allclose(
                    np.linalg.norm(have - want) / np.linalg.norm(want), 0,
                    atol=STATE_L2, err_msg=key)
            else:
                np.testing.assert_allclose(have, want, err_msg=key, **TOL)
    if comm == "bfloat16":
        # and the communication did round: float32's update differs
        assert any(not np.array_equal(got[k], f32[k]) for k in got
                   if k.startswith("mom:"))


def test_dispatch_k1_equals_step_sync(runs):
    """The update is linear in the gradient: averaging the updated states
    equals updating with the averaged gradient, to rounding."""
    rank0 = runs["ranks"][0]
    step, disp = _case(rank0, "shard_map"), _case(rank0, "dispatch_k1")
    assert step.keys() == disp.keys()
    for k in step:
        np.testing.assert_allclose(disp[k], step[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("rank", range(WORLD))
def test_validate_sums_over_ranks_with_padding_mask(runs, rank):
    """Each rank's ``Solver.validate`` over its uneven, padded part equals
    one process's over the whole split."""
    from resnet_tpu_torch.data.loader import make_val_iter
    from resnet_tpu_torch.train.solver import Solver
    cfg = _val_cfg()
    solver = Solver(cfg, device="cpu")
    val = make_val_iter(cfg)
    want = solver.validate(solver.init_state(), val, 0)
    got = {k[4:]: v for k, v in runs["ranks"][rank].items()
           if k.startswith("val/")}
    assert [int(r["val_batches"]) for r in runs["ranks"]] == [2, 1]
    assert got.keys() == want.keys() and got
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=1e-6, err_msg=key)


@pytest.mark.parametrize("part", ["y", "gx", "gparams", "stats"])
def test_xla_chain_under_group_equals_global_batch(runs, part):
    """float32 sums in another order: rtol 1e-5, and an absolute floor of
    1e-6 of the tensor's largest value for entries that cancel (the
    parameter gradients reach 9)."""
    for out in runs["ranks"]:
        want = out[f"chain/{part}/want"]
        np.testing.assert_allclose(out[f"chain/{part}/got"], want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max(),
                                   err_msg=part)


@pytest.mark.parametrize("mode", list(BN_MODES))
@pytest.mark.parametrize("rank", range(WORLD))
def test_batchnorm_group_equals_global_batch(runs, mode, rank):
    out = runs["ranks"][rank]
    for part in ("y", "gx", "gparams", "mean", "var"):
        np.testing.assert_allclose(out[f"bn/{mode}/{part}/got"],
                                   out[f"bn/{mode}/{part}/want"],
                                   rtol=1e-5, atol=1e-6, err_msg=part)


def _jax_guard(guard):
    """The JAX package's counterpart of a guard: a callable, or None where
    it has none that raises in one process (the fused ops under GSPMD fail
    only in the TPU compile)."""
    from resnet_tpu.parallel.mesh import make_mesh
    from resnet_tpu.train.solver import Solver as JaxSolver
    from resnet_tpu.train.steps import make_train_step as jax_make_step

    def solver(augment_impl="auto", **train):
        cfg = _jax_cfg("jit")
        cfg.model.dataset, cfg.model.depth = "imagenet", 18
        cfg.data.augment_impl = augment_impl
        cfg.train.num_devices = WORLD
        for k, v in train.items():
            setattr(cfg.train, k, v)
        return lambda: JaxSolver(cfg)

    return {
        "batch_not_divisible": solver(batch_size=7),
        "num_devices_not_world": lambda: make_mesh(9),
        "sync_bn_shard_map": solver(sync_bn=True, dp_mode="shard_map"),
        "pallas_augment_jit": solver("pallas", dp_mode="jit"),
        "auto_augment_jit": solver(dp_mode="jit"),
        "pallas_augment_shard_map": solver("pallas", dp_mode="shard_map"),
        "dispatch_jit": lambda: jax_make_step(make_mesh(WORLD), dp_mode="jit",
                                              dp_sync="dispatch"),
    }.get(guard)


@pytest.mark.parametrize("guard,match", [
    ("batch_not_divisible", "not divisible by 2 devices"),
    ("num_devices_not_world", "requested 4 devices"),
    ("sync_bn_shard_map", "sync_bn requires --dp-mode jit"),
    ("pallas_augment_jit", "cannot run under GSPMD jit"),
    ("auto_augment_jit", None),
    ("pallas_augment_shard_map", None),
    ("dispatch_jit", "requires --dp-mode shard_map"),
    ("jit_True", "--fused-convbn and --unit-chain pallas"),
    ("jit_pallas", "--fused-convbn and --unit-chain pallas"),
    ("jit_xla", None),
])
def test_guards_of_two_ranks_raise_where_jax_raises(runs, guard, match):
    msg = str(runs["ranks"][0][f"guard/{guard}"])
    jax_fn = _jax_guard(guard)
    if match is None:
        assert msg == ""
        if jax_fn is not None:
            jax_fn()
        return
    assert match in msg, msg
    if jax_fn is not None:
        with pytest.raises(ValueError, match=(
                "requested 9 devices" if guard == "num_devices_not_world"
                else match)):
            jax_fn()
