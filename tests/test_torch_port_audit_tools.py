"""The port's audit tools (``utils/op_count.py``, ``tools/cost_probe.py``,
``pod_compile_probe.py``, ``serving_pod_probe.py``, ``quant_probe.py``,
``aug_fusion_probe.py``), the compile-check entry (``dryrun.py::entry``)
and ``ema_equivalence``'s committed digits, on the CPU, held against the
JAX package wherever JAX computes the same quantity:

  - the counted FLOPs of the CIFAR ResNet-8 train step (float32, batch 8,
    no augmentation) against XLA's ``cost_analysis()`` of the JAX step,
    from one JAX-initialised state carried by the weight bridge: within
    2% (XLA also counts elementwise work, which the torch formulas leave
    out); the two steps' losses agree at 1e-5;
  - the eager bytes of a lone ``torch.mm``; the hand-written kernels'
    reported FLOPs against their plain versions' aten ops;
  - the ``xla`` and ``pallas`` unit-chain variants against ``off``;
  - the collectives a fake group's rank 0 counts against a real 2-rank
    gloo run (this file run as a rank, ``python tests/test_torch_port_
    audit_tools.py <dir>``, which imports no JAX);
  - the serving scan, on a real artifact and on a graph with one
    inserted all-reduce;
  - ``entry()``'s helper against JAX's ``model.apply(..., train=False)``;
  - the int8 conv leg of ``quant_probe`` against JAX's int32 conv.
"""

from __future__ import annotations

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLD = 2
DP_MODES = ("shard_map", "jit")


def _cifar8(batch, dtype="float32"):
    from resnet_tpu_torch.config import cifar10_resnet18
    cfg = cifar10_resnet18()
    cfg.model.depth = 8
    cfg.train.batch_size = batch
    cfg.train.dtype = dtype
    return cfg


def _dp_cfg(mode):
    """CIFAR ResNet-8, 4 images a rank, in ``mode``."""
    cfg = _cifar8(4 * WORLD)
    cfg.train.dp_mode = mode
    cfg.train.num_devices = WORLD
    return cfg


def _collectives(counter):
    return [[e.op, e.bytes] for e in counter.collectives()]


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _jax_state(cfg):
    """The JAX package's ``create_train_state(cfg)``, its ``model.init``
    under ``jax.jit`` (one compile in place of an eager init)."""
    import jax
    import jax.numpy as jnp
    from resnet_tpu.models.registry import get_model
    from resnet_tpu.train.optim import mxnet_sgd
    from resnet_tpu.train.schedule import schedule_from_config
    from resnet_tpu.train.state import TrainState
    model = get_model(cfg)
    rng = jax.random.key(cfg.train.seed)
    variables = jax.jit(lambda r: model.init(
        r, jnp.zeros((1, *cfg.data.image_shape), jnp.float32),
        train=False))(rng)
    tx = mxnet_sgd(schedule_from_config(cfg), momentum=cfg.train.mom,
                   weight_decay=cfg.train.wd)
    return TrainState(step=jnp.zeros([], jnp.int32),
                      params=variables["params"],
                      batch_stats=variables["batch_stats"],
                      opt_state=tx.init(variables["params"]),
                      rng=jax.random.key_data(jax.random.fold_in(rng, 1)),
                      apply_fn=model.apply, tx=tx)


def test_cost_probe_flops_match_jax_cost_analysis():
    import jax.numpy as jnp
    from resnet_tpu.config import cifar10_resnet18 as jax_cifar
    from resnet_tpu.train.steps import make_train_step as jax_step
    from resnet_tpu.utils.export import export_mxnet_params as jax_export
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.tools.cost_probe import count_step
    from resnet_tpu_torch.utils.export import load_mxnet_params

    jcfg = jax_cifar()
    jcfg.model.depth, jcfg.train.batch_size = 8, 8
    jstate = _jax_state(jcfg)
    args, auxs = jax_export(jstate.params, jstate.batch_stats)
    batch = {"image": jnp.zeros((8, 32, 32, 3), jnp.uint8),
             "label": jnp.zeros((8,), jnp.int32)}
    compiled = jax_step(mesh=None).lower(jstate, batch).compile()
    ca = compiled.cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    _, jmetrics = compiled(jstate, batch)
    jax_loss = float(jmetrics["loss_sum"] / jmetrics["count"])

    cfg = _cifar8(8)
    model = get_model(cfg)
    load_mxnet_params(model, args, auxs)
    rec = count_step(cfg, "cpu", augment=False, model=model)
    assert rec["flops"] == pytest.approx(ca["flops"], rel=0.02), (
        rec["flops"], ca["flops"])
    assert rec["conv_mm_flops"] == rec["analytic_conv_mm_flops"]
    assert rec["loss"] == pytest.approx(jax_loss, rel=1e-5)
    assert rec["kernel_bytes"] == 0 and rec["eager_bytes"] > 0


def test_eager_bytes_of_a_lone_mm():
    from resnet_tpu_torch.utils.op_count import OpCounter
    m, k, n = 24, 40, 16
    a, b = torch.ones(m, k), torch.ones(k, n)
    with OpCounter() as c:
        torch.mm(a, b)
    assert [e.op for e in c.events] == ["aten.mm"]
    assert c.eager_bytes() == (m * k + k * n + m * n) * 4
    assert c.flops == 2 * m * k * n


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_kernel_report_counts_what_the_plain_version_computes(direction):
    """One K4f (and K4b) shape: the FLOPs the launch site reports from
    the bound formulas equal those the plain version's aten ops count."""
    from resnet_tpu_torch.ops import fused_unit as fu
    from resnet_tpu_torch.ops import matmul_stats_cuda as mk
    from resnet_tpu_torch.utils.op_count import OpCounter, report_kernel
    m, k, n = 256, 64, 128
    rng = np.random.default_rng(0)
    x, gy, y = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                for s in ((m, k), (m, n), (m, n)))
    w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    with OpCounter() as twin:
        if direction == "forward":
            mk.forward(x, w, counter=fu.matmul_stats)
        else:
            mk.backward(gy, torch.zeros(n), torch.zeros(n), y, x, w,
                        counter=fu.fused_backward)
    cost = (mk.forward_cost if direction == "forward"
            else mk.backward_cost)(m, k, n, 2)
    with OpCounter() as formula:
        report_kernel("matmul_stats", *cost)
    assert formula.flops == twin.flops == twin.conv_mm_flops()
    assert formula.conv_mm_flops() == formula.flops
    assert formula.kernel_bytes() == cost[1] and formula.eager_bytes() == 0


@pytest.fixture(scope="module")
def off_variant():
    from resnet_tpu_torch.config import Config
    from resnet_tpu_torch.tools.cost_probe import count_step
    cfg = Config()                        # ResNet-50: the smallest bottleneck
    cfg.data.image_shape = (32, 32, 3)
    cfg.train.batch_size = 2
    return cfg, count_step(cfg, "cpu")


@pytest.mark.parametrize("variant", ["xla", "pallas"])
def test_unit_chain_variants_count_the_off_variants_flops(variant,
                                                          off_variant):
    import copy
    from resnet_tpu_torch.tools.cost_probe import count_step
    cfg, off = off_variant
    cfg = copy.deepcopy(cfg)
    cfg.train.unit_chain = variant
    rec = count_step(cfg, "cpu")
    assert rec["flops"] == pytest.approx(off["flops"], rel=0.01)
    assert rec["conv_mm_flops"] == pytest.approx(
        off["analytic_conv_mm_flops"], rel=0.01)
    assert off["conv_mm_over_analytic"] == pytest.approx(1.0, rel=0.01)


# ---------------------------------------------------------------------------
# collectives: a fake group's rank 0 against a real 2-rank gloo run
# ---------------------------------------------------------------------------

def _rank_main(workdir):
    """One gloo rank: both DP modes' counted steps; writes its
    collectives to ``rank<r>.json``."""
    from resnet_tpu_torch.parallel.dist import (finalize_distributed,
                                                maybe_init_distributed,
                                                proc_info, world_group)
    from resnet_tpu_torch.tools.pod_compile_probe import count_dp_step
    maybe_init_distributed("cpu")
    out = {mode: _collectives(count_dp_step(
        _dp_cfg(mode), world_group(), torch.device("cpu"))[0])
        for mode in DP_MODES}
    with open(os.path.join(workdir, f"rank{proc_info()[1]}.json"), "w") as f:
        json.dump(out, f)
    finalize_distributed()


@pytest.fixture(scope="module", autouse=True)
def _gloo_started(tmp_path_factory):
    """Starts the two gloo ranks before the module's first test, so that
    they run while the other tests do; ``gloo_ranks`` waits for them."""
    from resnet_tpu_torch.tools.launch import free_port, start, terminate
    work = tmp_path_factory.mktemp("gloo")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = start([sys.executable, __file__, str(work)], WORLD,
                  f"127.0.0.1:{free_port()}", env=env, cwd=ROOT)
    yield work, procs
    terminate(procs)
    for proc in procs:
        proc.wait(timeout=30)


@pytest.fixture(scope="module")
def gloo_ranks(_gloo_started):
    from resnet_tpu_torch.tools.launch import wait_all
    work, procs = _gloo_started
    assert wait_all(procs, timeout=180) == 0
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(WORLD)]


@pytest.mark.parametrize("mode", DP_MODES)
def test_fake_group_counts_the_collectives_of_a_real_run(mode, gloo_ranks):
    from resnet_tpu_torch.tools.pod_compile_probe import audit, count_dp_step
    from resnet_tpu_torch.utils.op_count import fake_process_group
    import torch.distributed as dist
    with fake_process_group(WORLD):
        counter, model = count_dp_step(_dp_cfg(mode), dist.group.WORLD,
                                       torch.device("cpu"))
    assert not dist.is_initialized()
    got = _collectives(counter)
    assert got == gloo_ranks[0][mode] == gloo_ranks[1][mode]
    report = audit(counter, sum(p.numel() * 4 for p in model.parameters()))
    assert report["n_allreduce_buckets"] == len(got) > 0
    if mode == "shard_map":
        # the flat gradient buffer, the BN statistics and the metric sums
        assert len(got) == 3
        assert 0.9 <= report["allreduce_bytes_over_param_bytes"] <= 1.2
    else:
        # the gradient buffer, the metric sums, and each BatchNorm's
        # statistics once forward and once backward
        n_bn = sum(type(m).__name__ == "BatchNorm" for m in model.modules())
        assert len(got) == 2 + 2 * n_bn


# ---------------------------------------------------------------------------
# the serving scan
# ---------------------------------------------------------------------------

def test_exported_artifact_is_collective_free(tmp_path):
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.tools.serving_pod_probe import audit_artifact
    from resnet_tpu_torch.utils.serving import export_serving
    cfg = _cifar8(2)
    export_serving(cfg, get_model(cfg), str(tmp_path / "a"), num_devices=2)
    rec = audit_artifact(str(tmp_path / "a"), torch.device("cpu"), 4)
    assert rec["collective_free"] and rec["collective_op_counts"] == {}
    assert rec["num_devices"] == 2 and rec["logits_shape"] == [4, 10]
    assert rec["flops_per_device_per_batch"] > 0 and rec["finite_logits"]


def test_serving_scan_flags_an_inserted_all_reduce():
    import torch.distributed as dist
    from resnet_tpu_torch.tools.serving_pod_probe import collective_ops
    from resnet_tpu_torch.utils.op_count import fake_process_group

    class Summed(torch.nn.Module):
        def forward(self, x):
            y = torch.ops._c10d_functional.all_reduce(
                x * 2, "sum", dist.group.WORLD.group_name)
            return torch.ops._c10d_functional.wait_tensor(y) + 1

    with fake_process_group(2):
        exported = torch.export.export(Summed(), (torch.ones(4),))
    found = collective_ops(exported)
    assert found.get("_c10d_functional.all_reduce.default") == 1, found


# ---------------------------------------------------------------------------
# the compile-check entry
# ---------------------------------------------------------------------------

# bf16 on both sides: each rounds its activations to bf16 at every layer,
# in its own order; the logits of the small net agree to this share of
# their largest magnitude
ENTRY_TOL = {"float32": dict(rtol=1e-4, atol=1e-5),
             "bfloat16": dict(rtol=0.0, atol=3e-2)}


@pytest.mark.parametrize("dtype", list(ENTRY_TOL))
def test_entry_helper_matches_the_jax_forward(dtype):
    """The ImageNet ResNet-18 at 64x64, batch 2, from the helper's own
    weights carried into the JAX variable tree by the weight bridge."""
    import jax
    import jax.numpy as jnp
    from resnet_tpu.config import Config as JaxConfig
    from resnet_tpu.models import get_model as jax_get_model
    from resnet_tpu.utils.export import import_mxnet_params
    from resnet_tpu_torch.config import Config
    from resnet_tpu_torch.dryrun import forward_entry
    from resnet_tpu_torch.utils.export import export_mxnet_params

    jcfg, cfg = JaxConfig(), Config()
    for c in (jcfg, cfg):
        c.model.depth = 18
        c.data.image_shape = (64, 64, 3)
        c.train.dtype = dtype
    fn, (model, x0) = forward_entry(cfg, 2, device="cpu")
    assert tuple(x0.shape) == (2, 64, 64, 3) and not model.training
    x = np.random.default_rng(3).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    got = fn(model, torch.from_numpy(x)).numpy()

    jmodel = jax_get_model(jcfg)
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), train=False))
    params, stats = import_mxnet_params(*export_mxnet_params(model),
                                        shapes["params"],
                                        shapes["batch_stats"])
    want = np.asarray(jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(x)),
        np.float32)
    tol = ENTRY_TOL[dtype]
    np.testing.assert_allclose(
        got, want, rtol=tol["rtol"],
        atol=tol["atol"] * max(1.0, float(np.abs(want).max())))


def test_entry_is_resnet50_in_eval_with_a_batch_of_16():
    from resnet_tpu_torch.dryrun import entry
    fn, (model, x) = entry(device="cpu")
    assert not model.training and callable(fn)
    assert tuple(x.shape) == (16, 224, 224, 3) and x.dtype == torch.float32
    assert model.dtype == torch.bfloat16
    assert sum(type(m).__name__ == "ResidualUnit"
               for m in model.modules()) == 16          # 3 + 4 + 6 + 3


# ---------------------------------------------------------------------------
# quant_probe, aug_fusion_probe, the digits, the device rule
# ---------------------------------------------------------------------------

def test_int8_conv_leg_is_jaxs_int32_conv():
    import jax.numpy as jnp
    from jax import lax
    from resnet_tpu_torch.tools.quant_probe import conv3x3_int8
    rng = np.random.default_rng(0)
    x8 = rng.integers(-127, 127, (2, 8, 8, 32), dtype=np.int8)
    k8 = rng.integers(-127, 127, (3, 3, 32, 32), dtype=np.int8)
    dn = lax.conv_dimension_numbers(x8.shape, k8.shape,
                                    ("NHWC", "HWIO", "NHWC"))
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x8), jnp.asarray(k8), (1, 1), "SAME",
        dimension_numbers=dn, preferred_element_type=jnp.int32))
    got = conv3x3_int8(torch.from_numpy(x8), torch.from_numpy(k8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_quant_probe_quick_on_the_cpu(capsys):
    from resnet_tpu_torch.tools import quant_probe
    quant_probe.main(["--quick", "--device", "cpu", "--iters", "1",
                      "--windows", "1"])
    recs = [json.loads(line) for line in capsys.readouterr().out.split("\n")
            if line]
    assert [r["case"] for r in recs] == ["dot", "conv3x3"]
    assert all(r["int8_exact"] for r in recs)
    assert "not a fused convolution" in recs[1]["int8_leg"]


def test_aug_fusion_probe_on_the_cpu(capsys):
    from resnet_tpu_torch.tools import aug_fusion_probe
    aug_fusion_probe.main(["--device", "cpu", "--batch-size", "2",
                           "--steps", "1", "--warmup", "1"])
    rec = json.loads(capsys.readouterr().out)
    for name in ("A_fused_aug_plus_s2d_stem", "C_plain_aug_plus_s2d_stem"):
        # the stem pads its blocked input: one copy of it, and the kernel's
        # prep, between the augmenter and the convolution
        ops = [o["op"] for o in rec[name]["ops_between"]]
        assert "aten.constant_pad_nd" in ops, ops
    assert rec["epilogue_ms_estimate(A-B)"] == (
        rec["A_fused_aug_plus_s2d_stem"]["ms_per_call"]
        - rec["B_split_crop_only"]["ms_per_call"])


def test_kernel_sequence_orders_kernels_and_names_their_ops():
    """The trace parser behind ``aug_fusion_probe``'s kernel list, on a
    chrome trace of torch's shape: kernels by start time, each with the
    host op of its ``External id`` (None where the trace links none)."""
    from resnet_tpu_torch.utils.profiler import kernel_sequence
    ev = [{"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 5,
           "dur": 2, "args": {"External id": 7}},
          {"ph": "X", "cat": "cpu_op", "name": "aten::cudnn_convolution",
           "ts": 9, "dur": 2, "args": {"External id": 8}},
          {"ph": "X", "cat": "kernel", "ts": 30, "dur": 4.5,
           "name": "void cudnn::nhwcAddPaddingKernel<float>(int)",
           "args": {"External id": 8}},
          {"ph": "X", "cat": "kernel", "ts": 20, "dur": 1.5,
           "name": "void at::native::elementwise_kernel<128, 4>(int)",
           "args": {"External id": 7}},
          {"ph": "X", "cat": "kernel", "ts": 40, "dur": 1.0,
           "name": "gemm", "args": {}},
          {"ph": "X", "cat": "gpu_memcpy", "ts": 25, "dur": 3.0,
           "name": "Memcpy HtoD", "args": {"External id": 7}}]
    seq = kernel_sequence({"traceEvents": ev})
    assert [(k["group"], k["us"], k["op"], k["op_ts"]) for k in seq] == [
        ("elementwise_kernel", 1.5, "aten::copy_", 5.0),
        ("nhwcAddPaddingKernel", 4.5, "aten::cudnn_convolution", 9.0),
        ("gemm", 1.0, None, None)]


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in pathlib.Path(root).rglob("*") if p.is_file()}


def test_digit_tree_from_the_committed_arrays_is_sklearns(tmp_path):
    from resnet_tpu_torch.tools.ema_equivalence import build_digits
    ours = build_digits(str(tmp_path / "npz"), use_sklearn=False)
    theirs = build_digits(str(tmp_path / "sklearn"), use_sklearn=True)
    a, b = _tree(ours), _tree(theirs)
    assert len(a) > 750 and a == b


TOOLS = {"cost_probe": ["--batch", "2"], "pod_compile_probe": ["--quick"],
         "serving_pod_probe": ["--quick"], "quant_probe": ["--quick"],
         "aug_fusion_probe": ["--batch-size", "2"]}


@pytest.mark.parametrize("tool", list(TOOLS))
def test_tool_raises_without_a_card(tool):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    import importlib
    mod = importlib.import_module(f"resnet_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(TOOLS[tool])


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    from resnet_tpu_torch.dryrun import entry
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    _rank_main(sys.argv[1])
    sys.exit(0)
