"""The port's probes and profiler module on the CPU.

``torch_sums`` (the K5 kernel's plain version) is held against the JAX
tool's ``pallas_sums`` in Pallas interpret mode and its ``xla_sums``,
loaded from ``tools/reduce_probe.py`` by path, on the same numpy inputs;
``parse_trace`` against hand-written chrome traces and a real CPU trace;
``input_overhead`` against the JAX function; the trace probe's program
runs tiny on the CPU.
"""

import gzip
import importlib.util
import json
import os
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu.utils.profiler import input_overhead as jax_input_overhead
from resnet_tpu_torch.ops import bn_ema
from resnet_tpu_torch.tools import reduce_probe as rp
from resnet_tpu_torch.tools import trace_probe as tp
from resnet_tpu_torch.utils import profiler

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _jax_reduce_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_reduce_probe", ROOT / "tools" / "reduce_probe.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _sum_inputs(m, c, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return (f32(rng.normal(size=(m, c))), f32(rng.normal(size=(m, c))),
            f32(rng.normal(size=c)), f32(rng.uniform(0.5, 2.0, c)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_torch_sums_match_pallas_and_xla_sums(dtype):
    """1024x64 with bm=256: the Pallas grid takes 4 steps. Each sum within
    1e-5 of the sum of its terms' magnitudes, per column."""
    jrp = _jax_reduce_probe()
    gy, x, mean, inv = _sum_inputs(1024, 64)
    jargs = (jnp.asarray(gy, dtype), jnp.asarray(x, dtype),
             jnp.asarray(mean), jnp.asarray(inv))
    targs = (torch.from_numpy(gy).to(getattr(torch, dtype)),
             torch.from_numpy(x).to(getattr(torch, dtype)),
             torch.from_numpy(mean), torch.from_numpy(inv))
    got = rp.torch_sums(*targs)
    bounds = rp.sum_bounds(*targs)
    for want in (jrp.pallas_sums(*jargs, bm=256, interpret=True),
                 jrp.xla_sums(*jargs)):
        for g, w, bound in zip(got, want, bounds):
            diff = np.abs(g.numpy() - np.asarray(w))
            assert (diff <= bound.numpy()).all(), (diff / bound.numpy()).max()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_sums_on_cpu_tensors_is_the_plain_version(dtype):
    gy, x, mean, inv = (torch.from_numpy(a) for a in _sum_inputs(300, 24))
    args = (gy.to(dtype), x.to(dtype), mean, inv)
    before = rp.cuda_sums.launches
    for got, want in zip(rp.cuda_sums(*args), rp.torch_sums(*args)):
        assert torch.equal(got, want)
    assert rp.cuda_sums.launches == before


@pytest.mark.parametrize("shape", rp.SHAPES, ids=str)
def test_sum_splits_cover_the_rows_with_blocks_for_every_sm(shape):
    m, c = shape
    splits, rows = rp.sum_splits(m, c)
    assert splits * rows >= m > (splits - 1) * rows
    chunks = c // bn_ema.COLS
    row_threads = min(chunks, bn_ema.BLOCK_THREADS)
    blocks = splits * -(-chunks // row_threads)
    lanes = bn_ema.BLOCK_THREADS // row_threads
    assert 2 * 132 <= blocks <= bn_ema.TARGET_BLOCKS
    assert rows >= lanes * bn_ema.MIN_ROWS_PER_LANE


def test_probes_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main(["--check"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rp.main(["--iters", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.main(["--steps", "1", "--logdir", "unused"])
    with pytest.raises(RuntimeError, match="no CPU mode"):
        rp.probe(iters=1, device="cpu")


# ---------------------------------------------------------------------------
# device time by kernel
# ---------------------------------------------------------------------------

ELEMENTWISE = ("void at::native::vectorized_elementwise_kernel<4, "
               "at::native::FillFunctor<float>, at::detail::Array<char*, 1> "
               ">(int, at::native::FillFunctor<float>, "
               "at::detail::Array<char*, 1>)")
REDUCE = ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float,"
          " at::native::MeanOps<float, float, float, float>, unsigned int, "
          "float, 4, 4> >(at::native::ReduceOp<float, at::native::MeanOps<"
          "float, float, float, float>, unsigned int, float, 4, 4>)")
K5 = ("void (anonymous namespace)::bn_sums_kernel<__nv_bfloat16>("
      "__nv_bfloat16 const*, __nv_bfloat16 const*, float const*, float "
      "const*, float*, float*, int, int, int, int)")
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_kernel2"


@pytest.mark.parametrize("name,key", [
    (ELEMENTWISE, "vectorized_elementwise_kernel"),
    (REDUCE, "reduce_kernel"),
    (K5, "bn_sums_kernel"),
    (GEMM, "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
           "kernel"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_32x6_nn>("
     "cutlass_80_tensorop_s1688gemm_64x64_32x6_nn::Params)", "Kernel"),
    ("_ZN17cutlass__5x_cudnn6KernelINS_4conv6kernel23ImplicitGemmConvolution"
     "INS1_11threadblock22ImplicitGemmMultistageEEEEvNT_6ParamsE", "Kernel"),
    ("_Z20bn_sums_kernel_test7PKfS0_i", "bn_sums_kernel_test"),
], ids=["elementwise", "reduce", "k5", "gemm", "cutlass", "mangled_nested",
        "mangled"])
def test_kernel_group_strips_signature_and_digits(name, key):
    assert profiler.kernel_group(name) == key


def _write_trace(path, events, compress):
    data = json.dumps({"traceEvents": events}).encode()
    path.write_bytes(gzip.compress(data) if compress else data)


def _kernel(name, dur, ts=0.0):
    return {"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": 7,
            "ts": ts, "dur": dur}


def test_parse_trace_sums_kernel_events_by_name_and_group(tmp_path, capsys):
    events = [
        _kernel(ELEMENTWISE, 300.0), _kernel(ELEMENTWISE, 100.0),
        _kernel(ELEMENTWISE.replace("<4,", "<2,"), 200.0),
        _kernel(REDUCE, 1000.0), _kernel(K5, 50.0),
        # host op, memory copy and a process name: not kernel time
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9999.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 777.0},
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
    ]
    older = tmp_path / "a" / "host_1.1.pt.trace.json.gz"
    older.parent.mkdir()
    _write_trace(older, [_kernel(GEMM, 5e6)], compress=True)
    newest = tmp_path / "host_1.2.pt.trace.json"     # plain JSON, newer
    _write_trace(newest, events, compress=False)
    os.utime(older, ns=(1, 1))
    summary = tp.parse_trace(str(tmp_path), top=10, steps=2)
    out = capsys.readouterr().out
    assert f"device event time {1.65:.1f} ms over 2 steps" in out
    assert summary["ms_per_step"] == pytest.approx(0.825)
    assert summary["groups"] == pytest.approx({
        "reduce_kernel": 0.5, "vectorized_elementwise_kernel": 0.3,
        "bn_sums_kernel": 0.025})
    assert list(summary["groups"]) == ["reduce_kernel",
                                       "vectorized_elementwise_kernel",
                                       "bn_sums_kernel"]
    assert summary["top"][0]["count"] == 1
    assert [e["count"] for e in summary["top"]
            if e["name"] == ELEMENTWISE[:90]] == [2]
    # the same numbers from the gzip file, once it is the newest
    _write_trace(older, events, compress=True)
    os.utime(older, ns=(2 ** 62, 2 ** 62))
    assert tp.parse_trace(str(tmp_path), top=10, steps=2) == summary


def test_kernel_times_counts_copies_only_when_asked():
    trace = {"traceEvents": [
        _kernel(REDUCE, 1000.0), _kernel(REDUCE, 500.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "dur": 70.0},
        {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 3.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "dur": 9999.0},
    ]}
    assert profiler.kernel_times(trace) == ({REDUCE: 1500.0}, {REDUCE: 2})
    total, count = profiler.kernel_times(trace, profiler.DEVICE_CATEGORIES)
    assert total == {REDUCE: 1500.0, "Memcpy DtoD": 70.0, "Memset": 3.0}
    assert count == {REDUCE: 2, "Memcpy DtoD": 1, "Memset": 1}


def test_parse_trace_reports_a_cpu_trace_without_device_events(tmp_path,
                                                              capsys):
    with profiler.maybe_trace(str(tmp_path)) as prof:
        assert prof is not None
        torch.ones(64, 64).sum()
    path = profiler.newest_trace(str(tmp_path))
    assert path is not None and path.name.endswith(profiler.TRACE_SUFFIX)
    assert tp.parse_trace(str(tmp_path), top=5, steps=1) is None
    assert "no device kernel events" in capsys.readouterr().out
    assert tp.parse_trace(str(tmp_path / "empty"), top=5, steps=1) is None
    assert "no trace found" in capsys.readouterr().out


def test_maybe_trace_honours_the_environment(tmp_path, monkeypatch):
    monkeypatch.delenv("RESNET_TPU_PROFILE", raising=False)
    with profiler.maybe_trace() as prof:
        assert prof is None
    monkeypatch.setenv("RESNET_TPU_PROFILE", str(tmp_path / "env"))
    with profiler.maybe_trace():
        torch.zeros(4).add_(1)
    assert profiler.newest_trace(str(tmp_path / "env")) is not None


@pytest.mark.parametrize("with_pipe,device_data", [
    (1.2, 1.0), (0.9, 1.0), (1.0, 0.0), (3.0, 2.0)])
def test_input_overhead_matches_jax(with_pipe, device_data):
    assert profiler.input_overhead(with_pipe, device_data) == \
        jax_input_overhead(with_pipe, device_data)


def test_trace_probe_program_runs_small_on_the_cpu(tmp_path, capsys):
    """The probe's program (bf16, bn_subsample=8, standard stem, the
    augmenter in the standard layout) at depth 18 on 48x48 images: two
    steps, a trace on disk, and the CPU trace's "no device events"."""
    run = tp.trace_train_step(steps=1, warmup=1, batch_size=2, depth=18,
                              logdir=str(tmp_path), device="cpu",
                              image_side=48)
    assert run["traced_wall_ms"] > 0 and np.isfinite(run["loss"])
    assert profiler.newest_trace(str(tmp_path)) is not None
    assert tp.main(["--parse-only", "--logdir", str(tmp_path),
                    "--steps", "1"]) == 0
    assert "no device kernel events" in capsys.readouterr().out
