"""The port's serving artifact (``resnet_tpu_torch/utils/serving.py``)
against the JAX package's ``make_serving_fn`` on the CPU.

Both sides hold one set of weights: random JAX variables of the init's
shapes, with non-trivial running statistics, carried into the port by the
MXNet name table (``resnet_tpu.utils.export.export_mxnet_params`` ->
``resnet_tpu_torch.utils.export.load_mxnet_params``). The JAX side is
``make_serving_fn`` under ``jax.jit``; the port side is the artifact,
saved and loaded again. In float32 the two agree at rtol/atol 1e-4, the
model tolerance of tests/test_torch_port_model.py (the frameworks sum
convolutions in other orders). In bf16 the artifact equals the port's live
module bit for bit and JAX within 5e-2 (bf16 activations rounded on either
side of a boundary)."""

import json
import os
import subprocess
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from resnet_tpu import config as jax_config
from resnet_tpu.models.registry import get_model as jax_get_model
from resnet_tpu.utils import serving as jax_serving
from resnet_tpu.utils.export import export_mxnet_params as jax_export_params
from resnet_tpu_torch import config
from resnet_tpu_torch.models.registry import get_model
from resnet_tpu_torch.utils import serving
from resnet_tpu_torch.utils.export import load_mxnet_params

ROOT = Path(__file__).resolve().parent.parent
F32_TOL = 1e-4
BF16_TOL = 5e-2

# name -> (preset, depth, dtype); 32x32 canvases, 10 classes
CASES = {
    "cifar8_f32": ("cifar10_resnet18", 8, "float32"),
    "r18_s2d_f32": ("imagenet_resnet50", 18, "float32"),
    "r18_s2d_bf16": ("imagenet_resnet50", 18, "bfloat16"),
}


def _cfg(module, case):
    preset, depth, dtype = CASES[case]
    cfg = module.PRESETS[preset]()
    cfg.model.depth, cfg.train.dtype = depth, dtype
    cfg.data.num_classes, cfg.data.image_shape = 10, (32, 32, 3)
    return cfg


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3),
                                                dtype=np.uint8)


def _jax_variables(cfg, seed=2):
    """Random values of the init's shapes (no init compile), MSRA-scaled
    kernels and positive variances."""
    model = jax_get_model(cfg)
    shapes = jax.eval_shape(partial(model.init, train=False),
                            jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    rng = np.random.default_rng(seed)

    def rand(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        a = rng.normal(0, 0.5, leaf.shape)
        if name == "kernel":
            a = a * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        elif name == "var":
            a = np.abs(a) + 0.5
        return jnp.asarray(a, leaf.dtype)
    return jax.tree_util.tree_map_with_path(rand, shapes)


def _start_fresh_process(prefix, workdir):
    """Start ``python -I`` (no repo on ``sys.path``) running
    ``load_serving`` from the text of serving.py on two images; it runs
    beside the other tests (importing torch and the export machinery takes
    a fresh process several seconds)."""
    x = _images(2)
    np.save(workdir / "x.npy", x)
    code = (
        "import sys, numpy as np, torch\n"
        "assert not any('resnet_tpu' in m for m in sys.modules)\n"
        f"src = open({str(ROOT / 'resnet_tpu_torch/utils/serving.py')!r})"
        ".read()\n"
        "ns = {'__name__': 'serving'}\n"
        "exec(compile(src, 'serving.py', 'exec'), ns)\n"
        f"serve, m = ns['load_serving']({prefix!r}, device='cpu')\n"
        f"x = torch.from_numpy(np.load({str(workdir / 'x.npy')!r}))\n"
        f"np.save({str(workdir / 'y.npy')!r}, serve(x).numpy())\n"
        "assert not any('resnet_tpu' in m for m in sys.modules)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, "-I", "-c", code],
                            cwd=str(workdir), env=env)


@pytest.fixture(autouse=True, scope="module")
def two_intra_op_threads():
    """Two intra-op threads for the module, then the process's setting
    again: beside the other test workers, one thread a core oversubscribes
    the host (as in test_torch_port_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    """case -> (port cfg, port model, JAX serve fn, artifact prefix): each
    case exported once, with a symbolic batch; and "fresh" -> the process
    of :func:`_start_fresh_process` on the first case's artifact."""
    root = tmp_path_factory.mktemp("serving")
    out = {}
    try:
        for case in CASES:
            jcfg = _cfg(jax_config, case)
            v = _jax_variables(jcfg)
            jax_fn = jax.jit(jax_serving.make_serving_fn(
                jcfg, v["params"], v["batch_stats"]))
            cfg = _cfg(config, case)
            model = get_model(cfg).to(memory_format=torch.channels_last)
            load_mxnet_params(model, *jax_export_params(v["params"],
                                                        v["batch_stats"]))
            prefix = str(root / case)
            serving.export_serving(cfg, model, prefix)
            out[case] = (cfg, model, jax_fn, prefix)
            if "fresh" not in out:
                out["fresh"] = (_start_fresh_process(prefix, root), root)
        yield out
    finally:
        if "fresh" in out and out["fresh"][0].poll() is None:
            out["fresh"][0].kill()
            out["fresh"][0].wait()


@pytest.fixture(scope="module")
def loaded(cases):
    """case -> (the loaded artifact, its manifest, JAX's logits of
    ``_images(8)``): in eval mode each image's logits are its own, so one
    JAX batch serves every batch size."""
    return {case: (*serving.load_serving(cases[case][3], device="cpu"),
                   np.asarray(cases[case][2](_images(8))))
            for case in CASES}


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("case", ["cifar8_f32", "r18_s2d_f32"])
def test_artifact_matches_jax_in_float32_at_any_batch(loaded, case, batch):
    serve, manifest, want = loaded[case]
    assert manifest["input"]["shape"] == ["b", 32, 32, 3]
    got = serve(torch.from_numpy(_images(8)[:batch]))
    assert got.dtype == torch.float32 and got.shape == (batch, 10)
    np.testing.assert_allclose(got.numpy(), want[:batch], rtol=F32_TOL,
                               atol=F32_TOL)


def test_bf16_artifact_is_the_live_module_bit_for_bit(cases, loaded):
    cfg, model, _, _ = cases["r18_s2d_bf16"]
    serve, manifest, jax_logits = loaded["r18_s2d_bf16"]
    assert manifest["compute_dtype"] == "bfloat16"
    x = torch.from_numpy(_images(8))
    with torch.inference_mode():
        want = serving.make_serving_fn(cfg, model)(x)
    got = serve(x)
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), jax_logits, rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_pinned_two_device_artifact(cases, loaded, tmp_path):
    """A pinned batch of 4 over 2 devices: the blocks run in turn on the
    CPU and give the single-device artifact's logits; a batch of 3 does
    not divide, and a batch of 6 (blocks of 3) is not the pinned size."""
    cfg, model, _, _ = cases["cifar8_f32"]
    two = str(tmp_path / "two")
    serving.export_serving(cfg, model, two, batch_size=4, num_devices=2)
    serve2, manifest = serving.load_serving(two, device="cpu")
    serve1 = loaded["cifar8_f32"][0]
    assert manifest["num_devices"] == 2
    assert manifest["input"]["shape"] == [4, 32, 32, 3]
    assert serving._batch_repr(None, 2) == "2*b"
    x = torch.from_numpy(_images(6))
    torch.testing.assert_close(serve2(x[:4]), serve1(x[:4]), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError,
                       match="batch_size 3 must divide by num_devices 2"):
        serve2(x[:3])
    with pytest.raises((AssertionError, RuntimeError), match="2"):
        serve2(x)
    with pytest.raises(ValueError,
                       match="batch_size 3 must divide by num_devices 2"):
        serving.export_serving(cfg, model, two, batch_size=3, num_devices=2)
    # the program and its weights, not the example batch it was traced on
    assert torch.export.load(two + ".pt2").example_inputs is None


def test_manifest_has_the_jax_manifests_keys(cases, tmp_path):
    cfg, _, _, prefix = cases["cifar8_f32"]
    jcfg = _cfg(jax_config, "cifar8_f32")
    v = _jax_variables(jcfg)
    _, jax_manifest = jax_serving.export_serving(
        jcfg, v["params"], v["batch_stats"], str(tmp_path / "jax"),
        batch_size=2, platforms=("cpu",))
    with open(jax_manifest) as f:
        want = json.load(f)
    with open(prefix + ".json") as f:
        got = json.load(f)
    assert set(got) == set(want) - {"jax_version"} | {"torch_version"}
    assert got["format"] == "torch.export ExportedProgram"
    assert got["platforms"] == ["cpu", "cuda"]
    for key in ("network", "depth", "version", "num_classes", "normalize",
                "compute_dtype", "manifest_version", "num_devices"):
        assert got[key] == want[key], key
    for key in ("input", "output"):
        assert set(got[key]) == set(want[key])
        assert got[key]["shape"][1:] == want[key]["shape"][1:]


def test_moved_program_names_no_cpu_and_cuda_needs_a_card(cases):
    from torch.export.passes import move_to_device_pass
    _, _, _, prefix = cases["cifar8_f32"]
    ep = torch.export.load(prefix + ".pt2")
    assert any("cpu" in str(n.args) + str(n.kwargs) for n in ep.graph.nodes)
    ep = move_to_device_pass(ep, "meta")
    assert not [n for n in ep.graph.nodes
                if "cpu" in str(n.args) + str(n.kwargs)]
    assert all(t.device.type == "meta" for t in ep.state_dict.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.load_serving(prefix)


def test_artifact_runs_in_a_process_without_the_repo(cases):
    """A ``python -I`` process runs the artifact: loading needs torch
    alone."""
    cfg, model, _, _ = cases[next(iter(CASES))]
    proc, workdir = cases["fresh"]
    assert proc.wait(timeout=120) == 0
    with torch.inference_mode():
        want = serving.make_serving_fn(cfg, model)(
            torch.from_numpy(np.load(workdir / "x.npy")))
    np.testing.assert_array_equal(np.load(workdir / "y.npy"), want.numpy())
