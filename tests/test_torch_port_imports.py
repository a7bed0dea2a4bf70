"""The port stands alone: nothing under ``resnet_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, its libraries, the JAX package, the
repo's root ``tools/`` scripts or anything under ``tests/`` (nor puts
either directory on ``sys.path``), and its entry points default to the
CUDA card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "resnet_tpu")


# the root tools/ scripts and the test modules, by the names a script
# that put their directory on sys.path would import them under
LOCAL = ("tools", "tests", *sorted(
    p.stem for d in ("tools", "tests") for p in (ROOT / d).glob("*.py")))


def _is_forbidden(module: str, names=FORBIDDEN) -> bool:
    # exact module names: resnet_tpu_torch shares resnet_tpu's prefix
    return any(module == f or module.startswith(f + ".") for f in names)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    return sorted((ROOT / "resnet_tpu_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]


def test_port_sources_import_nothing_of_jax():
    sources = _port_sources()
    assert len(sources) > 10 and (ROOT / "chip_smoke.py").exists()
    bad = [(str(p.relative_to(ROOT)), m) for p in sources
           for m in _imports(p) if _is_forbidden(m)]
    assert bad == []


def test_port_sources_import_no_root_tool_and_no_test():
    """The JAX ``tools/ema_probe.py`` imports a fixture of
    ``tests/test_convergence_record.py``: the port keeps its own copy
    (``resnet_tpu_torch/tools/stripes.py``)."""
    assert {"ema_probe", "test_convergence_record", "conftest"} <= set(LOCAL)
    sources = _port_sources()
    bad = [(str(p.relative_to(ROOT)), m) for p in sources
           for m in _imports(p) if _is_forbidden(m, LOCAL)]
    assert bad == []
    assert [str(p.relative_to(ROOT)) for p in sources
            if "sys.path" in p.read_text()] == []
    assert not _is_forbidden("resnet_tpu_torch.tools.ema_probe", LOCAL)


def test_forbidden_match_is_exact():
    assert _is_forbidden("resnet_tpu.config")
    assert _is_forbidden("jax.numpy") and _is_forbidden("flax")
    assert not _is_forbidden("resnet_tpu_torch.config")
    assert not _is_forbidden("jaxtyping")


def test_importing_the_train_step_loads_no_jax():
    code = ("import sys, resnet_tpu_torch.train.steps, "
            "resnet_tpu_torch.ops.augment_fused, resnet_tpu_torch.utils.export, "
            "resnet_tpu_torch.train_resnet, resnet_tpu_torch.data.pipeline, "
            "resnet_tpu_torch.data.im2rec, resnet_tpu_torch.tools.bench_input, "
            "resnet_tpu_torch.tools.ema_equivalence, "
            "resnet_tpu_torch.tools.ema_probe, "
            "resnet_tpu_torch.tools.device_parity, "
            "resnet_tpu_torch.tools.nightly_convergence, "
            "resnet_tpu_torch.utils.cache, resnet_tpu_torch.utils.xla_opts, "
            "resnet_tpu_torch.utils.op_count, resnet_tpu_torch.dryrun, "
            "resnet_tpu_torch.tools.cost_probe, "
            "resnet_tpu_torch.tools.pod_compile_probe, "
            "resnet_tpu_torch.tools.serving_pod_probe, "
            "resnet_tpu_torch.tools.quant_probe, "
            "resnet_tpu_torch.tools.aug_fusion_probe\n"
            f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + "
            f"'.') for f in {FORBIDDEN!r})]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_entry_point_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card error cannot show")
    from resnet_tpu_torch.config import imagenet_resnet50
    from resnet_tpu_torch.train.state import create_train_state
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_train_state(imagenet_resnet50())
