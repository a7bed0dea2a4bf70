"""The port stands alone: nothing under ``resnet_tpu_torch/`` nor
``chip_smoke.py`` imports JAX, its libraries, or the JAX package, and its
entry points default to the CUDA card."""

import ast
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "resnet_tpu")


def _is_forbidden(module: str) -> bool:
    # exact module names: resnet_tpu_torch shares resnet_tpu's prefix
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


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


def test_forbidden_match_is_exact():
    assert _is_forbidden("resnet_tpu.config")
    assert _is_forbidden("jax.numpy") and _is_forbidden("flax")
    assert not _is_forbidden("resnet_tpu_torch.config")
    assert not _is_forbidden("jaxtyping")


def test_importing_the_train_step_loads_no_jax():
    code = ("import sys, resnet_tpu_torch.train.steps, "
            "resnet_tpu_torch.ops.augment_fused, resnet_tpu_torch.utils.export, "
            "resnet_tpu_torch.train_resnet, resnet_tpu_torch.data.pipeline, "
            "resnet_tpu_torch.data.im2rec\n"
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
