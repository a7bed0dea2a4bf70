"""Nothing the benchmark runs loads JAX or the JAX package, whose name
the port's begins with; the reference imports nothing of the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from gpubench.run import banned_modules

HERE = Path(__file__).resolve().parent.parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def test_banned_names_compare_whole_top_level_names():
    assert banned_modules(["resnet_tpu_torch", "resnet_tpu_torch.ops",
                           "torch", "jaxtyping"]) == []
    assert banned_modules(["resnet_tpu.config", "jax.numpy", "jaxlib",
                           "flax.linen"]) == ["flax", "jax", "jaxlib",
                                              "resnet_tpu"]


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax(path):
    assert not set(imported_roots(path)) & {"jax", "jaxlib", "flax",
                                            "resnet_tpu"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    roots = set(imported_roots(path))
    assert "resnet_tpu_torch" not in roots
    assert roots <= {"__future__", "contextlib", "typing", "numpy", "torch",
                     "gpubench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("gpubench"):
            assert node.module.startswith("gpubench.reference")


def test_a_run_loads_no_banned_module():
    code = ("import gpubench.run, gpubench.train_cell, gpubench.serve_cell, "
            "gpubench.calibrate, resnet_tpu_torch.train.solver, "
            "resnet_tpu_torch.utils.serving; "
            "print(gpubench.run.banned_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert out.stdout.strip() == "[]"
