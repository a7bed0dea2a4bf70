"""Build the port's CUDA kernels with ``nvcc`` at first use and bind them
with ``ctypes``.

Each ``csrc/<name>.cu`` becomes ``_build/lib<name>-<hash>.so``, a shared
library with a plain C interface (no PyTorch headers, so one source builds
in seconds). The hash covers the source, the shared ``csrc/*.cuh`` headers
and the source's flags, so an edited source rebuilds and an unchanged one
is loaded as built. ``build_all`` starts one ``nvcc`` per source together
and waits for all of them; the compiler's output (``-Xptxas -v``: each
kernel's registers, shared memory and spills) is kept beside the library as
``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# flags of one source only
EXTRA_FLAGS = {
    # no contracted multiply-adds: the kernel keeps the rounding of the
    # reference expressions (and no --use_fast_math). The matrix-product
    # kernels want their FMAs and guard the few expressions whose rounding
    # matters with intrinsics instead.
    "augment": ["-fmad=false"],
}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of every exported launch function: (argtypes, restype)
SIGNATURES = {
    "augment": {
        "fused_crop_mirror_normalize_launch": (
            [_P, _P, _P] + [_I] * 5 + [_F] * 6 + [_I] * 5 + [_P], _I),
    },
    "bn_sums": {
        # gy, x, mean, inv, ps1, ps2; M, C, splits, rows_per_split, dtype;
        # stream
        "bn_sums_launch": ([_P] * 6 + [_I] * 5 + [_P], _I),
    },
    "matmul_stats": {
        # x, wt, a, b, y, psum, psumsq; M, K, N, dtype, normalize, relu,
        # tile_n, grid; stream
        "matmul_stats_launch": ([_P] * 7 + [_I] * 8 + [_P], _I),
    },
    "matmul_stats_bwd": {
        # gy, y, x, wt, gs, gss, a, b, inv, minv, dx, pdgamma, pdbeta,
        # dwt_part; M, K, N, splits, rows_per_split, dtype, normalize, relu,
        # dx_tile, dx_grid, dw_tile, dw_grid; stream
        "matmul_stats_bwd_launch": ([_P] * 14 + [_I] * 12 + [_P], _I),
    },
}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                           "kernels are built from source at first use")
    return found


def _flags(name: str) -> List[str]:
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, [])


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start nvcc for ``csrc/<name>.cu`` unless its library exists; returns
    (process, temporary output, final path) or None."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, proc, tmp: Path, out: Path) -> None:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)   # atomic: a concurrent loader sees all or nothing


def build_log(name: str) -> str:
    """The compiler's output of the last build of ``csrc/<name>.cu`` on
    this machine ("" if the library was found built without one)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build every listed kernel source (default: all of ``csrc/``), one
    ``nvcc`` each, all started together. Returns name -> library path."""
    names = sorted(SIGNATURES) if names is None else names
    started = {name: _start_build(name) for name in names}
    for name, job in started.items():
        if job is not None:
            _finish_build(name, *job)
    return {name: _library_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``, with every exported
    function's argtypes and restype declared."""
    lib = ctypes.CDLL(str(build_all([name])[name]))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib
