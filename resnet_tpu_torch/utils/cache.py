"""Where the port keeps what it builds across processes. Port of
``resnet_tpu/utils/cache.py``.

The JAX package caches XLA executables. The port compiles no program; what
it builds once and loads in every later process are its native
libraries: the CUDA kernels (``_build.py``, one ``nvcc`` a source) and the
record decode pool (``data/native.py``, ``g++``). Both land in one
directory, ``resnet_tpu_torch/_build`` unless this moves them. Each
library's name carries a digest of its source, flags and compiler, so a
stale build is never loaded from any directory.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_CACHE = "RESNET_TPU_TORCH_CACHE"


def enable_compile_cache(path: str = "") -> str:
    """Point the kernel and decode-pool builds at ``path`` (default
    ``$RESNET_TPU_TORCH_CACHE``, else ``resnet_tpu_torch/_build``), make
    the directory, and return it. Idempotent. A library already loaded
    in this process stays loaded."""
    from resnet_tpu_torch import _build
    from resnet_tpu_torch.data import native

    path = path or os.environ.get(ENV_CACHE) or str(_build.DEFAULT_BUILD_DIR)
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = native.BUILD_DIR = Path(path)
    return path
