"""Backend options of the port: what ``--xla-opts`` carries here. Port of
``resnet_tpu/utils/xla_opts.py``.

The JAX package passes ``--xla-opts k=v,...`` to the XLA compiler of
each program it builds. The port compiles no program: the options are
the process-wide switches of PyTorch's CUDA backends that the port uses,

  - ``cudnn_benchmark=0|1``: cuDNN times its algorithms once per shape
    (``torch.backends.cudnn.benchmark``);
  - ``cudnn_deterministic=0|1``: cuDNN's deterministic algorithms only
    (``torch.backends.cudnn.deterministic``);
  - ``tf32=0|1``: TF32 for float32 convolutions and matrix products
    (``utils/device.set_tf32``).

A switch belongs to the whole process, so the entry point
(``train_resnet.main``) applies them once, where the JAX Solver resolves
its options for each program it compiles. Any other key raises, as the
JAX package's CPU compiler rejects a TPU flag.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from resnet_tpu_torch.utils.device import set_tf32

# every train call has the same shapes: let cuDNN time its algorithms
# once. Left out while deterministic algorithms are on (``compiler_options``)
CUDA_DEFAULTS: Dict[str, str] = {"cudnn_benchmark": "1"}

KNOWN_KEYS = ("cudnn_benchmark", "cudnn_deterministic", "tf32")
_VALUES = {"0": False, "1": True}


def parse_opts(spec: str) -> Dict[str, str]:
    """Parse a comma-separated ``k=v[,k=v...]`` option string."""
    opts: Dict[str, str] = {}
    for kv in filter(None, (spec or "").split(",")):
        k, _, v = kv.partition("=")
        opts[k.strip()] = v.strip()
    return opts


def compiler_options(spec: Optional[str] = None,
                     backend: Optional[str] = None
                     ) -> Optional[Dict[str, str]]:
    """Resolve the backend options for ``backend`` (``"cuda"`` or
    ``"cpu"``; default: ``"cuda"`` when a card is present).

    ``spec`` (the ``--xla-opts`` flag) overrides/extends the CUDA
    defaults; ``spec="off"`` disables them. Other backends get only the
    explicit ``spec``. The default ``cudnn_benchmark`` is left out while
    ``torch.use_deterministic_algorithms`` is on: the autotuner picks
    algorithms by their measured time, so two runs could differ.
    """
    if spec == "off":
        return None
    if backend is None:
        backend = "cuda" if torch.cuda.is_available() else "cpu"
    opts: Dict[str, str] = {}
    if backend == "cuda" and not torch.are_deterministic_algorithms_enabled():
        opts.update(CUDA_DEFAULTS)
    opts.update(parse_opts(spec or ""))
    return opts or None


def _state() -> tuple:
    return (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _restore(state: tuple) -> None:
    (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
     torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = state


def apply_backend_options(opts: Optional[Dict[str, str]]
                          ) -> Callable[[], None]:
    """Set the switches ``opts`` names (``compiler_options``' result;
    None sets nothing). Every key and value is checked before any switch
    is set: an unknown key or a value other than 0 and 1 raises
    ``ValueError``. Returns a function that puts every switch back as it
    was."""
    opts = opts or {}
    unknown = sorted(set(opts) - set(KNOWN_KEYS))
    if unknown:
        raise ValueError(
            f"unknown backend option(s) {unknown} in --xla-opts; the port's "
            f"options are {', '.join(KNOWN_KEYS)} (each 0 or 1), or 'off'")
    bad = {k: v for k, v in opts.items() if v not in _VALUES}
    if bad:
        raise ValueError(f"backend option values must be 0 or 1, got {bad}")
    before = _state()
    on = {k: _VALUES[v] for k, v in opts.items()}
    if "cudnn_benchmark" in on:
        torch.backends.cudnn.benchmark = on["cudnn_benchmark"]
    if "cudnn_deterministic" in on:
        torch.backends.cudnn.deterministic = on["cudnn_deterministic"]
    if "tf32" in on:
        set_tf32(on["tf32"])
    return lambda: _restore(before)
