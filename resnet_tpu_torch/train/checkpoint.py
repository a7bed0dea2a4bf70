"""Checkpoints: save and resume the whole train state. Port of
``resnet_tpu/train/checkpoint.py`` with ``torch.save`` in place of orbax.

Layout: one file per completed-epoch count, ``{model_prefix}/{epoch}.pt``,
holding the model's ``state_dict`` (params and BN running stats), the
momentum buffers, ``step``, ``seed`` and the data iterator's state.
Mid-epoch saves (``--checkpoint-frequent``, SIGTERM) reuse the
completed-epoch count and carry the position inside the epoch in the
iterator state, so they overwrite that epoch's file. Every save writes a
temporary file and renames it over the old one, so a crash leaves the
previous file whole.

Files are read with ``torch.load(weights_only=True)``: the payload holds
only tensors, and the iterator state only ints, strings and lists of
them, so no pickled object is ever executed. These files are the port's
own; orbax checkpoints of the JAX package are not read. The interchange
between the two packages is the MXNet ``.params`` file
(``utils/export.py``).
"""

from __future__ import annotations

import os
import re
from typing import List, Optional, Tuple

import torch

from resnet_tpu_torch.train.state import TrainState

_FILE = re.compile(r"^(\d+)\.pt$")


def _path(model_prefix: str, epoch: int) -> str:
    return os.path.join(model_prefix, f"{epoch}.pt")


def _epochs(model_prefix: str) -> List[int]:
    if not os.path.isdir(model_prefix):
        return []
    return sorted(int(m.group(1)) for m in map(_FILE.match,
                                                os.listdir(model_prefix))
                  if m)


def save_checkpoint(model_prefix: str, epoch: int, state: TrainState,
                    iter_state: Optional[dict] = None,
                    max_to_keep: Optional[int] = None) -> str:
    """Write ``{model_prefix}/{epoch}.pt``, replacing one that exists; with
    ``max_to_keep``, delete all but that many of the newest epochs."""
    os.makedirs(model_prefix, exist_ok=True)
    payload = {
        "model": state.model.state_dict(),
        "momentum": list(state.momentum),
        "step": int(state.step),
        "seed": int(state.seed),
        "iter_state": dict(iter_state or {}),
    }
    out = _path(model_prefix, epoch)
    tmp = f"{out}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, out)
    if max_to_keep is not None:
        for old in _epochs(model_prefix)[:-max_to_keep]:
            os.remove(_path(model_prefix, old))
    return out


def load_checkpoint(model_prefix: str, epoch: int,
                    state: TrainState) -> Tuple[TrainState, dict]:
    """Fill ``state`` in place from ``{model_prefix}/{epoch}.pt``; returns
    it and the saved iterator state."""
    dev = next(state.model.parameters()).device
    payload = torch.load(_path(model_prefix, epoch), map_location=dev,
                         weights_only=True)
    state.model.load_state_dict(payload["model"])
    if len(payload["momentum"]) != len(state.momentum):
        raise ValueError(
            f"checkpoint has {len(payload['momentum'])} momentum buffers, "
            f"the model {len(state.momentum)}")
    with torch.no_grad():
        for buf, saved in zip(state.momentum, payload["momentum"]):
            buf.copy_(saved)
    state.step = payload["step"]
    state.seed = payload["seed"]
    return state, payload["iter_state"]


def has_epoch(model_prefix: str, epoch: int) -> bool:
    """True if the port's checkpoint of ``epoch`` exists."""
    return os.path.isfile(_path(model_prefix, epoch))


def latest_epoch(model_prefix: str) -> Optional[int]:
    """The newest saved epoch count, or None."""
    epochs = _epochs(model_prefix)
    return epochs[-1] if epochs else None
