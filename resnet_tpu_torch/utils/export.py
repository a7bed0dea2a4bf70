"""The weight bridge: the port's model to and from the MXNet name table.

The table is the reference's flat ``name -> array`` pair of dicts
(``arg_params`` weights, ``aux_params`` BN running stats), with symbol
names such as ``stage1_unit1_conv1_weight``, ``..._bn1_gamma/beta``, aux
``..._bn1_moving_mean/moving_var``, ``conv0_weight`` and
``fc1_weight/bias`` (port of ``resnet_tpu/utils/export.py``). MXNet keeps
conv weights OIHW and the fc weight (out, in), as the port does, so no
array is transposed.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from resnet_tpu_torch.models.resnet import BatchNorm, Conv, Dense

_BN_NAMES = {"weight": ("gamma", False), "bias": ("beta", False),
             "running_mean": ("moving_mean", True),
             "running_var": ("moving_var", True)}


def _tensors(model: torch.nn.Module):
    """Yield (mxnet name, is_aux, tensor) for every parameter and BN
    buffer of ``model``."""
    for mod_name, mod in model.named_modules():
        prefix = mod_name.replace(".", "_")
        if isinstance(mod, Dense):
            yield "fc1_weight", False, mod.weight
            yield "fc1_bias", False, mod.bias
        elif isinstance(mod, Conv):
            yield f"{prefix}_weight", False, mod.weight
        elif isinstance(mod, BatchNorm):
            for attr, (suffix, aux) in _BN_NAMES.items():
                # a fixed-gamma BN (v2's bn_data) has no scale to name
                if getattr(mod, attr) is not None:
                    yield f"{prefix}_{suffix}", aux, getattr(mod, attr)


def _model(state) -> torch.nn.Module:
    return getattr(state, "model", state)


def export_mxnet_params(state) -> Tuple[Dict[str, np.ndarray],
                                        Dict[str, np.ndarray]]:
    """-> (arg_params, aux_params) of a train state (or a bare model), as
    float32 numpy arrays under MXNet names."""
    args: Dict[str, np.ndarray] = {}
    auxs: Dict[str, np.ndarray] = {}
    for name, aux, t in _tensors(_model(state)):
        (auxs if aux else args)[name] = \
            t.detach().float().cpu().contiguous().numpy()
    return args, auxs


def load_mxnet_params(state, args: Dict[str, np.ndarray],
                      auxs: Dict[str, np.ndarray]) -> None:
    """Fill a train state's (or a bare model's) parameters and BN running
    stats from MXNet-named dicts, in place. Every name of the model must
    be present with the model's shape; a name the model lacks (an MXNet v2
    file's ``bn_data_gamma``) is ignored, as the JAX package does."""
    with torch.no_grad():
        for name, aux, t in _tensors(_model(state)):
            table = auxs if aux else args
            if name not in table:
                raise KeyError(f"{'aux' if aux else 'arg'} table has no "
                               f"{name!r}")
            arr = np.asarray(table[name])
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{name}: table shape {arr.shape}, model "
                                 f"shape {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr)))


def save_mxnet_style(path_prefix: str, epoch: int, state,
                     fmt: str = "npz") -> str:
    """Write the reference's checkpoint layout from a train state (or a
    bare model).

    ``fmt="params"``: ``{prefix}-{epoch:04d}.params`` in MXNet's dmlc
    NDArray-list binary format (``utils/mxnet_params.py``), loadable by
    ``mx.nd.load`` and by the JAX package. ``fmt="npz"``: the same flat
    ``arg:``/``aux:`` dict as ``{prefix}-{epoch:04d}.params.npz``.
    """
    args, auxs = export_mxnet_params(state)
    if fmt == "params":
        from resnet_tpu_torch.utils.mxnet_params import save_params
        out = f"{path_prefix}-{epoch:04d}.params"
        save_params(out, args, auxs)
        return out
    if fmt != "npz":
        raise ValueError(f"fmt must be 'params' or 'npz', got {fmt!r}")
    flat = {f"arg:{k}": v for k, v in args.items()}
    flat.update({f"aux:{k}": v for k, v in auxs.items()})
    out = f"{path_prefix}-{epoch:04d}.params.npz"
    np.savez(out, **flat)
    return out


def load_mxnet_checkpoint(path_prefix: str, epoch: int, state) -> None:
    """Fill a train state's (or a bare model's) parameters and BN running
    stats from ``{prefix}-{epoch:04d}.params``, written by MXNet's
    ``mx.model.save_checkpoint``, by the JAX package or by
    :func:`save_mxnet_style`. Momentum is not in the file; the caller
    restarts it at zero, as an MXNet resume does."""
    from resnet_tpu_torch.utils.mxnet_params import load_params
    args, auxs = load_params(f"{path_prefix}-{epoch:04d}.params")
    load_mxnet_params(state, args, auxs)
