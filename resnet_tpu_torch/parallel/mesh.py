"""Replica layout of data-parallel training, port of
``resnet_tpu/parallel/mesh.py``.

The JAX package lays a 1-D ``data`` mesh over its devices and shards the
global batch along it (``NamedSharding(P("data"))``): device r holds the
r-th contiguous block. Here each device is one rank of the process group,
so the world size stands in for the mesh size and rank r holds that same
block; a K-stacked batch ``(k, batch, ...)`` is split along dim 1, as
``stacked_batch_sharded`` does. State is replicated: every rank holds all
of it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch


def check_num_devices(num_devices: int, world: int) -> int:
    """The replica count ``num_devices`` asks for: 0 means the world size;
    any other value must equal it (one process drives one device)."""
    if num_devices and num_devices != world:
        raise ValueError(
            f"requested {num_devices} devices, the process group has "
            f"{world} ranks (one process a device)")
    return world


def replica_block(n_global: int, rank: int, world: int) -> slice:
    """Rank ``rank``'s rows of a global batch of ``n_global``."""
    if n_global % world:
        raise ValueError(
            f"batch {n_global} not divisible by {world} replicas")
    n = n_global // world
    return slice(rank * n, (rank + 1) * n)


def shard_batch(batch: Mapping[str, torch.Tensor], rank: int, world: int,
                stacked: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch: dim 0, or dim 1 of a K-stacked
    batch (``stacked``)."""
    dim = 1 if stacked else 0
    out = {}
    for name, v in batch.items():
        block = replica_block(v.shape[dim], rank, world)
        out[name] = v[:, block] if stacked else v[block]
    return out
