"""Stem max-pool (ref:symbol/resnet.py ``Pooling(kernel=(3,3),
stride=(2,2), pool_type='max')``).

Port of ``resnet_tpu/ops/pool.py`` in its ``sas`` mode: the backward gives
each window's whole cotangent to its first maximum in scan order, as the
JAX package's ``select_and_scatter`` does (pinned on post-ReLU ties by the
port's tests). The ``mask`` mode, which splits it among ties, is not
ported yet.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def stem_max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 max pool over an NCHW (channels_last) tensor."""
    return F.max_pool2d(x, kernel_size=3, stride=2, padding=1)
