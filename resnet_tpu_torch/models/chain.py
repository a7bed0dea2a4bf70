"""Chain execution of v1 bottleneck units (``unit_chain``), port of
``resnet_tpu/models/chain.py``.

Each 1x1 conv of the unit is one product (``ops/fused_unit.py``) that

  - normalizes its INPUT in the prologue, consuming the previous conv's
    RAW output plus that op's epilogue statistics (no activation is re-read
    for normalization), and
  - emits its OUTPUT's (sum, sum of squares) in the epilogue (no activation
    is re-read for statistics),

and its backward is one kernel launch producing dx/dW/dgamma/dbeta. The 3x3
conv stays on cuDNN; its input's normalize+ReLU and its own output
statistics remain separate PyTorch ops.

The unit's ``Conv`` and ``BatchNorm`` modules own the weights and running
statistics as on the standard path, so the parameter tree, ``state_dict()``
and the weight bridge do not change: ``unit_chain`` is purely a switch of
execution path. Eval always takes the standard path.

Where the ``BatchNorm`` modules carry a process ``group`` (``dp_mode=
"jit"``), every (sum, sum of squares) pair is summed over the group by a
differentiable all-reduce before the statistics are formed, and the count
is the global batch's: the statistics of the global batch, as the JAX
chain takes them when GSPMD partitions its sums. The backward all-reduces
the sums' cotangents, which the ops' backward then consumes.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from resnet_tpu_torch.models.fused import image_of, rows_of, weight_2d
from resnet_tpu_torch.ops.fused_unit import (matmul_stats,
                                             norm_relu_matmul_stats)
from resnet_tpu_torch.parallel.dist import all_reduce_sum


def _stats_from_sums(s, ss, count):
    mean = s / count
    var = ss / count - mean * mean          # not clamped at 0
    return mean, var


def _batch_stats(bn, s, ss, count):
    """Batch mean/var from the epilogue sums, over ``bn.group``'s global
    batch where ``bn`` has one; refreshes ``bn``'s running statistics
    (``ra = m*ra + (1-m)*batch``)."""
    if bn.group is not None:
        both = all_reduce_sum(torch.stack([s, ss]), bn.group)
        s, ss = both[0], both[1]
        count *= dist.get_world_size(bn.group)
    mean, var = _stats_from_sums(s, ss, count)
    bn._refresh(mean.detach(), var.detach())
    return mean, var


def chain_unit_v1(unit, x: torch.Tensor, backend: str = "pallas"
                  ) -> torch.Tensor:
    """One v1 bottleneck ``ResidualUnit`` on NCHW ``x``, chain dataflow
    (train mode only)."""
    dtype = unit.conv1.dtype
    n, _, h, w = x.shape
    eps = unit.bn1.eps

    def conv1x1_stats(inp2d, conv, bn):
        y, s, ss = matmul_stats(inp2d, weight_2d(conv, dtype), backend)
        return (y, *_batch_stats(bn, s, ss, inp2d.shape[0]))

    x2d = rows_of(x).to(dtype)

    # conv1 + bn1: the statistics ride the conv's epilogue
    y1, m1, v1 = conv1x1_stats(x2d, unit.conv1, unit.bn1)
    g1, b1 = unit.bn1.weight, unit.bn1.bias
    a1 = g1 * torch.rsqrt(v1 + eps)
    x2 = torch.relu(y1.float() * a1 + (b1 - m1 * a1)).to(dtype)

    # conv2: the 3x3 (the stride lives here) on cuDNN; its output
    # statistics are the one remaining reduction sweep
    y2 = unit.conv2(image_of(x2, n, h, w))
    n2, _, h2, w2 = y2.shape
    count2 = n2 * h2 * w2
    y2d = rows_of(y2)
    y2f = y2d.float()
    m2, v2 = _batch_stats(unit.bn2, y2f.sum(dim=0), (y2f * y2f).sum(dim=0),
                          count2)

    # conv3 consumes RAW y2 + bn2's statistics (prologue normalize+ReLU);
    # bn3's statistics ride its epilogue
    y3, s3, ss3 = norm_relu_matmul_stats(
        y2d, weight_2d(unit.conv3, dtype), m2, v2, unit.bn2.weight,
        unit.bn2.bias, eps, True, backend)
    m3, v3 = _batch_stats(unit.bn3, s3, ss3, count2)

    # shortcut: identity, or projection conv+BN with epilogue statistics
    if unit.dim_match:
        sc = x2d.float()
    else:
        s = unit.sc.stride
        xs2d = rows_of(x[:, :, ::s, ::s]).to(dtype)
        ysc, msc, vsc = conv1x1_stats(xs2d, unit.sc, unit.sc_bn)
        asc = unit.sc_bn.weight * torch.rsqrt(vsc + eps)
        sc = ysc.float() * asc + (unit.sc_bn.bias - msc * asc)

    a3 = unit.bn3.weight * torch.rsqrt(v3 + eps)
    out = torch.relu(y3.float() * a3 + (unit.bn3.bias - m3 * a3) + sc)
    return image_of(out.to(dtype), n2, h2, w2)
