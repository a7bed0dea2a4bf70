"""Device resolution for the port's entry points.

Entry points take ``device=None``, which means the CUDA card. Without a
card they raise instead of carrying on quietly on the CPU; the CPU runs
(the tests) ask for it with ``device="cpu"``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` -> ``cuda``; a CUDA request without a card raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return device


def set_tf32(enabled: bool) -> None:
    """TF32 for float32 convolutions (cuDNN) and matrix products (cuBLAS).

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; every float32 comparison on the card turns both
    switches off first.
    """
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
