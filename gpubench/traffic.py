"""The one traffic generator: turns a mix's parameter file
(``traffic/<name>.json``) and the run's seed into the device tensors a
cell feeds the program. Every seed gets the same sizes and counts; the
seed changes only the pixels, the letterbox extents and the labels.

Kinds:

  - ``train``: ``pool_calls`` pre-staged train calls, each ``k`` batches
    of ``batch`` uint8 canvases (``canvas`` square) stacked on a leading
    axis, with ``dims`` (original h, w, letterboxed h, w) and labels.
    Every image is letterboxed as the record pipeline does it: original
    sides drawn uniformly from ``orig_side``, the longer side scaled to
    the canvas, zero beyond the image;
  - ``serve``: ``pool`` pre-staged uint8 batches of ``batch`` centre-
    cropped ``image`` x ``image`` canvases.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

# stream ids: the traffic and the weights draw from different streams of
# one seed
TRAFFIC_STREAM, WEIGHTS_STREAM = 1, 2


def seeded(seed: int, stream: int, device) -> torch.Generator:
    word = np.random.SeedSequence([seed, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(word[0]) >> 1)


def train_pool(spec: dict, batch: int, k: int, num_classes: int, seed: int,
               device) -> List[Dict[str, torch.Tensor]]:
    gen = seeded(seed, TRAFFIC_STREAM, device)
    calls, side = spec["pool_calls"], spec["canvas"]
    lo, hi = spec["orig_side"]
    shape = (calls, k, batch)
    orig = torch.randint(lo, hi, shape + (2,), generator=gen, device=device)
    eff = torch.round(orig.float() * (side / orig.max(dim=-1).values.float()
                                      )[..., None]).clamp(1, side)
    dims = torch.cat([orig, eff.long()], dim=-1).to(torch.int32)
    images = torch.randint(0, 256, shape + (side, side, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    idx = torch.arange(side, device=device)
    inside = ((idx[:, None] < dims[..., 2, None, None])
              & (idx[None, :] < dims[..., 3, None, None]))
    images *= inside[..., None].to(torch.uint8)
    labels = torch.randint(0, num_classes, shape, generator=gen,
                           device=device)
    return [{"image": images[c], "label": labels[c], "dims": dims[c]}
            for c in range(calls)]


def serve_pool(spec: dict, batch: int, seed: int, device
               ) -> List[torch.Tensor]:
    gen = seeded(seed, TRAFFIC_STREAM, device)
    side = spec["image"]
    images = torch.randint(0, 256, (spec["pool"], batch, side, side, 3),
                           generator=gen, device=device, dtype=torch.uint8)
    return list(images.unbind(0))
