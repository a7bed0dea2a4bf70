"""The 3-class stripe dataset of the record-pipeline convergence runs.

A copy of the JAX package's test fixture (``shard_tree`` in
``tests/test_convergence_record.py``): the class is the texture's
orientation (horizontal stripes, vertical stripes, a checkerboard), which
survives the ImageNet augmentation's HSL jitter, mirror and crops; the
images have four sizes, so the letterbox really resizes. 40 training
images a class packed by ``data/im2rec.py`` into three shards
(``train_000.rec`` ...), and 10 a class in ``val.rec``. The JPEG bytes
come from Pillow and numpy's generator at seed 0, so the shards are the
fixture's byte for byte.
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np

SIZES = [(56, 72), (80, 60), (64, 64), (72, 96)]


def build_stripe_tree(root: str) -> str:
    """Write the images and the shards under ``root`` (which must exist)
    and return ``root``."""
    from PIL import Image

    from resnet_tpu_torch.data.im2rec import build_list, pack

    rng = np.random.default_rng(0)

    def make(cls, h, w):
        y, x = np.mgrid[0:h, 0:w]
        if cls == 0:
            patt = (y // 6) % 2
        elif cls == 1:
            patt = (x // 6) % 2
        else:
            patt = ((y // 6) + (x // 6)) % 2
        arr = 60 + 130 * patt[:, :, None] + rng.normal(0, 12, (h, w, 3))
        return np.clip(arr, 0, 255).astype(np.uint8)

    def dump(src, count, name, shift):
        for cls in range(3):
            d = os.path.join(src, f"class_{cls}")
            os.makedirs(d)
            for i in range(count):
                h, w = SIZES[(cls + i + shift) % len(SIZES)]
                Image.fromarray(make(cls, h, w)).save(
                    os.path.join(d, f"{name}{i}.jpg"), quality=92)

    with contextlib.redirect_stdout(io.StringIO()):   # pack's "wrote" lines
        dump(root, 40, "i", 0)
        pack(root, os.path.join(root, "train"), build_list(root),
             num_shards=3)
        # val: the same distribution, fresh draws, one shard
        vroot = os.path.join(root, "valsrc")
        dump(vroot, 10, "v", 1)
        pack(vroot, os.path.join(root, "val"), build_list(vroot))
    return root
