"""Host-side data iterators: synthetic, in-memory and record-backed.

Port of ``resnet_tpu/data/loader.py`` for one process. Iterators yield host
numpy batches ``{"image": uint8 NHWC, "label": int32}`` (plus ``dims``
from the record pipeline's letterbox and ``mask`` on padded val batches);
decode runs below (``data/pipeline.py`` and the native reader),
augmentation above, on the device (``ops/augment_fused.py``).

Determinism: the order is a pure function of (seed, epoch), and iterators
expose ``state_dict()``/``load_state_dict()`` so a checkpoint resume
replays the exact stream.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterator, Optional

import numpy as np


class DataIter:
    """Iterator protocol shared by all pipelines."""

    batch_size: int
    steps_per_epoch: int

    def epoch_iter(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        raise NotImplementedError

    def state_dict(self) -> dict:
        return {}

    def cursor_state(self, nbatch: int) -> dict:
        """Checkpoint cursor for "the first ``nbatch`` batches of the
        current epoch were CONSUMED by the trainer".

        Distinct from ``state_dict()`` because prefetching runs this
        iterator ahead of the train step: a mid-epoch save must record
        the consumed position, not the produced one, or resume would skip
        batches that were never trained on. ``state_dict()`` remains the
        epoch-boundary snapshot (production == consumption there).
        """
        return self.state_dict()

    def load_state_dict(self, state: dict) -> None:
        pass


class SyntheticIter(DataIter):
    """One fixed random batch resident in host RAM, repeated: zero decode
    cost."""

    def __init__(self, batch_size: int, image_shape, num_classes: int,
                 steps_per_epoch: int = 100, seed: int = 0):
        rng = np.random.default_rng(seed)
        h, w, c = image_shape
        self.batch_size = batch_size
        self.steps_per_epoch = steps_per_epoch
        self._batch = {
            "image": rng.integers(0, 256, (batch_size, h, w, c),
                                  dtype=np.uint8),
            "label": rng.integers(0, num_classes, (batch_size,),
                                  dtype=np.int32),
        }

    def epoch_iter(self, epoch: int):
        for _ in range(self.steps_per_epoch):
            yield self._batch


class MemoryIter(DataIter):
    """In-memory dataset (the mx.io.NDArrayIter analog) with deterministic
    per-epoch shuffling."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True, pad_last: bool = False):
        if images.dtype != np.uint8 or images.ndim != 4:
            raise ValueError(f"images must be uint8 NHWC, got {images.dtype} "
                             f"{images.shape}")
        self.images = images
        self.labels = labels.astype(np.int32)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        n = len(self.images)
        if drop_last and not pad_last:
            self.steps_per_epoch = n // batch_size
        else:
            self.steps_per_epoch = (n + batch_size - 1) // batch_size
        self.pad_last = pad_last
        self._epoch = 0
        self._batches_done = 0
        self._resume = None   # (epoch, batch) to seek on epoch_iter

    def epoch_iter(self, epoch: int):
        self._epoch = epoch
        self._batches_done = 0
        n = len(self.images)
        order = np.arange(n)
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        bs = self.batch_size
        start = 0
        if self._resume and self._resume[0] == epoch and self._resume[1]:
            # mid-epoch resume: the (seed, epoch) order is deterministic,
            # so skipping the first B batches replays the remaining stream
            start = min(self._resume[1], self.steps_per_epoch)
            self._batches_done = start
        self._resume = None
        for step in range(start, self.steps_per_epoch):
            idx = order[step * bs:(step + 1) * bs]
            self._batches_done = step + 1
            batch = {"image": self.images[idx], "label": self.labels[idx]}
            if len(idx) < bs and self.pad_last:
                pad = bs - len(idx)
                batch = {
                    "image": np.concatenate(
                        [batch["image"], batch["image"][:1].repeat(pad, 0)]),
                    "label": np.concatenate(
                        [batch["label"], batch["label"][:1].repeat(pad, 0)]),
                    "mask": np.concatenate(
                        [np.ones(len(idx), np.float32),
                         np.zeros(pad, np.float32)]),
                }
            elif self.pad_last:
                batch["mask"] = np.ones(bs, np.float32)
            yield batch

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "batch": self._batches_done}

    def cursor_state(self, nbatch: int) -> dict:
        # the (seed, epoch) order is deterministic, so the consumed-batch
        # count alone pins the resume point exactly
        return {"epoch": self._epoch, "batch": nbatch}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = state.get("epoch", 0)
        self._resume = (self._epoch, state.get("batch", 0))


def synthetic_cifar(num_examples: int = 2048, num_classes: int = 10,
                    image_shape=(32, 32, 3), seed: int = 0):
    """Class-separable synthetic dataset: images are noise + a
    class-dependent mean shift, so a real model must learn to separate
    them."""
    rng = np.random.default_rng(seed)
    h, w, c = image_shape
    labels = rng.integers(0, num_classes, num_examples).astype(np.int32)
    # class signatures come from a FIXED seed so train/val splits (different
    # seeds) share the same underlying classes
    base = np.random.default_rng(1234).integers(
        64, 192, (num_classes, 1, 1, c))
    noise = rng.normal(0, 24, (num_examples, h, w, c))
    images = np.clip(base[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels


def make_train_iter(cfg) -> DataIter:
    """Pipeline selector (ref:core/loader.py get_data_iter)."""
    t, d = cfg.train, cfg.data
    if d.pipeline == "synthetic":
        steps = max(d.num_examples // t.batch_size, 1)
        return SyntheticIter(t.batch_size, d.image_shape, d.num_classes,
                             steps_per_epoch=steps, seed=t.seed)
    if d.pipeline == "memory":
        images, labels = synthetic_cifar(
            d.num_examples, d.num_classes, d.image_shape, seed=t.seed)
        return MemoryIter(images, labels, t.batch_size, shuffle=d.shuffle,
                          seed=t.seed)
    if d.pipeline == "record":
        from resnet_tpu_torch.data.pipeline import RecordIter
        return RecordIter(cfg, train=True)
    raise ValueError(f"unknown pipeline {d.pipeline!r}")


def make_val_iter(cfg) -> Optional[DataIter]:
    """Validation iterator (centre-crop only path), or None."""
    t, d = cfg.train, cfg.data
    if d.pipeline == "synthetic":
        return None
    if d.pipeline == "memory":
        # held-out split, distinct seed from train
        images, labels = synthetic_cifar(
            max(d.num_examples // 10, t.batch_size), d.num_classes,
            d.image_shape, seed=t.seed + 10_000)
        return MemoryIter(images, labels, t.batch_size, shuffle=False,
                          seed=t.seed, drop_last=False, pad_last=True)
    if d.pipeline == "record":
        from resnet_tpu_torch.data.pipeline import RecordIter, resolve_shards
        try:
            resolve_shards(d.data_dir, d.val_rec)
        except FileNotFoundError:
            logging.getLogger("resnet_tpu_torch").warning(
                "no val .rec found (%s/%s): skipping validation",
                d.data_dir, d.val_rec)
            return None
        return RecordIter(cfg, train=False)
    raise ValueError(f"unknown pipeline {d.pipeline!r}")
