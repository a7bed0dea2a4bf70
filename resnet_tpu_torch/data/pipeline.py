"""Record-backed input pipeline: the native decode pool behind a prefetch
thread. Port of ``resnet_tpu/data/pipeline.py``.

A background thread drives the decode pool (``data/native.py``) and keeps
``prefetch_buffer`` canvas batches queued; the training loop pops ready
batches, so decode of batch N+1 overlaps the device's work on batch N.
Augmentation happens on the device, never here.

Shard sets: ``train_rec`` may be a single file, a glob (``train_*.rec``),
or an ``im2rec``-style prefix whose ``<prefix>_NNN.rec`` shards are found.

Canvas contract: train batches are LETTERBOXED uint8 canvases + per-image
dims, so the on-device random-resized-crop samples the full original
image. Val batches are shorter-side-resized + centre-cropped; for 224x224
output the canvas is 256x256, the reference's resize-256/crop-224.

Checkpoint state: ``cursor_state(nbatch)`` gives (epoch, batch, record)
as CONSUMED by the trainer, and resume seeks the deterministic epoch
stream to that record, so a mid-epoch resume replays the identical
remaining stream.

Data parallelism: ``num_parts``/``part_index`` hand each process every
``num_parts``-th record from ``part_index`` on, in batches of
``batch_size // num_parts``.

Host warp: with ``rotate_backend="host"`` and a nonzero
``max_rotate_angle`` or ``max_shear_ratio``, train canvases are warped in
the decode stage (``data/host_warp.py``), with per-batch parameters a
pure function of (seed, epoch, batch), so a resume replays the same warp
stream; the Solver then zeroes the device augmenter's angles.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np

from resnet_tpu_torch.config import DataConfig
from resnet_tpu_torch.data import host_warp
from resnet_tpu_torch.data.loader import DataIter


def canvas_size(out_hw: Tuple[int, int],
                override: int = 0) -> Tuple[int, int]:
    """256 for 224 (the standard 8/7), identity for small (CIFAR) inputs;
    ``override`` (cfg.data.canvas_size) pins the train canvas edge."""
    if override:
        return override, override
    h, w = out_hw
    if h <= 64 and w <= 64:
        return h, w
    return (h * 8 + 6) // 7, (w * 8 + 6) // 7


def resolve_shards(data_dir: str, name: str) -> List[str]:
    """Resolve a rec spec to an ordered shard list: a plain file, a glob
    pattern, or an im2rec prefix whose ``prefix_000.rec ..`` shards are
    found when ``prefix.rec`` is absent."""
    path = os.path.join(data_dir, name)
    if any(c in name for c in "*?["):
        recs = sorted(glob.glob(path))
    elif os.path.exists(path):
        recs = [path]
    else:
        stem = path[:-4] if path.endswith(".rec") else path
        recs = sorted(glob.glob(stem + "_[0-9]*.rec"))
    if not recs:
        raise FileNotFoundError(f"no .rec shards match {path!r}")
    return recs


class RecordIter(DataIter):
    """DataIter over a .rec shard set via the record loader."""

    def __init__(self, cfg, train: bool, num_parts: int = 1,
                 part_index: int = 0):
        d, t = cfg.data, cfg.train
        recs = resolve_shards(d.data_dir, d.train_rec if train else d.val_rec)
        # an explicitly configured index file for a single-file rec wins
        # over the rec's own sibling .idx only when the user set it (name
        # differs from the default) or the sibling is absent: a stale
        # default-named train.idx beside custom.rec must not pair with it
        cfg_name = d.train_idx if train else d.val_idx
        default_name = (DataConfig.train_idx if train else DataConfig.val_idx)
        cfg_idx = os.path.join(d.data_dir, cfg_name)
        idxs = []
        for rec in recs:
            idx = rec[:-4] + ".idx" if rec.endswith(".rec") else rec + ".idx"
            if (len(recs) == 1 and os.path.exists(cfg_idx)
                    and (cfg_name != default_name
                         or not os.path.exists(idx))):
                idx = cfg_idx
            idxs.append(idx if os.path.exists(idx) else "")
        self.train = train
        self.shuffle = d.shuffle and train
        self.seed = t.seed
        # batch_size is global; each process decodes its 1/num_parts share
        self.batch_size = t.batch_size // max(num_parts, 1)
        self.prefetch_buffer = max(1, d.prefetch_buffer)
        # the canvas override is a TRAIN fidelity knob; the val transform
        # stays at the reference's fixed resize-256/centre-crop-224
        self.canvas_hw = canvas_size(
            d.image_shape[:2], override=d.canvas_size if train else 0)

        from resnet_tpu_torch.data.native import make_record_loader
        self.loader = make_record_loader(
            recs, idxs, self.canvas_hw, threads=d.preprocess_threads,
            num_parts=num_parts, part_index=part_index, letterbox=train)
        # the host rotate/shear warp, train only
        self._warp = None
        self._warp_pool = None
        if (train and d.rotate_backend == "host"
                and (d.max_rotate_angle > 0 or d.max_shear_ratio > 0)):
            from concurrent.futures import ThreadPoolExecutor
            self._warp = (d.max_rotate_angle, d.max_shear_ratio)
            self._warp_pool = ThreadPoolExecutor(
                max_workers=max(1, d.preprocess_threads))
        n = self.loader.num_records
        if train:
            self.steps_per_epoch = max(n // self.batch_size, 1)
        else:
            self.steps_per_epoch = (n + self.batch_size - 1) \
                // self.batch_size
        self._epoch = 0
        self._batches_done = 0
        self._records_done = 0   # records CONSUMED (incl. corrupt-dropped)
        self._resume = None  # (epoch, batch, record) to seek on epoch_iter
        self._cursor_hist = {}

    # -- iteration ---------------------------------------------------------

    def _fill_batch(self):
        """Accumulate loader output until the batch is full or the epoch
        ends (the loader drops corrupt records; the batch is topped up with
        the next records, as the reference does)."""
        bs = self.batch_size
        parts = []
        have = 0
        while have < bs:
            images, labels, dims = self.loader.next_batch(bs - have)
            if len(images) == 0:
                break
            parts.append((images, labels, dims))
            have += len(images)
        if not parts:
            return None
        if len(parts) == 1:
            return parts[0]
        images = np.concatenate([p[0] for p in parts])
        labels = np.concatenate([p[1] for p in parts])
        dims = (np.concatenate([p[2] for p in parts])
                if parts[0][2] is not None else None)
        return images, labels, dims

    def epoch_iter(self, epoch: int) -> Iterator[dict]:
        self._epoch = epoch
        self._batches_done = 0
        self._records_done = 0
        self.loader.begin_epoch(epoch, self.shuffle, self.seed)
        start_batch = 0
        start_record = 0
        if self._resume and self._resume[0] == epoch and self._resume[1]:
            # mid-epoch resume: seek by RECORDS consumed (a corrupt-record
            # drop makes a batch consume more than batch_size records)
            start_batch = min(self._resume[1], self.steps_per_epoch)
            start_record = self._resume[2]
            self.loader.skip(start_record)
            self._batches_done = start_batch
            self._records_done = start_record
        self._resume = None
        # batch index -> cumulative records, for cursor_state(): the queue
        # pulls this generator AHEAD of the train step
        self._cursor_hist = {start_batch: start_record}
        q: queue.Queue = queue.Queue(maxsize=self.prefetch_buffer)
        stop = threading.Event()

        def producer():
            try:
                for k in range(start_batch, self.steps_per_epoch):
                    if stop.is_set():
                        return
                    out = self._fill_batch()
                    if out is None:
                        break
                    if self.train and len(out[0]) < self.batch_size:
                        # drop the corrupt-shortened tail batch: a padded
                        # train batch would bias the gradients
                        break
                    if self._warp is not None:
                        angles, shears = host_warp.batch_params(
                            self.seed, epoch, k, len(out[0]), *self._warp)
                        out = (host_warp.warp_batch(out[0], angles, shears,
                                                    self._warp_pool),
                               out[1], out[2])
                    q.put((self._to_batch(*out),
                           self.loader.records_consumed))
            finally:
                q.put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                batch, consumed = item
                self._batches_done += 1
                self._records_done = consumed
                self._cursor_hist[self._batches_done] = consumed
                yield batch
        finally:
            stop.set()
            # drain so the producer can finish putting
            while th.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    th.join(timeout=0.1)

    def _to_batch(self, images: np.ndarray, labels: np.ndarray,
                  dims: Optional[np.ndarray]) -> dict:
        n = len(images)
        bs = self.batch_size
        batch = {"image": images, "label": labels.astype(np.int32)}
        if dims is not None:
            batch["dims"] = dims
        if n < bs:
            # pad + mask (val tail)
            pad = bs - n
            batch["image"] = np.concatenate(
                [images, np.zeros((pad,) + images.shape[1:], np.uint8)])
            batch["label"] = np.concatenate(
                [batch["label"], np.zeros(pad, np.int32)])
            batch["mask"] = np.concatenate(
                [np.ones(n, np.float32), np.zeros(pad, np.float32)])
            if dims is not None:
                batch["dims"] = np.concatenate(
                    [dims, np.ones((pad, 4), np.int32)])
        elif not self.train:
            batch["mask"] = np.ones(bs, np.float32)
        return batch

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        return {"epoch": self._epoch, "batch": self._batches_done,
                "record": self._records_done}

    def cursor_state(self, nbatch: int) -> dict:
        """Cursor for "``nbatch`` batches consumed" (see DataIter)."""
        hist = self._cursor_hist
        record = hist.get(nbatch, nbatch * self.batch_size)
        for k in [k for k in hist if k < nbatch]:   # prune consumed entries
            del hist[k]
        return {"epoch": self._epoch, "batch": nbatch, "record": record}

    def load_state_dict(self, state: dict) -> None:
        self._epoch = state.get("epoch", 0)
        batch = state.get("batch", 0)
        record = state.get("record", batch * self.batch_size)
        self._resume = (self._epoch, batch, record)
