"""Solver: the fit loop (ref:core/solver.py Solver.fit / mx Module.fit).
Port of ``resnet_tpu/train/solver.py``.

The host loop pulls prefetched batches (K stacked per call), fires the
K-step train call, and reads the metric sums off the device only every
``frequent`` batches for the Speedometer; in between it runs ahead of the
card, which works through the queued kernels. An epoch tail shorter than
K goes through a one-step call built at first need.

bn-ema (``bn_ema=True``) trains its first ``bn_ema_warmup`` steps
(negative: that many epochs) under full-batch BatchNorm, then switches
the model's ``BatchNorm`` modules to bn-ema at the next dispatch
boundary. The mode is a pure function of (config, step), so a resume on
either side of the switch lands in the same mode. The radial projection
of the update stays on throughout, as in the JAX package.

Data parallelism: inside a process group (``parallel/dist.py``, one
process a device, started by ``tools/launch.py``) every rank runs this
loop on its share of the data with the step of ``dp_mode``/``dp_sync``
(``train/steps.py``). Rank 0 alone logs below warnings, writes the
metrics file and the checkpoints; barriers around init, the loop and each
checkpoint keep any rank from reading a file being written. Every rank
loads on resume. Validation adds up each rank's sums once at the end.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import logging
import os
import re
import signal
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from resnet_tpu_torch.config import DTYPES, Config, require_ported
from resnet_tpu_torch.data.loader import DataIter
from resnet_tpu_torch.data.prefetch import prefetch_grouped, prefetch_to_device
from resnet_tpu_torch.models.resnet import BatchNorm
from resnet_tpu_torch.ops.augment import eval_center_crop, normalize
from resnet_tpu_torch.ops.augment_fused import make_augment_fn
from resnet_tpu_torch.ops.metrics import MetricAccumulator
from resnet_tpu_torch.parallel.dist import (barrier, check_equal,
                                            is_primary, local_device,
                                            proc_info, world_group)
from resnet_tpu_torch.parallel.mesh import check_num_devices
from resnet_tpu_torch.train import checkpoint as ckpt
from resnet_tpu_torch.train.callback import BatchEndParam, Speedometer
from resnet_tpu_torch.train.schedule import schedule_from_config
from resnet_tpu_torch.train.state import TrainState, create_train_state
from resnet_tpu_torch.train.steps import eval_step, make_train_step
from resnet_tpu_torch.utils.export import load_mxnet_checkpoint
from resnet_tpu_torch.utils.logging import setup_logging
from resnet_tpu_torch.utils.metric_writer import MetricWriter
from resnet_tpu_torch.utils.profiler import maybe_trace
from resnet_tpu_torch.utils.symbol_export import save_symbol

_SUM_KEYS = ("top1_sum", "top5_sum", "loss_sum", "count")


def _eval_fn(cfg: Config):
    """Validation preprocessing in the compute dtype: for CIFAR-10 the
    normalize; else a centre crop of a larger canvas, then the
    normalize."""
    d = cfg.data
    out_hw = tuple(d.image_shape[:2])
    dtype = DTYPES[cfg.train.dtype]
    cifar = cfg.model.dataset == "cifar10"

    def fn(images):
        if not cifar and tuple(images.shape[1:3]) != out_hw:
            return eval_center_crop(images, d, out_hw, dtype)
        return normalize(images, d.mean_rgb, d.std_rgb, dtype)
    return fn


def device_augment_config(cfg: Config) -> Config:
    """``cfg`` as the device augmenter must see it: where the record
    pipeline already warped the canvases on the host
    (``rotate_backend="host"``, ``data/host_warp.py``), its angles and
    shears are zeroed so that the device does not warp them twice. Other
    pipelines have no host decode stage and keep the device warp."""
    d = cfg.data
    if (cfg.model.dataset != "cifar10" and d.pipeline == "record"
            and d.rotate_backend == "host"
            and (d.max_rotate_angle > 0 or d.max_shear_ratio > 0)):
        return cfg.replace(data=dataclasses.replace(
            d, max_rotate_angle=0.0, max_shear_ratio=0.0))
    return cfg


def _pull(window: List[Dict[str, torch.Tensor]]) -> List[Dict[str, float]]:
    """Device metric sums -> host floats, in one copy."""
    if not window:
        return []
    rows = torch.stack([torch.stack([m[k].float() for k in _SUM_KEYS])
                        for m in window]).cpu().tolist()
    return [dict(zip(_SUM_KEYS, r)) for r in rows]


def latest_params_epoch(model_prefix: str) -> Optional[int]:
    """The newest epoch of ``{model_prefix}-NNNN.params``, or None."""
    pat = re.compile(re.escape(os.path.basename(model_prefix))
                     + r"-(\d{4})\.params$")
    epochs = [int(m.group(1)) for m in
              map(pat.match, map(os.path.basename,
                                 glob.glob(f"{model_prefix}-*.params")))
              if m]
    return max(epochs) if epochs else None


class Solver:
    """fit(train_iter, eval_iter) driver (ref:core/solver.py).
    ``device=None`` means the CUDA card (this rank's, in a process
    group)."""

    def __init__(self, cfg: Config, device=None,
                 log_file: Optional[str] = None):
        require_ported(cfg)
        self.log = setup_logging(log_file)
        world, rank = proc_info()
        if rank != 0:
            # head-node-only logging (ref: dist workers log on rank 0)
            self.log.setLevel(logging.WARNING)
        self.device = local_device(device)
        self.group = world_group()
        t = cfg.train
        n_dev = check_num_devices(t.num_devices, world)
        if t.batch_size % n_dev:
            raise ValueError(
                f"batch_size {t.batch_size} not divisible by {n_dev} devices")
        if t.sync_bn and t.dp_mode == "shard_map":
            # jit mode computes BN over the GLOBAL batch (sync-BN); the
            # shard_map path is the MXNet-parity per-replica BN
            raise ValueError(
                "sync_bn requires --dp-mode jit (global-batch BN); "
                "--dp-mode shard_map is per-replica BN like MXNet per-GPU")
        multi_jit = self.group is not None and t.dp_mode == "jit" \
            and n_dev > 1
        if multi_jit and cfg.data.augment_impl.startswith("pallas"):
            # the JAX package's rule: its Mosaic kernel cannot be
            # partitioned by GSPMD. Under "auto" K1 runs on each rank's
            # block with the global batch's draws
            raise ValueError(
                "augment_impl='pallas' cannot run under GSPMD jit on a "
                "multi-device mesh (Mosaic kernels cannot be automatically "
                "partitioned); use --dp-mode shard_map or "
                "--augment-impl xla (bit-identical)")
        if t.bn_subsample > 1 and t.dp_mode == "shard_map" and n_dev > 1:
            # bn_subsample counts sub-batches of the PER-REPLICA batch;
            # keep the intended absolute sample (batch/s images) by
            # rescaling, in this Solver's own copy of the config
            eff = max(1, t.bn_subsample // n_dev)
            self.log.info(
                "bn_subsample %d -> %d under %d-way shard_map "
                "(per-replica batches)", t.bn_subsample, eff, n_dev)
            cfg = cfg.replace(train=dataclasses.replace(t, bn_subsample=eff))
            t = cfg.train
        self.cfg = cfg
        # global-batch BatchNorm statistics under jit
        self._bn_group = self.group if t.dp_mode == "jit" else None
        self._sigterm = False
        self.iter_state = {}
        self.begin_epoch = t.begin_epoch
        self._host_step = 0
        self._bn_ema_switch = None
        self._bn_ema_pending = False
        self._spd = max(1, t.steps_per_dispatch)
        aug_fn = make_augment_fn(device_augment_config(cfg))
        comm_dtype = (torch.bfloat16 if t.dp_comm_dtype == "bfloat16"
                      else None)
        # an epoch tail's one-step call keeps dp_sync's cadence: at k=1
        # dispatch-sync is step-sync (train/steps.py)
        self._mk_step = lambda k: make_train_step(
            t.label_smooth, augment_fn=aug_fn, steps_per_dispatch=k,
            group=self.group, dp_mode=t.dp_mode, comm_dtype=comm_dtype,
            dp_sync=t.dp_sync)
        self.train_step = self._mk_step(self._spd)
        self._single_step = self.train_step if self._spd == 1 else None
        self.eval_step = functools.partial(eval_step,
                                           preprocess_fn=_eval_fn(cfg))
        self.schedule = schedule_from_config(cfg)
        # auto_reset: each log line (and metrics.jsonl 'train' row) reports
        # the window's average, as the reference's Speedometer does
        self.speedometer = Speedometer(t.batch_size, t.frequent,
                                       auto_reset=True)
        self.metric_writer = MetricWriter(
            f"{t.model_prefix}.metrics.jsonl"
            if t.model_prefix and rank == 0 else None)
        self.last_train_metrics: Dict[str, float] = {}

    # -- state ------------------------------------------------------------

    def init_state(self) -> TrainState:
        """Init params, or resume from --load-epoch / --auto-resume: the
        port's checkpoint of that epoch, else an MXNet
        ``{prefix}-NNNN.params`` (momentum zero, ``step = epoch ×
        steps_per_epoch``, the reference's own resume)."""
        t = self.cfg.train
        barrier("resnet_tpu:init")
        state = create_train_state(self.cfg, device=self.device,
                                   bn_group=self._bn_group)
        self.begin_epoch = t.begin_epoch
        self.iter_state = {}
        load_epoch = t.load_epoch
        if load_epoch is None and t.auto_resume and t.model_prefix:
            found = [e for e in (ckpt.latest_epoch(t.model_prefix),
                                 latest_params_epoch(t.model_prefix))
                     if e is not None]
            if found:
                load_epoch = max(found)
                self.log.info("auto-resume found epoch %d", load_epoch)
        if load_epoch is None:
            return state
        mx_params = f"{t.model_prefix}-{load_epoch:04d}.params"
        if (not ckpt.has_epoch(t.model_prefix, load_epoch)
                and os.path.exists(mx_params)):
            load_mxnet_checkpoint(t.model_prefix, load_epoch, state)
            steps_per_epoch = max(1, self.cfg.data.num_examples
                                  // t.batch_size)
            state.step = load_epoch * steps_per_epoch
            self.begin_epoch = load_epoch
            self.log.info("Resumed from MXNet checkpoint %s (epoch %d)",
                          mx_params, load_epoch)
            return state
        state, self.iter_state = ckpt.load_checkpoint(
            t.model_prefix, load_epoch, state)
        self.begin_epoch = load_epoch
        self.log.info("Resumed from epoch %d (step %d)", load_epoch,
                      state.step)
        return state

    def _set_bn_mode(self, model: torch.nn.Module, warmup: bool) -> None:
        """Full-batch BN during the bn-ema warmup, the configured mode
        after it."""
        t = self.cfg.train
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.ema = t.bn_ema and not warmup
                mod.subsample = 1 if warmup else t.bn_subsample
                mod.grouped = False if warmup else t.bn_grouped

    # -- loops ------------------------------------------------------------

    def train_epoch(self, state: TrainState, train_iter: DataIter,
                    epoch: int, start_nbatch: int = 0) -> TrainState:
        t = self.cfg.train
        # `win` resets after every Speedometer log; `acc` accumulates the
        # whole epoch for the end-of-epoch summary
        win, acc = MetricAccumulator(), MetricAccumulator()
        self.speedometer.reset()
        window = []   # device metric sums, read only at log time
        nbatch = start_nbatch   # nonzero on mid-epoch resume
        size = self.cfg.data.prefetch_buffer
        if self._spd == 1:
            source = ((b, 1) for b in prefetch_to_device(
                train_iter.epoch_iter(epoch), size=size, device=self.device))
        else:
            # grouping restarts at the epoch (and any resume) boundary, so
            # the cadences below test for crossing a multiple
            source = prefetch_grouped(train_iter.epoch_iter(epoch),
                                      self._spd, size=size,
                                      device=self.device)
        for batch, n in source:
            if self._bn_ema_pending and self._host_step >= self._bn_ema_switch:
                self._set_bn_mode(state.model, warmup=False)
                self._bn_ema_pending = False
                self.log.info(
                    "bn-ema: warmup done at step %d — switching to "
                    "running-stats normalization%s", self._host_step,
                    "" if self._host_step == self._bn_ema_switch else
                    f" (configured step {self._bn_ema_switch} rounded to "
                    f"the next {self._spd}-step dispatch boundary)")
            if n == self._spd:
                step_fn = self.train_step
            else:
                if self._single_step is None:   # epoch tail < K
                    self._single_step = self._mk_step(1)
                step_fn = self._single_step
            state, metrics = step_fn(state, batch)
            if t.check_numerics and not torch.isfinite(
                    metrics["loss_sum"]).item():
                raise FloatingPointError(
                    f"non-finite loss at step {self._host_step}")
            self._host_step += n
            prev_nbatch = nbatch
            nbatch += n
            window.append(metrics)
            if t.checkpoint_frequent and t.model_prefix \
                    and (nbatch // t.checkpoint_frequent
                         > prev_nbatch // t.checkpoint_frequent):
                self._save_mid_epoch(state, train_iter, epoch, nbatch)
            if self._sigterm:
                # save the exact position (state + data cursor) and exit;
                # a relaunch with --auto-resume replays the identical
                # remaining stream. With more than one rank the save
                # would wait at a barrier for ranks that may never come:
                # exit at once, and recovery resumes from the last
                # checkpoint all ranks wrote
                if t.model_prefix and proc_info()[0] == 1:
                    self._save_mid_epoch(state, train_iter, epoch, nbatch)
                    self.log.warning(
                        "SIGTERM: checkpointed epoch %d batch %d; exiting",
                        epoch, nbatch)
                else:
                    self.log.warning("SIGTERM at epoch %d batch %d: exiting "
                                     "without a checkpoint", epoch, nbatch)
                raise SystemExit(143)
            if nbatch // t.frequent > prev_nbatch // t.frequent:
                # the only read of the device in the loop
                for m in _pull(window):
                    win.update(m)
                    acc.update(m)
                window = []
                global_step = epoch * train_iter.steps_per_epoch + nbatch
                lr = self.schedule(global_step - 1)
                win_metrics = win.get()
                self.speedometer(BatchEndParam(
                    epoch=epoch, nbatch=nbatch, metrics=win_metrics, lr=lr),
                    reset_fn=win.reset)
                self.metric_writer.write(
                    "train", epoch, global_step, win_metrics, lr=lr,
                    samples_per_sec=self.speedometer.last_speed)
        for m in _pull(window):
            acc.update(m)
        m = acc.get()
        self.last_train_metrics = m
        self.log.info("Epoch[%d] Train-accuracy=%.6f", epoch, m["accuracy"])
        self.log.info("Epoch[%d] Train-cross-entropy=%.6f", epoch,
                      m["cross-entropy"])
        return state

    def validate(self, state: TrainState, eval_iter: DataIter,
                 epoch: int) -> dict:
        """Running-stats eval over one pass of ``eval_iter``; padded
        examples are masked out."""
        sums = _pull([self.eval_step(state, batch) for batch in
                      prefetch_to_device(eval_iter.epoch_iter(0), size=2,
                                         device=self.device)])
        if self.group is not None:
            # one reduction for the pass: ranks may hold different numbers
            # of val batches
            total = torch.tensor([[sum(m[k] for m in sums)
                                   for k in _SUM_KEYS]],
                                 dtype=torch.float64, device=self.device)
            dist.all_reduce(total, group=self.group)
            sums = [dict(zip(_SUM_KEYS, total[0].tolist()))]
        acc = MetricAccumulator()
        for m in sums:
            acc.update(m)
        m = acc.get()
        self.metric_writer.write("val", epoch, -1, m)
        self.log.info("Epoch[%d] Validation-accuracy=%.6f", epoch,
                      m["accuracy"])
        self.log.info("Epoch[%d] Validation-top_k_accuracy_5=%.6f", epoch,
                      m["top_k_accuracy_5"])
        self.log.info("Epoch[%d] Validation-cross-entropy=%.6f", epoch,
                      m["cross-entropy"])
        return m

    def _save_mid_epoch(self, state: TrainState, train_iter: DataIter,
                        epoch: int, nbatch: int) -> None:
        """Batch-granular save: the file of the completed-epoch count
        (``epoch``), with the consumed position inside the epoch in the
        iterator state, so ``--auto-resume`` restarts at ``epoch`` and the
        iterator seeks to the exact batch."""
        self._save(epoch, state, train_iter.cursor_state(nbatch))
        self.log.info("Saved mid-epoch checkpoint (epoch %d, batch %d)",
                      epoch, nbatch)

    def _save(self, epoch: int, state: TrainState, iter_state: dict) -> None:
        """Rank 0 writes the checkpoint (the replicas hold one state);
        every rank waits until the file is whole."""
        if is_primary():
            ckpt.save_checkpoint(self.cfg.train.model_prefix, epoch, state,
                                 iter_state=iter_state)
        barrier("resnet_tpu:checkpoint")

    def fit(self, train_iter: DataIter,
            eval_iter: Optional[DataIter] = None,
            num_epochs: Optional[int] = None) -> TrainState:
        """The training entry (ref: Module.fit / Solver.fit)."""
        t = self.cfg.train
        state = self.init_state()
        train_iter.load_state_dict(self.iter_state)  # replay data stream
        num_epochs = num_epochs or t.num_epochs
        self._host_step = state.step   # == global batches completed
        if t.bn_ema:
            self._bn_ema_switch = (
                t.bn_ema_warmup if t.bn_ema_warmup >= 0
                else -t.bn_ema_warmup * train_iter.steps_per_epoch)
            warm = self._host_step < self._bn_ema_switch
            self._set_bn_mode(state.model, warmup=warm)
            self._bn_ema_pending = warm
        # ranks that ran different numbers of steps would hang in a
        # collective
        check_equal(train_iter.steps_per_epoch, "steps per epoch",
                    self.device)
        if t.model_prefix and is_primary():
            # the checkpoint pair carries its own graph, as
            # mx.model.save_checkpoint writes prefix-symbol.json beside the
            # .params files; tools/predict.py reads the network back from it
            save_symbol(t.model_prefix, self.cfg)
        barrier("resnet_tpu:fit")

        # SIGTERM -> one final mid-epoch save, then exit 143. The handler
        # only flips a flag; the save happens at a batch boundary in
        # train_epoch. Main thread only: signal.signal raises elsewhere.
        self._sigterm = False
        prev_handler = None
        if threading.current_thread() is threading.main_thread() \
                and t.model_prefix:
            def _on_term(signum, frame):
                self._sigterm = True
            prev_handler = signal.signal(signal.SIGTERM, _on_term)

        try:
            with torch.autograd.set_detect_anomaly(t.check_numerics):
                for epoch in range(self.begin_epoch, num_epochs):
                    state = self._fit_epoch(state, train_iter, eval_iter,
                                            epoch)
        finally:
            if prev_handler is not None:
                signal.signal(signal.SIGTERM, prev_handler)
        return state

    def _fit_epoch(self, state: TrainState, train_iter: DataIter,
                   eval_iter: Optional[DataIter], epoch: int) -> TrainState:
        t = self.cfg.train
        tic = time.perf_counter()
        if epoch == self.begin_epoch:
            # mid-epoch resume: keep batch numbering (Speedometer, logged
            # lr, checkpoint cadence) aligned with the seeked data stream
            start_nbatch = (self.iter_state.get("batch", 0)
                            if self.iter_state.get("epoch") == epoch else 0)
            start_nbatch = min(start_nbatch, train_iter.steps_per_epoch)
            # RESNET_TPU_PROFILE=<logdir> traces the first epoch
            with maybe_trace():
                state = self.train_epoch(state, train_iter, epoch,
                                         start_nbatch)
        else:
            state = self.train_epoch(state, train_iter, epoch)
        self.log.info("Epoch[%d] Time cost=%.3f", epoch,
                      time.perf_counter() - tic)
        if eval_iter is not None:
            self.validate(state, eval_iter, epoch)
        if t.model_prefix:
            self._save(epoch + 1, state, train_iter.state_dict())
        return state
