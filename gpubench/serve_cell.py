"""A serving cell: the port's deployed path, as its ``serve_export`` tool
makes and loads it. Set-up builds the preset's model, puts the
benchmark's weights into it (their running statistics from one
batch-statistics pass of the reference over 32 served images), exports
the serving program with ``export_serving`` into the run's temporary
directory, loads it with ``load_serving`` and calls it ``warmup_calls``
times. One caller then sends pre-staged uint8 batches in a closed loop.

The answers compared: a sample of the window's batches, each call kept
with probability ``sample_share`` by a generator seeded from the run's
seed, and the window's last batch; every one against the reference's
logits of the same images.
"""

from __future__ import annotations

import dataclasses
import os
import random
import shutil
import statistics
import tempfile
from typing import Dict, List

import torch

from gpubench import compare, program, traffic, weights
from gpubench.reference import steps as reference
from gpubench.window import Laps, closed_loop, percentile

CALIBRATION_IMAGES = 32


class ServeCell:
    kind = "serve"
    window = staticmethod(closed_loop)
    TRAFFIC_KEYS = {"kind", "batch", "pool", "warmup_calls", "trace_calls",
                    "sample_share", "why"}

    def __init__(self, cell, seed: int, device):
        unknown = set(cell.traffic) - self.TRAFFIC_KEYS
        if unknown:
            raise ValueError(f"traffic keys a serve cell does not read: "
                             f"{sorted(unknown)}")
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.tr = cell.traffic
        self.ref_cfg = cell.config
        self.kept: Dict[int, list] = {}
        self.sampler = random.Random(seed)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from resnet_tpu_torch.models.registry import get_model
        from resnet_tpu_torch.utils import serving
        lap = Laps(self.sync)
        tr = dict(self.tr, image=self.ref_cfg["model"]["image"])
        cfg, self.departs = program.cell_config(self.cell.config, {},
                                                self.seed)
        program.backend_defaults(self.device.type)
        self.bs = tr["batch"]
        self.pool = traffic.serve_pool(tr, self.bs, self.seed, self.device)
        w = weights.make(self.ref_cfg, self.seed, self.device)
        reference.calibrate(self.ref_cfg, w,
                            self.pool[0][:CALIBRATION_IMAGES])
        self.weights = {n: t.cpu() for n, t in w.items()}
        lap("weights_traffic")
        model = get_model(cfg)
        weights.load_into(model, self.weights)
        lap("model")
        tmp = tempfile.mkdtemp(prefix="gpubench_serve_")
        try:
            prefix = os.path.join(tmp, "artifact")
            serving.export_serving(cfg, model, prefix, batch_size=self.bs,
                                   platforms=(self.device.type,))
            lap("export")
            self.serve, _ = serving.load_serving(prefix, device=self.device)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        lap("load")
        for i in range(self.tr["warmup_calls"]):
            self.serve(self.pool[i % len(self.pool)])
        lap("warmup")
        self.phases = lap.seconds
        self.calls = 0

    def call(self, _i: int = 0) -> None:
        j = self.calls % len(self.pool)
        out = self.serve(self.pool[j])
        if self.sampler.random() < self.tr["sample_share"]:
            self.kept.setdefault(j, []).append(out)
        self.last = (j, out)
        self.calls += 1

    def launches(self, first_call: int, calls: int) -> list:
        return []

    def measures(self, win: dict) -> Dict[str, float]:
        return {"serve_img_s": win["batches"] * self.bs / win["seconds"],
                "serve_batch_p95_ms": percentile(win["latency_s"], 95) * 1e3}

    def period(self, win: dict) -> float:
        return statistics.median(win["latency_s"])

    def diagnostics(self, win: dict) -> dict:
        lat = win["latency_s"]
        return {"batches": win["batches"], "batch": self.bs,
                "window_s": win["seconds"],
                "latency_ms_median": statistics.median(lat) * 1e3,
                "latency_ms_max": max(lat) * 1e3,
                "outside_batches_s": win["seconds"] - sum(lat)}

    def work(self, win: dict = None, n_calls: int = 0) -> int:
        """Batches attempted: the window's, or ``n_calls`` traced ones."""
        return win["batches"] if win else n_calls

    @property
    def compared(self) -> int:
        return sum(map(len, self.kept.values()))

    def traced_counts(self, calls: int) -> dict:
        return {"batches": calls, "images": calls * self.bs}

    def release(self) -> None:
        j, out = self.last
        self.kept.setdefault(j, []).append(out)
        self.kept = {j: [o.float().cpu() for o in outs]
                     for j, outs in self.kept.items()}
        self.inputs = {j: self.pool[j].cpu() for j in self.kept}
        del self.serve, self.pool, self.last
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        w = {n: t.to(self.device) for n, t in self.weights.items()}
        worst = {"logit_gap": 0.0, "logit_rms": 0.0}
        failed = 0
        for j, outs in self.kept.items():
            want = reference.serve_logits(self.ref_cfg, w,
                                          self.inputs[j].to(self.device))
            for out in outs:
                nums = {"logit_gap": compare.logit_gap(out, want),
                        "logit_rms": compare.rms_gap(out, want)}
                worst = {k: max(v, nums[k]) for k, v in worst.items()}
                failed += not compare.judge(nums, self.cell.limits)[0]
        return dict(worst, _failed=failed)

    @classmethod
    def program_readings(cls, cell, seed: int, device) -> Dict[str, float]:
        """The compared numbers of one set-up and one call of each pooled
        batch, every answer kept, with no window."""
        run = cls(dataclasses.replace(
            cell, traffic=dict(cell.traffic, warmup_calls=1,
                               sample_share=1.0)), seed, device)
        run.setup()
        for i in range(len(run.pool)):
            run.call(i)
        run.release()
        return run.check()

    @staticmethod
    def reference_readings(cell, seed: int, device) -> List[tuple]:
        """(side, numbers) of the reference in the program's place: in
        float8 (the control), in bfloat16, and with two answers
        exchanged (the fault a serve cell can have)."""
        cfg, arch = cell.config, cell.config["model"]
        w = weights.make(cfg, seed, device)
        pool = traffic.serve_pool(dict(cell.traffic, image=arch["image"]),
                                  cell.traffic["batch"], seed, device)
        reference.calibrate(cfg, w, pool[0][:CALIBRATION_IMAGES])
        images = pool[0]
        ref = reference.serve_logits(cfg, w, images)
        crossed = ref.clone()
        crossed[[0, 1]] = ref[[1, 0]]
        out = []
        for side, got in (
                ("control_fp8", reference.serve_logits(cfg, w, images,
                                                       "fp8")),
                ("bf16", reference.serve_logits(cfg, w, images, "bf16")),
                ("fault_crossed", crossed)):
            out.append((side, {"logit_gap": compare.logit_gap(got, ref),
                               "logit_rms": compare.rms_gap(got, ref)}))
        return out


Run = ServeCell
