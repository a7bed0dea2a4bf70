"""A training cell: the port's K-step train call as its ``Solver`` builds
it, at the configuration's preset, fed pre-staged device batches.

Set-up builds one Solver, its train state and its train call; puts the
benchmark's weights into the state; switches BatchNorm to the mode the
configuration states for after the Solver's warm-up epochs (its
``train.bn_ema``; with it, bn-ema, the steady state of a run); and drives the call from the seed through its first call, in
which hooks on the model and the loss record the compared steps (the
``check_steps`` first). Then ``warmup_calls`` more calls, so that cuDNN's
autotuner has timed every shape and the allocator holds its blocks. The
same state and call go on into the window.
"""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List

import torch

from gpubench import compare, program, traffic, weights
from gpubench.window import Laps, calls_window
from gpubench.reference import steps as reference


def _cpu(named) -> Dict[str, torch.Tensor]:
    return {n: t.detach().float().cpu().clone() for n, t in named}


class Capture:
    """Records the first ``n`` steps of the calls made while it is open:
    each step's model input (the augmenter's output) and loss, the first
    step's logits, the parameters and running statistics before step 0
    and before step ``n``, and the momentum before step 1, from which the
    first update's gradient follows: ``g = -mom / lr - wd * w``."""

    def __init__(self, state, n: int, lr: float, wd: float):
        import resnet_tpu_torch.train.steps as steps_mod
        self.state, self.n, self.lr, self.wd = state, n, lr, wd
        self.forwards = 0
        model = state.model
        self.rec: dict = {"aug": [], "loss": [],
                          "w0": _cpu(model.named_parameters()),
                          "b0": _cpu(model.named_buffers())}
        self._losses: List[torch.Tensor] = []
        self._hooks = [model.register_forward_pre_hook(self._pre),
                       model.register_forward_hook(self._post)]
        self._steps_mod = steps_mod
        self._loss_fn = steps_mod.cross_entropy_loss
        steps_mod.cross_entropy_loss = self._loss

    @property
    def done(self) -> bool:
        return self.forwards > self.n

    def _pre(self, module, args):
        i = self.forwards
        self.forwards += 1
        model = self.state.model
        if i == 1:
            names = [n for n, _ in model.named_parameters()]
            self.rec["mom1"] = {
                n: m.detach().float().cpu().clone()
                for n, m in zip(names, self.state.momentum)}
        if i == self.n:
            self.rec["w3"] = _cpu(model.named_parameters())
            self.rec["b3"] = _cpu(model.named_buffers())
        if i < self.n:
            self.rec["aug"].append(args[0].detach().cpu().clone())

    def _post(self, module, args, out):
        if self.forwards == 1:
            self.rec["logits0"] = out.detach().float().cpu().clone()

    def _loss(self, *args, **kwargs):
        loss = self._loss_fn(*args, **kwargs)
        if len(self._losses) < self.n:
            self._losses.append(loss.detach().clone())
        return loss

    def close(self) -> dict:
        for h in self._hooks:
            h.remove()
        self._steps_mod.cross_entropy_loss = self._loss_fn
        rec = self.rec
        rec["loss"] = [float(x) for x in self._losses]
        rec["g1"] = {n: -m / self.lr - self.wd * rec["w0"][n]
                     for n, m in rec.pop("mom1").items()}
        return rec


class TrainCell:
    kind = "train"
    window = staticmethod(calls_window)
    TRAFFIC_KEYS = {"kind", "canvas", "orig_side", "pool_calls", "batch",
                    "check_steps", "warmup_calls", "trace_calls", "why"}

    def __init__(self, cell, seed: int, device):
        unknown = set(cell.traffic) - self.TRAFFIC_KEYS
        if unknown:
            raise ValueError(f"traffic keys a train cell does not read: "
                             f"{sorted(unknown)}")
        self.cell, self.seed = cell, seed
        self.device = torch.device(device)
        self.tr = cell.traffic
        self.ref_cfg = cell.config

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        from resnet_tpu_torch.train.solver import Solver
        lap = Laps(self.sync)
        cfg, self.departs = program.cell_config(self.cell.config, self.tr,
                                                self.seed)
        program.backend_defaults(self.device.type)
        solver = Solver(cfg, device=self.device)
        state = solver.init_state()
        # the BatchNorm mode of ``cfg.train`` (``bn_ema``, ``bn_subsample``,
        # ``bn_grouped``) as the Solver sets it once its warm-up has ended
        solver._set_bn_mode(state.model, warmup=False)
        lap("solver")
        arch = self.ref_cfg["model"]
        weights.load_into(state.model, weights.make(self.ref_cfg, self.seed,
                                                    self.device))
        self.k, self.bs = cfg.train.steps_per_dispatch, cfg.train.batch_size
        self.pool = traffic.train_pool(self.tr, self.bs, self.k,
                                       arch["num_classes"], self.seed,
                                       self.device)
        lap("weights_traffic")
        self.step_fn, self.state = solver.train_step, state
        self.calls = 0
        n = self.tr["check_steps"]
        hyper = self.ref_cfg["train"]
        capture = Capture(state, n, hyper["lr"], hyper["wd"])
        while not capture.done:
            self.call()
        self.sync()
        self.record = capture.close()
        first = self.pool[0]
        self.check_batches = [(first["image"][i].clone(),
                               first["dims"][i].clone(),
                               first["label"][i].clone()) for i in range(n)]
        lap("first_call")
        for _ in range(self.tr["warmup_calls"]):
            self.call()
        lap("warmup")
        self.phases = lap.seconds

    def call(self, _i: int = 0) -> None:
        self.state, _ = self.step_fn(self.state,
                                     self.pool[self.calls % len(self.pool)])
        self.calls += 1

    def launches(self, first_call: int, calls: int) -> list:
        """(step, dims) of every step of ``calls`` calls from call
        ``first_call`` on: what K1's byte count reads."""
        out = []
        for c in range(first_call, first_call + calls):
            dims = self.pool[c % len(self.pool)]["dims"]
            out += [(c * self.k + i, dims[i]) for i in range(self.k)]
        return out

    def measures(self, win: dict) -> Dict[str, float]:
        return {"train_img_s": win["calls"] * self.k * self.bs
                / win["seconds"]}

    def period(self, win: dict) -> float:
        return win["seconds"] / win["calls"]

    def diagnostics(self, win: dict) -> dict:
        return {"calls": win["calls"], "steps_per_call": self.k,
                "batch": self.bs, "window_s": win["seconds"],
                "call_period_s": win["seconds"] / win["calls"],
                "host_call_s_median": statistics.median(win["host_s"])}

    def work(self, win: dict = None, n_calls: int = 0) -> int:
        """Steps attempted: the window's, or ``n_calls`` traced calls'."""
        return (win["calls"] if win else n_calls) * self.k

    @property
    def compared(self) -> int:
        return self.tr["check_steps"]

    def traced_counts(self, calls: int) -> dict:
        return {"steps": calls * self.k, "images": calls * self.k * self.bs}

    def release(self) -> None:
        del self.state, self.step_fn, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, float]:
        ref = reference.train_steps(
            self.ref_cfg, weights.make(self.ref_cfg, self.seed, self.device),
            self.check_batches, self.seed)
        return compare.train_numbers(self.record, ref)

    @classmethod
    def program_readings(cls, cell, seed: int, device) -> Dict[str, float]:
        """The compared numbers of one set-up, with no window."""
        run = cls(dataclasses.replace(
            cell, traffic=dict(cell.traffic, warmup_calls=0)), seed, device)
        run.setup()
        run.release()
        return run.check()

    @staticmethod
    def reference_readings(cell, seed: int, device) -> List[tuple]:
        """(side, numbers) of the reference in the program's place: in
        float8 (the control), in bfloat16, and with each fault a train
        cell can have (the loss's mean over half the batch, the state
        left unchanged)."""
        cfg, arch = cell.config, cell.config["model"]
        w = weights.make(cfg, seed, device)
        t = cfg["train"]
        bs = cell.traffic.get("batch") or t["batch_size"]
        first = traffic.train_pool(cell.traffic, bs, t["steps_per_dispatch"],
                                   arch["num_classes"], seed, device)[0]
        n = cell.traffic["check_steps"]
        batches = [(first["image"][i], first["dims"][i], first["label"][i])
                   for i in range(n)]
        ref = reference.train_steps(cfg, w, batches, seed)
        out = []
        for side, kw in (("control_fp8", {"precision": "fp8"}),
                         ("bf16", {"precision": "bf16"}),
                         ("fault_half_batch", {"fault": "half_batch"}),
                         ("fault_unchanged", {"fault": "unchanged"})):
            rec = reference.train_steps(cfg, w, batches, seed, **kw)
            out.append((side, compare.train_numbers(rec, ref)))
        return out


Run = TrainCell
