"""The reference's training steps and served forward, float32 with TF32
off, on whatever device the tensors are on.

``train_steps`` follows a run's first steps: the augmentation of each
step's batch from the run's seed, the bn-ema forward, the mean softmax
cross-entropy, its gradient, and MXNet's SGD with the radial projection
(each conv gradient made orthogonal to its output filter, then
``mom = m * mom - lr * (g + wd * w)``, ``w += mom``). It records what the
comparison reads: each step's augmented batch and loss, the first step's
logits, the gradient the first update applied, and the parameters and
running statistics before the first step and after the last.

``precision="fp8"`` is the control: every convolution's and the
classifier's operands rounded to float8 (``fp8_round``); ``"bf16"``
rounds them to bfloat16 instead. ``fault`` plants one of the faults the
comparison has to catch, in the reference put in the program's place:
``"half_batch"`` takes the loss's mean over the first half of each batch
only, ``"unchanged"`` returns the state without an update.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from gpubench.reference.augment import augment, draws, normalize
from gpubench.reference.model import Net, bf16_round, fp8_round, param_shapes

FAULTS = ("half_batch", "unchanged")
ROUNDING = {"float32": None, "bf16": bf16_round, "fp8": fp8_round}


@contextlib.contextmanager
def full_float32():
    """TF32 off, and cuDNN's heuristics instead of its timing runs (the
    reference runs each shape a few times only)."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.benchmark) = prev


def _cpu(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().float().cpu().clone() for n, t in tensors.items()}


def train_steps(cfg: dict, weights: Dict[str, torch.Tensor],
                batches: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]],
                seed: int, precision: str = "float32",
                fault: Optional[str] = None) -> dict:
    """Run ``len(batches)`` steps from ``weights`` (copied, not changed);
    each batch is (uint8 canvases, dims, labels) on the device."""
    if fault not in (None,) + FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    arch, hyper, data = cfg["model"], cfg["train"], cfg["data"]
    if not hyper["bn_ema"]:
        raise ValueError("the reference trains BatchNorm in its bn-ema form "
                         "only; a configuration with bn_ema false needs "
                         "plain batch-statistics training here first")
    out_hw = (arch["image"], arch["image"])
    quant = ROUNDING[precision]
    p = {n: t.detach().clone().float() for n, t in weights.items()}
    net = Net(arch, p, "ema", quant)
    names = net.trainable()
    buffers = [n for n, _, kind in param_shapes(arch)
               if kind in ("bn_mean", "bn_var")]
    for n in names:
        p[n].requires_grad_(True)
    mom = {n: torch.zeros_like(p[n]) for n in names}
    rec = {"w0": _cpu({n: p[n] for n in names}),
           "b0": _cpu({n: p[n] for n in buffers}),
           "aug": [], "loss": []}
    lr, m, wd = hyper["lr"], hyper["mom"], hyper["wd"]
    with full_float32():
        for step, (canvas, dims, labels) in enumerate(batches):
            x = augment(canvas, draws(seed, step, dims, data), out_hw, data)
            if quant is not None:
                x = quant(x)
            rec["aug"].append(x.detach().cpu())
            logits = net.forward(x)
            keep = slice(0, labels.shape[0] // 2) if fault == "half_batch" \
                else slice(None)
            loss = F.cross_entropy(logits[keep], labels[keep].long())
            grads = torch.autograd.grad(loss, [p[n] for n in names])
            rec["loss"].append(float(loss.detach()))
            if step == 0:
                rec["logits0"] = logits.detach().cpu()
            if fault == "unchanged":
                if step == 0:
                    rec["g1"] = _cpu({n: torch.zeros_like(p[n])
                                      for n in names})
                continue
            with torch.no_grad():
                applied = {}
                for n, g in zip(names, grads):
                    w = p[n]
                    if g.ndim == 4 and hyper["radial_projection"]:
                        num = (g * w).sum(dim=(1, 2, 3), keepdim=True)
                        den = (w * w).sum(dim=(1, 2, 3), keepdim=True)
                        g = g - w * (num / den.clamp_min(1e-12))
                    applied[n] = g
                    mom[n].mul_(m).sub_(lr * (g + wd * w))
                    w.add_(mom[n])
                if step == 0:
                    rec["g1"] = _cpu(applied)
    rec["w3"] = _cpu({n: p[n] for n in names})
    rec["b3"] = _cpu({n: p[n] for n in buffers})
    return rec


@torch.no_grad()
def serve_logits(cfg: dict, weights: Dict[str, torch.Tensor],
                 images_u8: torch.Tensor, precision: str = "float32",
                 block: int = 64) -> torch.Tensor:
    """float32 logits of the eval forward (running statistics) over uint8
    NHWC images, in blocks of ``block`` rows; on the CPU."""
    quant = ROUNDING[precision]
    net = Net(cfg["model"], dict(weights), "eval", quant)
    out: List[torch.Tensor] = []
    with full_float32():
        for rows in images_u8.split(block):
            x = normalize(rows, cfg["data"])
            if quant is not None:
                x = quant(x)
            out.append(net.forward(x).cpu())
    return torch.cat(out)


@torch.no_grad()
def calibrate(cfg: dict, weights: Dict[str, torch.Tensor],
              images_u8: torch.Tensor) -> None:
    """Set every running statistic in ``weights`` to the statistics of a
    batch-statistics forward over ``images_u8``, in place."""
    net = Net(cfg["model"], weights, "batch")
    with full_float32():
        net.forward(normalize(images_u8, cfg["data"]))
