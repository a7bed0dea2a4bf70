"""The numbers that decide ``correct``, each against its limit.

A training record (the program's, taken by ``train_cell``, or the
reference's, from ``reference.steps.train_steps``) holds CPU tensors:
``aug`` (each compared step's augmented batch), ``loss`` (their losses),
``logits0`` (the first step's logits), ``w0``/``w3`` (the trainable
tensors before the first compared step and after the last), ``b0``/``b3``
(the running statistics likewise) and ``g1`` (the gradient the first
update applied, after the radial projection).

Norm gaps are taken leaf by leaf: ``| |p| - |r| |`` over the larger of
``|r|`` and the median leaf's ``|r|``, and the worst leaf is the number.
A leaf whose reference gradient is under a thousandth of the median
leaf's moves by round-off alone under the update; it is left out of the
gradient and change gaps by that rule, not by name.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, List, Optional, Tuple

import torch

NEGLIGIBLE_GRAD = 1e-3


def _norms(tensors: Dict[str, torch.Tensor], names) -> Dict[str, float]:
    return {n: float(tensors[n].double().norm()) for n in names}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: Iterable[str]) -> Dict[str, float]:
    """Each leaf's ``| |p| - |r| |`` over the larger of its ``|r|`` and the
    median leaf's."""
    names = list(names)
    rn, pn = _norms(ref, names), _norms(prog, names)
    floor = statistics.median(rn.values())
    return {n: abs(pn[n] - rn[n]) / max(rn[n], floor, 1e-30) for n in names}


def moving_leaves(ref_g1: Dict[str, torch.Tensor]) -> List[str]:
    norms = _norms(ref_g1, ref_g1)
    floor = statistics.median(norms.values()) * NEGLIGIBLE_GRAD
    return [n for n, v in norms.items() if v >= floor]


def _diff(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor]):
    return {n: a[n].double() - b[n].double() for n in a}


def _as_ref_layout(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The reference's standard-layout batch in the program's layout (the
    2x2-block layout of an s2d augmenter)."""
    from gpubench.reference.augment import space_to_depth
    if prog.shape != ref.shape and prog.shape[-1] == 4 * ref.shape[-1]:
        return space_to_depth(ref)
    return ref


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """Every number a training record can be held to: the worst leaf's
    gap (``*_gap``) and the median leaf's (``*_median``)."""
    aug = max(rms_gap(p, _as_ref_layout(p, r))
              for p, r in zip(prog["aug"], ref["aug"]))
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    moving = moving_leaves(ref["g1"])
    out = {"aug_rms": aug, "loss_gap": loss,
           "logit_gap": logit_gap(prog["logits0"], ref["logits0"]),
           "logit_rms": rms_gap(prog["logits0"], ref["logits0"])}
    leaves = {"moving": len(moving), "all": len(ref["g1"])}
    for name, p, r, names in (
            ("grad", prog["g1"], ref["g1"], moving),
            ("change", _diff(prog["w3"], prog["w0"]),
             _diff(ref["w3"], ref["w0"]), moving),
            ("stats", _diff(prog["b3"], prog["b0"]),
             _diff(ref["b3"], ref["b0"]), list(ref["b3"]))):
        gaps = leaf_gaps(p, r, names)
        worst = max(gaps, key=gaps.get)
        out[name + "_gap"] = gaps[worst]
        out[name + "_median"] = statistics.median(gaps.values())
        leaves[name + "_gap"] = worst
    out["_leaves"] = leaves
    return out


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """Largest logit error of a batch over its reference logits' RMS."""
    ref = ref.double()
    return float((prog.double() - ref).abs().max() / ref.pow(2).mean().sqrt())


def rms_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """RMS error over the reference's RMS."""
    ref = ref.double()
    return float((prog.double() - ref).pow(2).mean().sqrt()
                 / ref.pow(2).mean().sqrt())


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[str]]:
    """(every number finite and within its limit, one line a number)."""
    ok, lines = True, []
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        lines.append(f"check {name} {value!r} limit {limit!r} "
                     f"{'ok' if good else 'FAIL'}")
    return ok, lines


def check_entry(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, Dict[str, Optional[float]]]:
    return {n: {"value": numbers.get(n), "limit": lim}
            for n, lim in limits.items()}
