"""Loss and metric sums (ref: mx.metric Accuracy, TopKAccuracy(5),
CrossEntropy), port of ``resnet_tpu/ops/metrics.py``.

Each step returns sums (top-1 and top-5 hits, loss times count, count) as
device tensors; the host divides at log time, as ``mx.metric`` does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       label_smooth: float = 0.0,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean softmax cross-entropy in float32; ``mask`` (N,) excludes
    padding examples from the mean."""
    logits = logits.float()
    num_classes = logits.shape[-1]
    logp = logits - logits.amax(dim=-1, keepdim=True)
    logp = logp - torch.log(torch.exp(logp).sum(dim=-1, keepdim=True))
    picked = torch.gather(logp, -1, labels.long()[:, None])[:, 0]
    if label_smooth > 0.0:
        on = 1.0 - label_smooth
        off = label_smooth / (num_classes - 1)
        nll = -(on * picked + off * (logp.sum(dim=-1) - picked))
    else:
        nll = -picked
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def metric_sums(logits: torch.Tensor, labels: torch.Tensor,
                loss: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
    """Per-batch sums: top-1 hits, top-5 hits, loss·n, n. Top-5 counts the
    classes strictly above the label's logit (ties resolved in the label's
    favour)."""
    logits = logits.float()
    labels = labels.long()
    if mask is None:
        mask = torch.ones(labels.shape[0], device=logits.device)
    mask = mask.float()
    top1_hit = (logits.argmax(dim=-1) == labels).float()
    label_logit = torch.gather(logits, -1, labels[:, None])
    rank = (logits > label_logit).sum(dim=-1)
    top5_hit = (rank < 5).float()
    n = mask.sum()
    return {
        "top1_sum": (top1_hit * mask).sum(),
        "top5_sum": (top5_hit * mask).sum(),
        "loss_sum": loss.float() * n,
        "count": n,
    }


class MetricAccumulator:
    """Host-side accumulator with mx.metric reset/get semantics."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._sums = {"top1_sum": 0.0, "top5_sum": 0.0, "loss_sum": 0.0,
                      "count": 0.0}

    def update(self, sums: Dict[str, torch.Tensor]):
        for k in self._sums:
            self._sums[k] += float(sums[k])

    def get(self) -> Dict[str, float]:
        n = max(self._sums["count"], 1.0)
        return {
            "accuracy": self._sums["top1_sum"] / n,
            "top_k_accuracy_5": self._sums["top5_sum"] / n,
            "cross-entropy": self._sums["loss_sum"] / n,
        }
