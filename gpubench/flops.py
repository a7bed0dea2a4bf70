"""The model's FLOPs an image, counted with ``torch.utils.flop_counter`` on
the reference network (convolutions and the classifier; a multiply-add
is two), forward alone and forward plus backward, on meta tensors. The
counts the metrics read are frozen in ``counts/<config>.json``; the
tests count them again.

One formula is replaced: torch's convolution backward counts a grouped
convolution's weight gradient as if the convolution were dense (its
``groups`` argument is unused), 32 times too many for ResNeXt's 3x3s.
Here each gradient a convolution's backward computes costs what its
forward does, which is torch's own count for every dense convolution.

    python -m gpubench.flops configs/resnet50_v1.json
"""

from __future__ import annotations

import json
import sys

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode, conv_flop_count

from gpubench.reference.model import Net, param_shapes


def conv_backward_flops(grad_out_shape, x_shape, w_shape, *args,
                        out_shape=None, **kwargs) -> int:
    """Each of the input and weight gradients the backward computes costs
    the forward's FLOPs."""
    transposed, output_mask = args[4], args[7]
    fwd = conv_flop_count(x_shape, w_shape, grad_out_shape, transposed)
    return fwd * (int(output_mask[0]) + int(output_mask[1]))


def model_flops(arch: dict, image: int = None,
                torch_formulas: bool = False) -> dict:
    """{"serve": forward FLOPs, "train": forward plus backward FLOPs} of
    one ``image`` x ``image`` image (default: the configuration's).
    ``torch_formulas``: torch's own formulas throughout."""
    custom = {} if torch_formulas else {
        torch.ops.aten.convolution_backward: conv_backward_flops}
    image = image or arch["image"]
    out = {}
    for mode in ("serve", "train"):
        p = {n: torch.zeros(s, device="meta") for n, s, _ in
             param_shapes(arch)}
        net = Net(arch, p, "ema" if mode == "train" else "eval")
        for n in net.trainable():
            p[n].requires_grad_(mode == "train")
        x = torch.zeros((1, image, image, 3), device="meta")
        with FlopCounterMode(display=False,
                             custom_mapping=custom) as counter:
            logits = net.forward(x)
            if mode == "train":
                loss = F.cross_entropy(logits, torch.zeros(
                    1, dtype=torch.long, device="meta"))
                torch.autograd.grad(loss, [p[n] for n in net.trainable()])
        out[mode] = int(counter.get_total_flops())
    return out


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        cfg = json.load(f)
    counts = model_flops(cfg["model"])
    print(json.dumps({"image": cfg["model"]["image"],
                      "serve_flops_per_image": counts["serve"],
                      "train_flops_per_image": counts["train"]}))
