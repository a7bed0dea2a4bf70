"""The control: the reference put in the program's place with its
convolutions in float8. It has to come out not correct against the
cell's limits. On the CPU at a small size, and on the card at the cell's
own size on three seeds (``-m cuda``)."""

import pytest
import torch

from gpubench import compare, spec
from gpubench.tests.small import small_cell

TRAIN = ["resnet50-bnema-train", "resnext50-train"]
SERVE = ["resnet50-serve-bs256", "resnext50-serve-bs256"]


def control_fails(cell, seed, device):
    sides = dict(spec.kind(cell.kind).reference_readings(cell, seed, device))
    return not compare.judge(sides["control_fp8"], cell.limits)[0]


@pytest.mark.parametrize("name", ["resnet50-bnema-train",
                                  "resnet50-serve-bs256"])
def test_control_fails_on_the_cpu(name):
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cell = small_cell(name, image=64, batch=8 if "train" in name else 32)
        assert control_fails(cell, 3, "cpu")
    finally:
        torch.set_num_threads(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("name", TRAIN + SERVE)
def test_control_fails_on_the_card_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = spec.cell(name)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        assert control_fails(cell, seed, "cuda")
