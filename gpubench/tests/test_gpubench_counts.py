"""The frozen FLOP counts equal torch.utils.flop_counter's on the
reference network, at the cells' shapes and scaled from a small size."""

from fractions import Fraction

import pytest

from gpubench import flops, spec

CONFIGS = ["resnet50_v1", "resnext50_32x4d"]


def stem_flops(arch, image):
    side = image // 2
    return 2 * side * side * arch["filters"][0] * 3 * 49


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_counts_are_counted_again(name):
    arch = spec.read_json("configs", name + ".json")["model"]
    counts = spec.read_json("counts", name + ".json")
    got = flops.model_flops(arch)
    assert got == {"serve": counts["serve_flops_per_image"],
                   "train": counts["train_flops_per_image"]}
    # each backward product costs its forward's; the stem's input has no
    # gradient
    assert got["train"] == 3 * got["serve"] - stem_flops(arch, 224)


def test_dense_network_counts_are_torchs_own():
    arch = spec.read_json("configs", "resnet50_v1.json")["model"]
    assert flops.model_flops(arch) == flops.model_flops(
        arch, torch_formulas=True)


@pytest.mark.parametrize("name", CONFIGS)
def test_counts_scale_from_a_small_size(name):
    arch = spec.read_json("configs", name + ".json")["model"]
    fc = 2 * arch["filters"][-1] * arch["num_classes"]
    small, big = flops.model_flops(arch, 64), flops.model_flops(arch, 224)
    scale = Fraction(224 * 224, 64 * 64)
    assert big["serve"] == scale * (small["serve"] - fc) + fc
    assert big["train"] == scale * (small["train"] - 3 * fc) + 3 * fc
