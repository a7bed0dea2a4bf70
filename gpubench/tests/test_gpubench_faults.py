"""The timed path broken underneath, the harness's look for a card
skipped: each fault a cell can have comes out ``correct`` false. On the
CPU at a small size (a BatchNorm of few images makes the sound run's own
gaps larger there; each fault reads well above them)."""

import time

import pytest
import torch

from gpubench import run
from gpubench.tests.small import small_cell

SEED = 2 ** 31 + 99


@pytest.fixture(autouse=True)
def few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(prev)


def numbers(cell):
    out = run.run_cell(cell, SEED, 0.2, False, "cpu", time.perf_counter())
    return out["correct"], out["numbers"]


@pytest.fixture(scope="module")
def sound():
    return numbers(small_cell("resnet50-bnema-train"))[1]


def test_a_step_that_leaves_the_state_unchanged(monkeypatch, sound):
    from resnet_tpu_torch.train.state import TrainState

    def unchanged(self, grads):
        self.step += 1
    monkeypatch.setattr(TrainState, "apply_gradients", unchanged)
    ok, got = numbers(small_cell("resnet50-bnema-train"))
    assert not ok
    assert got["change_gap"] == pytest.approx(1.0)
    assert got["change_gap"] > 3 * sound["change_gap"]


def test_half_the_batch_left_out(monkeypatch, sound):
    import resnet_tpu_torch.train.steps as steps
    full = steps.cross_entropy_loss

    def half(logits, labels, *args, **kwargs):
        n = logits.shape[0] // 2
        return full(logits[:n], labels[:n], *args, **kwargs)
    monkeypatch.setattr(steps, "cross_entropy_loss", half)
    ok, got = numbers(small_cell("resnet50-bnema-train"))
    assert not ok
    assert got["grad_gap"] > 2 * sound["grad_gap"]
    assert got["loss_gap"] > 2 * sound["loss_gap"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    from resnet_tpu_torch.utils import serving
    load = serving.load_serving

    def crossed(*args, **kwargs):
        serve, manifest = load(*args, **kwargs)

        def fn(images):
            out = serve(images).clone()
            out[[0, 1]] = out[[1, 0]]
            return out
        return fn, manifest
    cell = small_cell("resnet50-serve-bs256", image=64, batch=32)
    ok, sound_numbers = numbers(cell)
    monkeypatch.setattr(serving, "load_serving", crossed)
    bad, got = numbers(cell)
    assert not bad
    assert got["logit_gap"] > 3 * sound_numbers["logit_gap"]
