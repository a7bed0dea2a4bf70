"""The program's spans (``utils/profiler.py``) on the CPU.

A ResNet-50 and a grouped ResNeXt-50 train step at 32x32, two images:
without a profiler the span log stays empty and nothing changes; under a
CPU ``torch.profiler`` the chrome trace nests the spans, the numbers stay
bit for bit what they were, and the span machinery adds no op that moves
bytes. A serving artifact exported while a profiler records holds no
profiler node, and its callable's calls are ``serve.call`` spans. The
span log's bound and sums, and the benchmark's span readers
(``gpubench/metrics/``), on synthetic logs.
"""

import copy
import json
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpubench import spec
from resnet_tpu_torch.utils import profiler
from resnet_tpu_torch.utils.op_count import OpCounter

PRESETS = ("imagenet_resnet50", "imagenet_resnext50")


@pytest.fixture(autouse=True, scope="module")
def two_intra_op_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tiny(preset: str):
    from resnet_tpu_torch.config import PRESETS as ALL
    cfg = ALL[preset]()
    cfg.data.image_shape = (32, 32, 3)
    cfg.data.num_classes = 10
    cfg.train.batch_size = 2
    cfg.train.steps_per_dispatch = 1
    return cfg


def _batch():
    g = torch.Generator().manual_seed(0)
    return {"image": torch.randint(0, 256, (2, 36, 36, 3), dtype=torch.uint8,
                                   generator=g),
            "label": torch.tensor([1, 7]),
            "dims": torch.tensor([[36, 36, 0, 0], [30, 36, 3, 0]])}


def _step(cfg, model, profiled: bool, trace_path=None) -> dict:
    """One train step of a copy of ``model`` under an ``OpCounter``, with
    or without a CPU profiler: the logits, loss, gradients, parameters
    after the step, the counter and the spans the log holds after."""
    from resnet_tpu_torch.ops.augment_fused import make_augment_fn
    from resnet_tpu_torch.train.state import create_train_state
    from resnet_tpu_torch.train.steps import make_train_step
    state = create_train_state(cfg, device="cpu", model=copy.deepcopy(model))
    step = make_train_step(augment_fn=make_augment_fn(cfg))
    out: dict = {}
    state.model.register_forward_hook(
        lambda mod, args, logits: out.update(logits=logits.detach()))
    apply = state.apply_gradients
    state.apply_gradients = lambda grads: (
        out.update(grads=[g.clone() for g in grads]), apply(grads))[-1]
    profiler.SPANS.clear()
    with OpCounter() as counter:
        if profiled:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                state, metrics = step(state, _batch())
            prof.export_chrome_trace(str(trace_path))
        else:
            state, metrics = step(state, _batch())
    out.update(loss=metrics["loss_sum"], counter=counter,
               params=[p.detach().clone()
                       for p in state.model.parameters()],
               spans=list(profiler.SPANS.spans))
    profiler.SPANS.clear()
    return out


@pytest.fixture(scope="module", params=PRESETS)
def runs(request, tmp_path_factory):
    from resnet_tpu_torch.models.registry import get_model
    cfg = _tiny(request.param)
    model = get_model(cfg)
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    off = _step(cfg, model, profiled=False)
    on = _step(cfg, model, profiled=True, trace_path=path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return SimpleNamespace(preset=request.param, off=off, on=on,
                           annotations=events)


def _inside(inner, outer) -> bool:
    return (inner["tid"] == outer["tid"] and outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _named(events, name):
    return [e for e in events if e["name"] == name]


def test_no_profiler_no_span(runs):
    assert runs.off["spans"] == []
    assert not [e for e in runs.off["counter"].events
                if e.op.startswith("profiler.")]
    assert len(runs.off["counter"].events) > 1000


def test_the_trace_nests_the_spans(runs):
    ev = runs.annotations
    (call,) = _named(ev, "train.call")
    phases = {n: _named(ev, "train." + n) for n in
              ("augment", "forward", "backward", "optimizer", "metrics")}
    assert all(len(v) == 1 and _inside(v[0], call) for v in phases.values())
    forward, backward = phases["forward"][0], phases["backward"][0]
    bns, bwds = _named(ev, "bn"), _named(ev, "bn.backward")
    assert len(bns) == len(bwds) == 53
    assert all(_inside(e, forward) for e in bns)
    assert all(_inside(e, backward) for e in bwds)
    grouped = "resnext" in runs.preset
    for name, inside in (("grouped_weight", forward),
                         ("grouped_weight.backward", backward)):
        found = _named(ev, name)
        assert len(found) == (16 if grouped else 0)
        assert all(_inside(e, inside) for e in found)
    # the log holds what the trace does, with its nesting
    log = runs.on["spans"]
    assert sorted(s.name for s in log) == sorted(e["name"] for e in ev)
    by_index = {s.index: s for s in log}
    assert all(by_index[s.parent].name == "train.forward"
               for s in log if s.name == "bn" and s.parent is not None)


def test_the_profiler_changes_no_number(runs):
    off, on = runs.off, runs.on
    assert torch.equal(off["logits"], on["logits"])
    assert torch.equal(off["loss"], on["loss"])
    assert len(off["grads"]) == len(on["grads"]) > 100
    assert all(torch.equal(a, b) for a, b in zip(off["grads"], on["grads"]))
    assert all(torch.equal(a, b) for a, b in zip(off["params"],
                                                 on["params"]))


def test_the_spans_add_no_device_op(runs):
    moved = lambda c: [(e.op, e.bytes, e.flops) for e in c.device_ops()]
    assert moved(runs.off["counter"]) == moved(runs.on["counter"])
    added = {e.op for e in runs.on["counter"].events} - \
        {e.op for e in runs.off["counter"].events}
    assert added <= {"profiler._record_function_enter_new",
                     "profiler._record_function_exit"}


def test_remat_recomputation_is_bn_work():
    """Under remat every unit's BatchNorms run again in the backward; those
    ``bn`` spans sit inside ``train.backward``."""
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.models.resnet import BatchNorm
    cfg = _tiny("imagenet_resnet50")
    cfg.model.depth = 18
    cfg.train.remat = True
    profiler.SPANS.clear()
    model = get_model(cfg).train()
    x = torch.randn(2, 3, 32, 32).permute(0, 2, 3, 1)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span("train.backward"):
            loss = model(x).sum()
            torch.autograd.grad(loss, list(model.parameters()))
    names = [s.name for s in profiler.SPANS.spans]
    profiler.SPANS.clear()
    n_bn = sum(isinstance(m, BatchNorm) for m in model.modules())
    # every BatchNorm in the forward, those of the units (all but the
    # stem's) again in the backward
    assert names.count("bn") == n_bn + n_bn - 1
    assert names.count("bn.backward") == n_bn


def test_export_under_a_profiler_and_serve_call(tmp_path):
    from resnet_tpu_torch.config import cifar10_resnet18
    from resnet_tpu_torch.models.registry import get_model
    from resnet_tpu_torch.utils.serving import export_serving, load_serving
    cfg = cifar10_resnet18()
    cfg.model.depth = 8
    prefix = str(tmp_path / "a")
    profiler.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        export_serving(cfg, get_model(cfg), prefix, batch_size=2)
    assert profiler.SPANS.spans == []
    graph = torch.export.load(prefix + ".pt2").graph
    targets = [str(n.target) for n in graph.nodes]
    assert targets and not [t for t in targets if "profiler" in t]
    serve, _ = load_serving(prefix, device="cpu")
    images = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    plain = serve(images)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = [serve(images) for _ in range(3)]
    assert all(torch.equal(plain, t) for t in traced)
    assert [s.name for s in profiler.SPANS.spans] == ["serve.call"] * 3
    assert len(profiler.SPANS.host_ms("serve.call")) == 3
    assert profiler.SPANS.device_ms("serve.call") is None      # no card
    assert "serve.call" in {e.name for e in prof.events()}
    profiler.SPANS.clear()


def test_spanned_fetches_each_item_in_a_span():
    profiler.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        got = list(profiler.spanned("train.input_wait", iter("abc")))
    assert got == ["a", "b", "c"]
    # three fetches and the one that ends the iterator
    assert profiler.SPANS.summary()["train.input_wait"]["count"] == 4
    profiler.SPANS.clear()
    assert list(profiler.spanned("train.input_wait", "ab")) == ["a", "b"]
    assert profiler.SPANS.spans == []


def test_a_backward_span_closes_with_its_own_input_gradient():
    """Another reader of the region's input, made before the region, runs
    its backward after the region's: ``bn.backward`` closes first, and the
    gradient passes unchanged."""
    x = torch.randn(4, requires_grad=True)
    h = x * 1
    other = h * 5
    stamps = []
    other.register_hook(lambda g: stamps.append(time.perf_counter()))
    profiler.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        out = profiler.region("bn", lambda t: t * 3, h)
        (grad,) = torch.autograd.grad(out.sum() + other.sum(), x)
    (span,) = [s for s in profiler.SPANS.spans if s.name == "bn.backward"]
    profiler.SPANS.clear()
    assert torch.equal(grad, torch.full((4,), 8.0))
    assert span.host_end is not None and span.host_end < stamps[0]


def test_the_log_is_bounded():
    log = profiler.SpanLog(limit=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            log.close(log.open("bn"))
    assert len(log.spans) == 3 and log.past["bn"][0] == 2
    summary = log.summary()["bn"]
    assert summary["count"] == 5 and summary["host_ms"] >= 0
    assert summary["device_ms"] is None


def test_closing_a_span_closes_what_opened_inside_it():
    log = profiler.SpanLog()
    with profile(activities=[ProfilerActivity.CPU]):
        outer = log.open("train.backward")
        inner = log.open("bn.backward")
        log.close(outer)
        log.close(inner)                 # already closed: nothing happens
    assert inner.host_end is not None and inner.host_end <= outer.host_end
    assert [s.parent for s in log.spans] == [None, 0]


class _Event:
    def __init__(self, ms):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def _fake_log(entries):
    """A span log of (name, parent index, host ms, device ms) entries."""
    log = profiler.SpanLog()
    for i, (name, parent, host, dev) in enumerate(entries):
        s = profiler.Span.__new__(profiler.Span)
        s.name, s.parent, s.index = name, parent, i
        s.host_start, s.host_end = 0.0, host / 1e3
        s.events = None if dev is None else (_Event(0.0), _Event(dev))
        log.spans.append(s)
    return log


def test_device_ms_counts_a_nested_span_once():
    log = _fake_log([("train.backward", None, 9.0, 50.0),
                     ("bn.backward", 0, 1.0, 4.0),
                     ("bn", 1, 1.0, 3.0),          # recomputed inside
                     ("bn", None, 1.0, 2.0)])
    assert log.device_ms("bn", "bn.backward") == pytest.approx(6.0)
    assert log.device_ms("bn") == pytest.approx(5.0)
    assert log.device_ms("train.optimizer") is None
    assert _fake_log([("bn", None, 1.0, None)]).device_ms("bn") is None


STEP_LOG = [("train.call", None, 30.0, 400.0),
            ("train.optimizer", 0, 2.0, 3.0),
            ("bn", 0, 0.1, 10.0), ("bn.backward", 0, 0.1, 14.0),
            ("grouped_weight", 0, 0.1, 0.25),
            ("grouped_weight.backward", 0, 0.1, 0.5),
            ("train.optimizer", 0, 2.0, 5.0)]
SERVE_LOG = [("serve.call", None, ms, None) for ms in (3.0, 9.0, 4.0)]


@pytest.mark.parametrize("metric,kind,log,want", [
    ("bn_ms.train", "train", STEP_LOG, 12.0),
    ("optimizer_ms.train", "train", STEP_LOG, 4.0),
    ("grouped_weight_ms.train", "train", STEP_LOG, 0.375),
    ("enqueue_ms.serve", "serve", SERVE_LOG, 3.0)])
def test_span_readers(metric, kind, log, want, monkeypatch):
    read = spec.reader(metric)
    ctx = SimpleNamespace(kind=kind, steps=2, batches=3)
    monkeypatch.setattr(profiler, "SPANS", _fake_log(log))
    assert read(ctx) == pytest.approx(want)
    other = "serve" if kind == "train" else "train"
    assert read(SimpleNamespace(kind=other, steps=2, batches=3)) is None
    monkeypatch.setattr(profiler, "SPANS", profiler.SpanLog())
    assert read(ctx) is None
