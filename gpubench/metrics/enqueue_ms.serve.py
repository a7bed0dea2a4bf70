"""Host milliseconds of one call of the serving callable, from its entry to
its return, before the caller's synchronize: the least over the traced
window's batches of a serve cell of the program's ``serve.call`` span
(``resnet_tpu_torch/utils/profiler.py``, ``SPANS``).

The least, not the median: the traced window calls back to back and
synchronizes only at its end, so once the card's launch queue is full a
call's host time is its wait for the card (the median reads the device
time a batch). The least is the call that waited least, the nearest to
an enqueue on an empty queue, and an upper bound on it. A program
without spans reports nothing."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.batches:
        return None
    try:
        from resnet_tpu_torch.utils.profiler import SPANS
    except ImportError:
        return None
    host = SPANS.host_ms("serve.call")
    return min(host) if host else None
