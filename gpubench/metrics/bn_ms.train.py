"""Device milliseconds a step inside the program's ``bn`` and
``bn.backward`` spans: every BatchNorm forward (a rematerialized unit's
recomputation included) and its backward, from the CUDA event pairs of
the program's span log (``resnet_tpu_torch/utils/profiler.py``,
``SPANS``) over the traced window of a train cell. A program without
spans reports nothing."""


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    try:
        from resnet_tpu_torch.utils.profiler import SPANS
    except ImportError:
        return None
    ms = SPANS.device_ms("bn", "bn.backward")
    return None if ms is None else ms / ctx.steps
