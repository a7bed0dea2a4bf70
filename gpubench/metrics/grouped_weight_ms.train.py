"""Device milliseconds a step inside the program's ``grouped_weight`` and
``grouped_weight.backward`` spans: ResNeXt's block-diagonal weight,
built from the grouped kernel in every forward, and its backward, from
the CUDA event pairs of the program's span log
(``resnet_tpu_torch/utils/profiler.py``, ``SPANS``) over the traced
window of a train cell. A model without grouped convolutions, or a
program without spans, reports nothing."""


def read(ctx):
    if ctx.kind != "train" or not ctx.steps:
        return None
    try:
        from resnet_tpu_torch.utils.profiler import SPANS
    except ImportError:
        return None
    ms = SPANS.device_ms("grouped_weight", "grouped_weight.backward")
    return None if ms is None else ms / ctx.steps
