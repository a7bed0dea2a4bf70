"""Device milliseconds a step of cuDNN's and cuBLAS's
kernels (convolutions and matrix products), in the traced window of a
train cell (``trace.kernel_class``)."""


def read(ctx):
    if ctx.kind != "train":
        return None
    seconds = ctx.window.seconds_by("class").get("library")
    if not seconds:
        return None
    return 1e3 * seconds / ctx.steps
