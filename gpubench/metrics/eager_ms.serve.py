"""Device milliseconds a batch of PyTorch's own kernels
(elementwise, reductions, copies, pooling, the optimizer's foreach
kernels): every kernel outside the library's and the program's
hand-written ones, in the traced window of a
serve cell (``trace.kernel_class``)."""


def read(ctx):
    if ctx.kind != "serve":
        return None
    seconds = ctx.window.seconds_by("class").get("eager")
    if not seconds:
        return None
    return 1e3 * seconds / ctx.batches
