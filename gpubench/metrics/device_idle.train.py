"""Share of the traced window of a train cell in which nothing ran on the
card: no kernel, copy or fill (``trace.Window``'s busy union)."""


def read(ctx):
    if ctx.kind != "train" or ctx.window.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.window.busy_s / ctx.window.window_s)
