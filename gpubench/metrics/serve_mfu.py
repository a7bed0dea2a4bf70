"""The whole batch's share of the card's bf16 peak: the model's FLOPs an
image (forward, ``counts/<config>.json``) times the images of the
traced window, over the window's seconds, against ``peaks.json``."""


def read(ctx):
    if ctx.kind != "serve" or not ctx.images:
        return None
    flops = ctx.counts["serve_flops_per_image"] * ctx.images
    return 100.0 * flops / ctx.window.window_s \
        / ctx.peaks["bf16_flops_per_s"]
