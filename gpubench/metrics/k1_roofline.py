"""K1's share of its roofline: the least time the augmentation needs,
over K1's summed kernel time in the traced window.

The least time of a launch is the larger of its bytes at the HBM rate
and its float32 operations at the float32 rate (``peaks.json``). Bytes:
the canvas pixels whose rows and columns the step's crops touch, read
once, each image's 12 float32 values and the output written once.
Operations: ``counts/k1_augment.json`` a pixel, a row and a column of
the output, and a vertical tap of each touched column. The crops are
worked out again from the run's seed, so the count is what these inputs
need, whatever implements the augmentation."""

from gpubench.reference.augment import draws, touched

KERNEL = "fused_crop_mirror_normalize_kernel"


def read(ctx):
    if ctx.kind != "train" or not ctx.launches:
        return None
    kernel_s = ctx.window.seconds_by("group").get(KERNEL)
    if not kernel_s:
        return None
    data, model = ctx.config["data"], ctx.config["model"]
    out = model["image"]
    side = ctx.traffic["canvas"]
    out_bytes = 2 if ctx.config["train"]["dtype"] == "bfloat16" else 4
    k = ctx.k1
    per_pixel = sum(k["operations_per_output_pixel"].values())
    least = 0.0
    for step, dims in ctx.launches:
        d = draws(ctx.seed, step, dims, data)
        y0, x0, ch, cw = d["boxes"]
        rows = touched(y0, ch, d["valid"][0], out, side)
        cols = touched(x0, cw, d["valid"][1], out, side)
        n = dims.shape[0]
        moved = (int((rows * cols).sum()) * 3 + n * 12 * 4
                 + n * out * out * 3 * out_bytes)
        ops = (n * (out * out * per_pixel
                    + out * k["operations_per_output_row"]
                    + out * k["operations_per_output_column"])
               + out * k["operations_per_vertical_tap"] * int(cols.sum()))
        least += max(moved / ctx.peaks["hbm_bytes_per_s"],
                     ops / ctx.peaks["fp32_flops_per_s"])
    return 100.0 * least / kernel_s
