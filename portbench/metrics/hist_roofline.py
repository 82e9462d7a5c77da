"""Least time of the histograms the traced window's trees needed (the
root, then each split's smaller child; cost.tree_work) over the device
time of the histogram kernels (``hist_kernel``, ``fixed_to_f32``), in %."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "work", None):
        return None
    dev = ctx.trace.kernel_s_named("hist_kernel", "fixed_to_f32")
    if dev <= 0 or ctx.work["hist_s"] <= 0:
        return None
    return 100.0 * ctx.work["hist_s"] / dev
