"""Device milliseconds an iteration of the kernels launched inside the
program's ``split_find`` spans (the split search)."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "iters", 0):
        return None
    s = ctx.trace.kernel_s_in("split_find")
    return s * 1e3 / ctx.iters if s else None
