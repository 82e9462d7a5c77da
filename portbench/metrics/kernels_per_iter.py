"""CUDA kernels the device ran in the traced window, per iteration."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "iters", 0):
        return None
    n = ctx.trace.count()
    return n / ctx.iters if n else None
