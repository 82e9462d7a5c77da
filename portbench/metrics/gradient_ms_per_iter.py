"""Device milliseconds an iteration of the kernels launched inside the
program's ``gradient`` span (the objective)."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "iters", 0):
        return None
    s = ctx.trace.kernel_s_in("gradient")
    return s * 1e3 / ctx.iters if s else None
