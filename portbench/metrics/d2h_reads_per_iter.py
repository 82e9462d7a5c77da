"""Device-to-host copies in the traced window, per iteration: the host
reads that hold the training loop to the device."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "iters", 0):
        return None
    return ctx.trace.count("Memcpy DtoH") / ctx.iters
