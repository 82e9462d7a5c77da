"""Share of the traced training window in which no device operation
ran (1 - the union of their intervals over the window), in %."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "iters", 0):
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.window_s) if busy > 0 else None
