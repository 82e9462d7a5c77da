"""Share of the traced serving window in which no device operation ran,
in %."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "requests", 0):
        return None
    busy = ctx.trace.busy_s()
    return 100.0 * (1.0 - busy / ctx.window_s) if busy > 0 else None
