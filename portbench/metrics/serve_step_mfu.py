"""The whole serving step's share of the chip's peak: the least time of
the traced window's walks (cost.walk_bytes) over the window's seconds,
in %."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "walk_s", 0):
        return None
    return 100.0 * ctx.walk_s / ctx.window_s
