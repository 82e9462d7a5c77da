"""Least time of the walks of the traced window (codes, node tables and
scores each counted once; cost.walk_bytes) over the device time of the
kernels launched inside the engine's ``predict`` span, in %.  Where the
profiler records no ranges of the front's worker thread, every kernel of
the window counts: in a serving window the worker alone launches device
work, all of it inside ``predict`` (warm-up ends in set-up)."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "walk_s", 0):
        return None
    dev = ctx.trace.kernel_s_in("predict")
    if dev is None:
        dev = ctx.trace.kernel_s_named("")
    return 100.0 * ctx.walk_s / dev if dev else None
