"""The whole iteration's share of the chip's peak: the least time of the
traced window's histograms, partitions, gradients and score updates
(cost.py) over the window's seconds, in %."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "work", None):
        return None
    least = sum(ctx.work.values())
    return 100.0 * least / ctx.window_s if least > 0 else None
