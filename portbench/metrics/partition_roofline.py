"""Least time of the row partitions the traced window's trees needed
(each split's parent segment; cost.tree_work) over the device time of
the partition kernels (``partition_count``, ``partition_move``), in %."""


def read(ctx):
    if getattr(ctx, "trace", None) is None or not getattr(ctx, "work", None):
        return None
    dev = ctx.trace.kernel_s_named("partition_count", "partition_move")
    if dev <= 0 or ctx.work["partition_s"] <= 0:
        return None
    return 100.0 * ctx.work["partition_s"] / dev
