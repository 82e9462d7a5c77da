"""Host milliseconds an iteration that the program's reads of device
results blocked (``telemetry.host_read``: the sum of its ``wait_times``)
in the traced window.  None where the program files no ``wait_times``."""


def read(ctx):
    tel = getattr(ctx, "telemetry", None)
    if not tel or not getattr(ctx, "iters", 0) or "wait_times" not in tel:
        return None
    waits = tel["wait_times"]
    return sum(waits.values()) * 1e3 / ctx.iters if waits else None
