"""Host milliseconds a split of the growers' loop: the program's ``grow``
span less what its host reads waited inside it (``wait_times`` of
``grow``, ``histogram``, ``split_find`` and ``partition``), over the
splits of the traced window's trees.  None where the program files no
``wait_times``."""

WAITS = ("grow", "histogram", "split_find", "partition")


def read(ctx):
    tel = getattr(ctx, "telemetry", None)
    trees = getattr(ctx, "trees", None)
    if not tel or not trees or "wait_times" not in tel:
        return None
    grow = tel["phase_times"].get("grow")
    splits = sum(t.num_leaves - 1 for t in trees)
    if not grow or splits <= 0:
        return None
    waits = sum(tel["wait_times"].get(k, 0.0) for k in WAITS)
    return (grow - waits) * 1e3 / splits
