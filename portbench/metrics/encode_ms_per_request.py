"""Host milliseconds of the engine's ``predict_encode`` span (the rank
encode of the rows; host work, so its timer is sound) per request of
the traced window."""


def read(ctx):
    tel = getattr(ctx, "telemetry", None)
    if not tel or not getattr(ctx, "requests", 0):
        return None
    s = tel["phase_times"].get("predict_encode")
    return s * 1e3 / ctx.requests if s else None
