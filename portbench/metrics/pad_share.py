"""Padding rows over all rows the engine walked in the traced window
(route counters ``serve/pad_rows`` and ``serve/rows``), in %."""


def read(ctx):
    tel = getattr(ctx, "telemetry", None)
    if not tel:
        return None
    c = tel["counters"]
    rows, pad = c.get("serve/rows", 0), c.get("serve/pad_rows", 0)
    return 100.0 * pad / (rows + pad) if rows else None
