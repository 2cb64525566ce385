"""The device's idle a step inside the field: the clock's `repro.obs/field`
interval less `field_ms`, the device time of the field's work in the
capture. The two terms come from different steps (the window's and the
captured ones), so a field without idle may read a little below 0; the
difference is not clamped."""
from bench.metrics import field_ms
from bench.metrics._clock import ms_per_step


def read(ctx):
    interval = ms_per_step(ctx, ("field",))
    busy = field_ms.read(ctx)
    if interval is None or busy is None:
        return None
    return interval - busy
