"""The wall time a step in which the device runs none of the step's
phases: the window's wall over its steps less the union, a step, of the
top-level spans' device intervals on the clock (the host's work between
the phases, and between the steps, while the device waits)."""
from bench.metrics._clock import reading


def read(ctx):
    c, w = reading(ctx), ctx.window
    if c is None or not w or not w["steps"]:
        return None
    return c.host_gap_ms(w["seconds"] * 1e3, w["steps"])
