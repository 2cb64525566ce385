"""In percent: the share of a step's wall time in which the device does
nothing. The busy time a step is the union of the device's busy
intervals in the capture over its steps; the step's wall time is the
traced run's window, which the profiler does not slow (the capture's own
wall time carries the profiler's host cost)."""
from bench import trace


def read(ctx):
    w = ctx.window
    if ctx.cap is None or not ctx.profile_steps or not w or not w["steps"]:
        return None
    busy = trace.busy_seconds(ctx.cap) / ctx.profile_steps
    return 100.0 * (1.0 - busy / (w["seconds"] / w["steps"]))
