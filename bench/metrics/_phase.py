"""Shared by the phase readers: device milliseconds a captured step."""
from bench import trace


def ms_per_step(ctx, phases):
    if ctx.cap is None or not ctx.profile_steps:
        return None
    by = trace.phase_seconds(ctx.cap)
    if not any(p in by for p in phases):
        return None
    return sum(by.get(p, 0.0) for p in phases) / ctx.profile_steps * 1e3
