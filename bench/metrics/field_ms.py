"""Device time a step inside `repro.obs/field`, the backward included."""
from bench.metrics._phase import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("field",))
