"""Device time a step inside `repro.obs/apply` (the OMD update)."""
from bench.metrics._phase import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("apply",))
