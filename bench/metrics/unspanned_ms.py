"""Device time a step outside every `repro.obs/<phase>` range: the
extrapolation, the message, the schedule fold, the metrics."""
from bench.metrics._phase import ms_per_step


def read(ctx):
    return ms_per_step(ctx, (None,))
