"""The clock's device milliseconds a step in `repro.obs/carry`: the cast
of prev_grad, the step's loss and norms and its telemetry."""
from bench.metrics._clock import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("carry",))
