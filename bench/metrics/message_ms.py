"""The clock's device milliseconds a step in `repro.obs/message`: the
gradients' stack, the float32 message eta * g and the schedule's fold."""
from bench.metrics._clock import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("message",))
