"""The clock's device milliseconds a step in `repro.obs/lookahead`: the
OMD extrapolation to w_{t-1/2} over the bf16 parameters and float32 EF."""
from bench.metrics._clock import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("lookahead",))
