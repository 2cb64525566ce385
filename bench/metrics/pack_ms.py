"""The clock's device milliseconds a step in `repro.obs/pack` and
`repro.obs/unpack`: the message and e1 packed into the buckets' flat
buffers, and q-hat and the new e1 unpacked into the leaves."""
from bench.metrics._clock import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("pack", "unpack"))
