"""Device time a step inside `repro.obs/compress` and `repro.obs/exchange`
(B1, the packing and unpacking of the buckets, the dequantization)."""
from bench.metrics._phase import ms_per_step


def read(ctx):
    return ms_per_step(ctx, ("compress", "exchange"))
