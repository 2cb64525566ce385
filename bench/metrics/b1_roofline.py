"""In percent: B1's least time (`bench/roofline/b1_bytes.py` over the
gradient's elements, at the HBM peak) over its mean device time in the
capture."""
from bench import trace
from bench.roofline import b1_bytes


def read(ctx):
    if ctx.cap is None:
        return None
    times = trace.kernel_seconds(ctx.cap, "quantize_ef")
    if not times:
        return None
    least = b1_bytes.least_seconds(ctx.n_params, ctx.peaks)
    return 100.0 * least / (sum(times) / len(times))
