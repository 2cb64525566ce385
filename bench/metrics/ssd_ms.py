"""Device time a step of the SSD's CUDA kernel set (`ssd_chunked.cu`,
every kernel named `ssd_chunk_*`): the chunked SSD's forward, its
recomputation under remat and its backward, in all layers. None where
the capture holds no such kernel (a program whose SSD is not that set)."""
from bench import trace

PREFIX = "ssd_chunk_"


def read(ctx):
    if ctx.cap is None or not ctx.profile_steps:
        return None
    times = trace.kernel_seconds(ctx.cap, PREFIX)
    if not times:
        return None
    return sum(times) / ctx.profile_steps * 1e3
