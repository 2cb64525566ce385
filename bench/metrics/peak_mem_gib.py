"""`torch.cuda.max_memory_allocated()` over the window (reset when it
starts, read when it ends), in GiB; the largest over the ranks."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30 if ctx.peak_bytes else None
