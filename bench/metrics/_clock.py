"""Shared by the clock's readers: `ctx.clock` is the phase clock's reading
(`repro_torch.obs.tracing.ClockReading`) over the window's steps, or
absent or None where the run timed none (a `--trace 0` run, or a program
without the clock)."""


def reading(ctx):
    c = getattr(ctx, "clock", None)
    return c if c is not None and getattr(c, "n_steps", 0) else None


def ms_per_step(ctx, names):
    """The device milliseconds a step of the spans `names` together, or
    None where the clock timed none of them."""
    c = reading(ctx)
    if c is None:
        return None
    got = [v for v in (c.per_step(n) for n in names) if v is not None]
    return sum(got) if got else None
