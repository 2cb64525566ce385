"""Device bytes the operators of `repro.obs/compress` and
`repro.obs/exchange` allocate a step, each operator's own allocations net
of its own frees where positive (the program's `phase_costs` count), in
GiB, from one step captured with memory events."""


def read(ctx):
    """`ctx.alloc`: {phase: bytes} of one step captured with memory
    events."""
    if not ctx.alloc:
        return None
    got = [ctx.alloc[p] for p in ("compress", "exchange") if p in ctx.alloc]
    if not got:
        return None
    return sum(got) / 2 ** 30
