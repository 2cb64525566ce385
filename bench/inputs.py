"""What a run hands to the program and to the reference alike, made from
`--seed` on the device: the weights (in a few large draws), the token
batches and the uniform draws of the checked steps."""
from __future__ import annotations

import math

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PIECE = 1 << 28     # elements a draw


def sub_seed(seed: int, k: int) -> int:
    """A seed of its own for stream k of a run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + k * 0xBF58476D1CE4E5B9) % (1 << 63)


def generator(seed: int, k: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, k))
    return g


def make_weights(spec, seed, device):
    """{path: tensor} of a reference's `spec` [(path, shape, dtype, init)]:
    the normal leaves of each dtype are views of one buffer filled by draws
    of PIECE elements, then scaled leaf by leaf; the small leaves of the
    other inits are drawn alone."""
    g = generator(seed, 1, device)
    out = {}
    by_dtype = {}
    for path, shape, dt, init in spec:
        if init[0] == "normal":
            by_dtype.setdefault(dt, []).append((path, shape, init[1]))
    for dt, leaves in sorted(by_dtype.items()):
        total = sum(math.prod(s) for _, s, _ in leaves)
        buf = torch.empty(total, dtype=DTYPES[dt], device=device)
        for a in range(0, total, PIECE):
            b = min(total, a + PIECE)
            buf[a:b] = torch.randn(b - a, generator=g, device=device,
                                   dtype=torch.float32)
        off = 0
        for path, shape, std in leaves:
            n = math.prod(shape)
            out[path] = buf[off:off + n].view(shape).mul_(std)
            off += n
    for path, shape, dt, init in spec:
        kind, dtype = init[0], DTYPES[dt]
        if kind == "normal":
            continue
        if kind == "ones":
            out[path] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            out[path] = torch.zeros(shape, dtype=dtype, device=device)
        elif kind == "log_uniform":
            u = torch.rand(shape, generator=g, device=device)
            out[path] = torch.log(init[1] + u * (init[2] - init[1])).to(dtype)
        elif kind == "dt_bias":
            u = torch.rand(shape, generator=g, device=device)
            lo, hi = math.log(init[1]), math.log(init[2])
            dt_ = torch.exp(lo + u * (hi - lo))
            out[path] = (dt_ + torch.log(-torch.expm1(-dt_))).to(dtype)
        else:
            raise ValueError(f"unknown init {init!r} of {path}")
    return out


def nest(flat):
    """The nested dict of a {path tuple: value} dict."""
    out = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def make_batches(n, batch, seq, vocab, seed, device):
    """n distinct token batches {"tokens", "targets"} (batch, seq) int64,
    uniform over the vocabulary, targets the next token, from one draw."""
    g = generator(seed, 2, device)
    x = torch.randint(0, vocab, (n, batch, seq + 1), generator=g,
                      device=device)
    return [{"tokens": x[i, :, :-1].contiguous(),
             "targets": x[i, :, 1:].contiguous()} for i in range(n)]


def make_draws(total, step, seed, device):
    """The checked step `step`'s uniform draws over the packed buffer of
    `total` elements, float32 in [0, 1)."""
    g = generator(seed, 100 + step, device)
    return torch.rand(total, generator=g, device=device, dtype=torch.float32)
