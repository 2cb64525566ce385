"""Error feedback (paper Algorithm 2, lines 6–8; Lemma 1).

Counterpart of `repro.core.error_feedback`. The worker sends Q(m) with
m = message + e_prev and keeps e_new = m − Q(m). For the block-1024 linf
quantizers over a flat bucket, the EF add, scale, stochastic round and
residual run in one pass of the fused kernel (`kernels.quantize`): B1 for
a registry compressor, B2 for a `TracedQuant`, whose level count is a
device tensor. `compress_with_ef_stacked` does the same for a stack of
workers' messages, with one kernel launch over all of their rows;
`packed_levels` says when one launch over a step's comm buckets packed
back to back is exact.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import quantize_ef_flat

from . import compressors as C

FUSED_BLOCK = 1024  # kernel row width; must match kernels.quantize tiling


def fused_compatible(compressor, message) -> bool:
    """True when the fused quantize+EF kernel realizes exactly this
    compressor on this operand: linf quantization with one scale per
    FUSED_BLOCK elements, over a flat array whose length FUSED_BLOCK
    divides (comm buckets always are). A `TracedQuant` qualifies with the
    same block, whatever its level count."""
    shaped = message.dim() == 1 and message.shape[0] % FUSED_BLOCK == 0
    if isinstance(compressor, C.TracedQuant):
        return compressor.per_block == FUSED_BLOCK and shaped
    return _static_fused(compressor) and shaped


def _static_fused(compressor) -> bool:
    """A registry compressor that B1 realizes on rows of FUSED_BLOCK."""
    return (isinstance(compressor, C.StochasticQuant)
            and compressor.norm == "linf"
            and compressor.per_block == FUSED_BLOCK)


def packed_levels(compressors, sizes):
    """The level count L when ONE B1 launch over flat buckets of these
    sizes, packed back to back, realizes each bucket's compressor exactly:
    every one a registry compressor that `fused_compatible` takes on its
    bucket, all at the same static L. Rows are independent, so the packed
    launch then equals one launch a bucket. Otherwise None (a
    `TracedQuant`'s level count lives on the device: B2, a launch a
    bucket)."""
    if not (all(map(_static_fused, compressors))
            and all(n % FUSED_BLOCK == 0 for n in sizes)):
        return None
    levels = {c.levels for c in compressors}
    return levels.pop() if len(levels) == 1 else None


def compress_with_ef(compressor, message, e_prev, rand=None, generator=None,
                     *, use_ef: bool = True, allow_fused: bool = True):
    """Compress (message + e_prev); return (payload, local dequant, e_new).

    use_ef=False is the CPOAdam-GQ baseline: the compression error is
    dropped. `rand` replaces the compressor's draws (see compressors).
    """
    if use_ef and allow_fused and fused_compatible(compressor, message):
        return fused_quantize_ef(message, e_prev, rand, generator,
                                 levels=compressor.levels)
    m = message + e_prev.to(message.dtype) if use_ef else message
    payload = compressor.compress(m, rand, generator)
    m_hat = compressor.decompress(payload, m.shape, m.dtype)
    if use_ef:
        e_new = (m - m_hat).to(e_prev.dtype)
    else:
        e_new = e_prev  # stays zero
    return payload, m_hat, e_new


def compress_with_ef_stacked(compressor, message, e_prev, rand=None,
                             generator=None, *, use_ef: bool = True):
    """`compress_with_ef` for each worker of a (W, ...) stack, as JAX's
    per-worker body computes it; returns the stacked (payload, m_hat,
    e_new), each payload entry with a leading W axis.

    When the fused kernel realizes the compressor on one worker's message,
    every worker's scale rows are disjoint rows of the stack, so ONE
    launch over the stacked (W·R, 1024) rows is exact. Otherwise each
    worker compresses on its own. `rand` holds the workers' draws in
    worker order (a (W, ...) stack: row w is worker w's)."""
    W = message.shape[0]
    if use_ef and fused_compatible(compressor, message[0]):
        payload, m_hat, e_new = compress_with_ef(
            compressor, message.reshape(-1), e_prev.reshape(-1),
            None if rand is None else rand.reshape(-1), generator)
        payload = {k: v.reshape((W, -1) + tuple(v.shape[1:]))
                   for k, v in payload.items()}
        return payload, m_hat.reshape(message.shape), \
            e_new.reshape(e_prev.shape)
    outs = [compress_with_ef(compressor, message[w], e_prev[w],
                             None if rand is None else rand.reshape(W, -1)[w],
                             generator, use_ef=use_ef)
            for w in range(W)]
    payload = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
    return (payload, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def fused_quantize_ef(message_flat, e_prev, rand=None, generator=None, *,
                      levels=127):
    """EF + int8 quantization of a flat comm bucket in one kernel pass
    (kernels.quantize.quantize_ef_flat): the fused equivalent of
    compress_with_ef(StochasticQuant(bits=8, norm="linf",
    per_block=FUSED_BLOCK), ...). `rand` is a uniform (n,) tensor, drawn
    from `generator` when not given. `levels` is a Python int (kernel B1)
    or a one-element float32 tensor on the message's device (B2).

    Returns (payload {"codes" (R, 1024) int8, "scale" (R, 1) f32}, m_hat,
    e_new), laid out like the blocked StochasticQuant payload."""
    m32 = message_flat.float()
    if rand is None:
        rand = torch.rand(m32.shape, generator=generator, device=m32.device,
                          dtype=torch.float32)
    codes, scales, e_new = quantize_ef_flat(
        m32, e_prev.float(), rand.reshape(m32.shape), levels=levels)
    R = scales.shape[0]
    # the kernel's step s/L, by IEEE division (see kernels.ref), so that
    # m_hat + e_new = m holds to the last bit
    lvl = (levels.reshape(1, 1) if isinstance(levels, torch.Tensor)
           else scales.new_tensor(float(levels)))
    step = scales[:, None] / lvl
    m_hat = (codes.reshape(R, -1).float() * step).reshape(message_flat.shape)
    return ({"codes": codes.reshape(R, -1), "scale": scales.reshape(R, 1)},
            m_hat.to(message_flat.dtype), e_new.to(e_prev.dtype))


def lemma1_bound(eta, delta, G, sigma, B):
    """RHS of Lemma 1: 8η²(1-δ)(G² + σ²/B)/δ²."""
    return 8.0 * eta**2 * (1.0 - delta) * (G**2 + sigma**2 / B) / delta**2
