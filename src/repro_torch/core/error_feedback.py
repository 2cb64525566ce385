"""Error feedback (paper Algorithm 2, lines 6–8; Lemma 1).

Counterpart of `repro.core.error_feedback`. The worker sends Q(m) with
m = message + e_prev and keeps e_new = m − Q(m). For the block-1024 linf
quantizers over a flat bucket, the EF add, scale, stochastic round and
residual run in one pass of the fused kernel (`kernels.quantize`).
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
    divides (comm buckets always are)."""
    shaped = message.dim() == 1 and message.shape[0] % FUSED_BLOCK == 0
    return (isinstance(compressor, C.StochasticQuant)
            and compressor.norm == "linf"
            and compressor.per_block == FUSED_BLOCK
            and shaped)


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


def fused_quantize_ef(message_flat, e_prev, rand=None, generator=None, *,
                      levels=127):
    """EF + int8 quantization of a flat comm bucket in one kernel pass
    (kernels.quantize.quantize_ef_flat): the fused equivalent of
    compress_with_ef(StochasticQuant(bits=8, norm="linf",
    per_block=FUSED_BLOCK), ...). `rand` is a uniform (n,) tensor, drawn
    from `generator` when not given.

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
    step = scales[:, None] / scales.new_tensor(float(levels))
    m_hat = (codes.reshape(R, -1).float() * step).reshape(message_flat.shape)
    return ({"codes": codes.reshape(R, -1), "scale": scales.reshape(R, 1)},
            m_hat.to(message_flat.dtype), e_new.to(e_prev.dtype))


def lemma1_bound(eta, delta, G, sigma, B):
    """RHS of Lemma 1: 8η²(1-δ)(G² + σ²/B)/δ²."""
    return 8.0 * eta**2 * (1.0 - delta) * (G**2 + sigma**2 / B) / delta**2
