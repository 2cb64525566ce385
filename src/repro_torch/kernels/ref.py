"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and the reference `chip_smoke.py` holds each kernel against.

Counterpart of `repro.kernels.ref`: one plain version for each of the four
kernels (B1 and B2 share `quantize_ef_ref`)."""
from __future__ import annotations

import math

import torch


def quantize_ef_ref(g, e, rand, levels=127):
    """Fused error-feedback stochastic quantization, per-row scales.

    g, e, rand: (R, C) float32 (rand uniform in [0, 1)). `levels` is a
    Python int (the plain version of `_quantize_ef_kernel`) or a
    one-element float32 tensor on the operands' device (the plain version
    of `_quantize_ef_kernel_dyn`, whose level count is a device operand).
    Returns (codes int8, scale (R, 1) f32, e_new f32) with
        m      = g + e
        scale  = max(|m|, axis=1) + 1e-20
        codes  = floor(m / scale * levels) + (rand < frac)
        e_new  = m - codes * scale / levels
    """
    m = g.float() + e.float()
    scale = m.abs().amax(dim=1, keepdim=True) + 1e-20
    if isinstance(levels, torch.Tensor):
        lvl = levels.reshape(1, 1)
    else:
        # a device tensor as divisor: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not IEEE division
        lvl = scale.new_tensor(float(levels))
    lv = m / scale * lvl
    low = torch.floor(lv)
    codes = (low + (rand < (lv - low)).float()).to(torch.int8)
    deq = codes.float() * (scale / lvl)
    return codes, scale, m - deq


def paged_attention_ref(q, pool_k, pool_v, table, lengths):
    """Plain version of `kernels.flash_attention.paged_flash_attention`
    (B3): gather the block pool through the table into a dense per-row
    view, mask by length, plain softmax, all in float32.

    q: (B, K, G, D); pool_k/v: (NB, bs, K, D); table: (B, MAXB) int32;
    lengths: (B,) int32. Returns (B, K, G, D) in q's dtype."""
    B, Kh, G, D = q.shape
    bs = pool_k.shape[1]
    S = table.shape[1] * bs
    tl = table.long()
    ck = pool_k[tl].reshape(B, S, Kh, D).float()
    cv = pool_v[tl].reshape(B, S, Kh, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", q.float(), ck)
    s = s / math.sqrt(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths[:, None].to(q.device))
    s = torch.where(valid[:, None, None, :], s, -1e30)
    p = torch.softmax(s, dim=-1)
    # rows with length 0 have an all-masked softmax (uniform probs); zero
    # them explicitly to match the kernel's empty-loop output
    p = torch.where(lengths.to(q.device)[:, None, None, None] > 0, p, 0.0)
    return torch.einsum("bkgs,bskd->bkgd", p, cv).to(q.dtype)


def flash_attention_ref(q, k, v, causal=True):
    """Plain version of `kernels.flash_attention.flash_attention` (B4):
    softmax attention in float32, masked with -1e30 above the diagonal when
    `causal`. q, k, v: (B, S, H, D) (the same H for k/v). Returns (B, S, H,
    D) in q's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
