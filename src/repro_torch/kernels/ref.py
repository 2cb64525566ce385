"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and the reference `chip_smoke.py` holds each kernel against.

Counterpart of `repro.kernels.ref`: one plain version for each of the four
kernels (B1 and B2 share `quantize_ef_ref`), and the plain chunked SSD
(`ssd_chunked_ref`) that B5 replaces, which the JAX package runs as XLA."""
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


def ssd_chunked_ref(x, Bm, Cm, dt, A, D, P_, chunk_size):
    """Plain version of `kernels.ssd.ssd_chunked` (B5), the chunked SSD
    of `models.mixers` over a full sequence: x (B, T, H·P) (its dtype is
    the output's), Bm and Cm (B, T, N), dt (B, T, H) float32, A and D
    (H,). Returns y (B, T, H·P) with the skip D·x, before the gated norm,
    and the final state (B, H, P, N) float32. The heads are independent:
    a model rank runs this on its own heads with B and C whole."""
    B_, T, di = x.shape
    n_h, N = dt.shape[-1], Bm.shape[-1]
    L = min(chunk_size, T)
    if T % L:
        raise ValueError(f"ssd_apply: T={T} is not a multiple of the chunk "
                         f"size {L}")
    nc = T // L
    xh = x.reshape(B_, nc, L, n_h, P_)
    xf = xh.float()
    Bc = Bm.reshape(B_, nc, L, N).float()
    Cc = Cm.reshape(B_, nc, L, N).float()
    dtc = dt.reshape(B_, nc, L, n_h)                       # f32
    Adt = A[None, None, None] * dtc                        # (B, nc, L, H)
    cum = torch.cumsum(Adt, dim=2)                         # running log-decay
    # intra-chunk (lower-triangular) kernel. The reference takes
    # exp(cum_l - cum_m) before its tril mask (`repro/models/mixers.py`
    # :139-141): above the diagonal the exponent sums up to L-1 positive
    # |A dt| terms and overflows to inf at L = 256, which its `where`
    # drops in the forward, but whose backward forms 0 * inf = NaN in the
    # gradients of A_log, dt and dt_bias. Masking the exponent to -inf
    # first gives the same forward values (exp(-inf) = 0) and finite
    # gradients.
    tri = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    diff = cum[:, :, :, None] - cum[:, :, None, :]         # (B, nc, L, L, H)
    kern = torch.exp(torch.where(tri[None, None, :, :, None], diff,
                                 -math.inf))
    G = torch.einsum("bcln,bcmn->bclm", Cc, Bc)            # (B, nc, L, L)
    W = G[..., None] * kern * dtc[:, :, None]              # weight of l <- m
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", W, xf)
    # chunk-final states
    dec_to_end = torch.exp(cum[:, :, -1:, :] - cum)        # (B, nc, L, H)
    S_c = torch.einsum("bclh,bclhp,bcln->bchpn", dtc * dec_to_end, xf, Bc)
    chunk_decay = torch.exp(Adt.sum(dim=2))                # (B, nc, H)
    # the inter-chunk recurrence: h_prevs[c] is the state before chunk c
    h = torch.zeros((B_, n_h, P_, N), dtype=torch.float32, device=x.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    y_inter = torch.einsum("bcln,bchpn,bclh->bclhp", Cc,
                           torch.stack(h_prevs, dim=1), torch.exp(cum))
    y = (y_intra + y_inter).to(x.dtype)
    y = y + D.to(y.dtype)[None, None, None, :, None] * xh
    return y.reshape(B_, T, di), h
