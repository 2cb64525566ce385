"""Shared layers (counterpart of `repro.models.layers`): linears, the
embedding, norms, RoPE, MLPs and attention (GQA/MQA, prefill, dense-cache
decode and paged-cache decode).

Everything is functional, in the JAX package's layout: `*_init(...) ->
params` as nested dicts, linear ``w`` (d_in, d_out) with ``y = x @ w + b``,
attention activations (B, S, heads, head_dim). Decode updates a cache's
tensors in place (the JAX functions return new arrays; here the K/V
written for the new token go into the caller's cache tensors, and the
returned cache is the same dict).

Prefill above 2048 tokens takes `attention_chunked` (a loop over query
chunks, each against its KV band; an XLA scan in the JAX package, no
Pallas kernel). A model with ``attention_window > 0`` keeps a rolling
cache of ``window`` slots: slot i holds the position p with p ≡ i (mod
window). Cross-attention (``cross_kv``, an encoder-decoder model's
decoder) attends without a mask to K/V projected from the encoder output.

Tensor parallelism (`parallel.tensor`, the JAX package's 'model' axis):
under a current model group a linear runs by the spec of its weight,
column-parallel (`col_linear`: the rank's block of the outputs),
row-parallel (`row_linear`: the partial products all-reduced, then the
replicated bias) or replicated. The MLP is column (`gate`, `up`) then row
(`down`). Training attention runs head-local where the q and kv shards
fall on head boundaries; otherwise (a split KV head, as gemma-2b's one
MQA head over two ranks) it gathers the sharded projections over the
model group, computes attention replicated, and hands the row-parallel
`o` the rank's slice of its input. Cross-attention follows the same
rule, its k and v projecting the encoder output.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import paged_flash_attention
from repro_torch.parallel import tensor as TP

_CHUNKED_PREFILL = 2048   # the JAX package switches to attention_chunked above


def _randn(shape, generator, device):
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


# ------------------------------------------------------------------------- #
# init helpers
# ------------------------------------------------------------------------- #
def linear_init(d_in, d_out, use_bias=False, *, generator=None, device=None,
                dtype=torch.float32, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    p = {"w": (_randn((d_in, d_out), generator, device) * scale).to(dtype)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def col_linear(p, x, n_out):
    """`linear` with w (d_in, n_out) column-parallel over the current model
    group where it shards n_out: the rank's block of the outputs."""
    if not TP.shards(n_out):
        return linear(p, x)
    return linear(p, TP.copy_to(x))


def row_linear(p, x, n_in):
    """`linear` with w (n_in, d_out) row-parallel over the current model
    group where it shards n_in: x is the rank's block of the inputs, the
    partial products are all-reduced, then the (replicated) bias added."""
    if not TP.shards(n_in):
        return linear(p, x)
    y = TP.reduce_from(x @ p["w"])
    if "b" in p:
        y = y + p["b"]
    return y


def embed_init(vocab, d, *, generator=None, device=None,
               dtype=torch.float32):
    return (_randn((vocab, d), generator, device) / math.sqrt(d)).to(dtype)


# ------------------------------------------------------------------------- #
# norms
# ------------------------------------------------------------------------- #
def norm_init(kind: str, d, *, device=None, dtype=torch.float32):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def apply_norm(kind: str, p, x, eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = (xf - mu).square().mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ------------------------------------------------------------------------- #
# RoPE
# ------------------------------------------------------------------------- #
def rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: (..., S) integer tensor."""
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq      # (..., S, half)
    ang = ang[..., None, :]                           # broadcast over heads
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------------- #
# MLP
# ------------------------------------------------------------------------- #
def mlp_init(d, ff, activation, use_bias, *, generator=None, device=None,
             dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype)
    down = linear_init(ff, d, use_bias, scale=1 / math.sqrt(ff), **kw)
    if activation in ("silu", "geglu"):
        return {"gate": linear_init(d, ff, use_bias, **kw),
                "up": linear_init(d, ff, use_bias, **kw), "down": down}
    return {"up": linear_init(d, ff, use_bias, **kw), "down": down}


_GELU_CONSTANTS = {}


def _gelu_constants(dtype):
    """sqrt(2/pi) and 0.044715 rounded to `dtype`, as Python floats (a
    tensor op takes them at that value), computed once per dtype."""
    c = _GELU_CONSTANTS.get(dtype)
    if c is None:
        c = _GELU_CONSTANTS[dtype] = tuple(
            torch.tensor(x, dtype=dtype).item()
            for x in (math.sqrt(2 / math.pi), 0.044715))
    return c


def _gelu_tanh(v):
    """`jax.nn.gelu(v, approximate=True)` as the reference evaluates it:
    op by op in v's dtype, each constant rounded to that dtype first.
    (`F.gelu(approximate="tanh")` computes in float32 and rounds once,
    which differs from the reference in about 40 % of bfloat16 outputs.)"""
    c, k = _gelu_constants(v.dtype)
    cube = (v * v) * v
    cdf = 0.5 * (1.0 + torch.tanh(c * (v + k * cube)))
    return v * cdf


def _silu(v):
    """`jax.nn.silu(v)` as the reference evaluates it on the CPU backend:
    ``v * (1 / (1 + exp(-v)))`` (`lax.logistic` expanded), op by op in v's
    dtype, each result rounded to it. (`F.silu` computes in float32 and
    rounds once, which differs from the reference in about 37 % of
    bfloat16 outputs.)"""
    return v * (1.0 / (1.0 + torch.exp(-v)))


def mlp(p, x, activation: str, ff: int = 0):
    """The FFN; `ff` (its hidden width) > 0 lets a current model group
    run it column (`gate`, `up`) then row (`down`) parallel."""
    tp = ff > 0 and TP.shards(ff)
    if tp:
        x = TP.copy_to(x)
    if activation in ("silu", "geglu"):
        act = _silu if activation == "silu" else _gelu_tanh
        h = act(linear(p["gate"], x)) * linear(p["up"], x)
    else:
        h = _gelu_tanh(linear(p["up"], x))
    return row_linear(p["down"], h, ff) if tp else linear(p["down"], h)


# ------------------------------------------------------------------------- #
# attention
# ------------------------------------------------------------------------- #
# Paged-decode attention implementation:
#   "gather" — gather the block pool through the table into a dense
#              (B, S, K, hd) view and run the grouped decode math of the
#              dense-cache branch (the same ops as a dense sequential
#              decode at the same context length);
#   "kernel" — kernels.flash_attention.paged_flash_attention (B3), the
#              CUDA kernel that reads only the live blocks: the counterpart
#              of the JAX package's "pallas".
# A module global, as in the JAX package, so the serving engine can switch
# it around its decode step without a config field.
_PAGED_ATTN_IMPL = ["gather"]


def set_paged_attn_impl(impl: str) -> str:
    """Set the paged decode attention impl; returns the previous value."""
    if impl not in ("gather", "kernel"):
        raise ValueError(f"paged attention impl must be gather|kernel, got "
                         f"{impl!r}")
    prev = _PAGED_ATTN_IMPL[0]
    _PAGED_ATTN_IMPL[0] = impl
    return prev


def attn_init(d, n_heads, n_kv, head_dim, use_bias, *, generator=None,
              device=None, dtype=torch.float32):
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "q": linear_init(d, n_heads * head_dim, use_bias, **kw),
        "k": linear_init(d, n_kv * head_dim, use_bias, **kw),
        "v": linear_init(d, n_kv * head_dim, use_bias, **kw),
        "o": linear_init(n_heads * head_dim, d, use_bias,
                         scale=1 / math.sqrt(n_heads * head_dim), **kw),
    }


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _repeat_kv(k, n_heads, n_kv):
    """Each KV head repeated for its n_heads // n_kv query heads (as
    repeat_interleave on the head axis), by a broadcast whose backward is
    a sum, in a fixed order on CUDA."""
    if n_heads == n_kv:
        return k
    g = n_heads // n_kv
    return k[..., None, :].expand(k.shape[:-1] + (g, k.shape[-1])).reshape(
        k.shape[:-2] + (n_heads, k.shape[-1]))


def _causal_band_mask(q_pos, k_pos, window: int):
    """True where attention is allowed."""
    diff = q_pos[:, None] - k_pos[None, :]
    ok = diff >= 0
    if window > 0:
        ok &= diff < window
    return ok


def attention_dense(q, k, v, q_pos, k_pos, window=0, causal=True,
                    softcap=0.0):
    """Plain O(S²) attention. q: (B,Sq,H,hd); k,v: (B,Sk,K,hd)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    k = _repeat_kv(k, H, K)
    v = _repeat_kv(v, H, K)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(hd)
    if softcap > 0:
        scores = torch.tanh(scores / softcap) * softcap
    if causal:
        mask = _causal_band_mask(q_pos, k_pos, window)
        scores = torch.where(mask[None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H * hd)


def attention_chunked(q, k, v, window=0, causal=True, q_chunk=1024):
    """Memory-bounded attention for long sequences: query chunks of
    `q_chunk` rows, each against a KV band, through `attention_dense`. With
    a window the band is ``min(S, q_chunk·(⌈window/q_chunk⌉+1))`` keys
    ending at the chunk's last row, so the work is O(S·band), not O(S²).

    q: (B, S, H, hd), k/v: (B, S, K, hd), self-attention at aligned
    positions; S a multiple of q_chunk."""
    B, S, H, hd = q.shape
    if S % q_chunk:
        raise ValueError(f"attention_chunked: S={S} is not a multiple of "
                         f"q_chunk={q_chunk}")
    kv_span = (S if window <= 0
               else min(S, q_chunk * (-(-window // q_chunk) + 1)))
    outs = []
    for q_start in range(0, S, q_chunk):
        k_start = 0 if window <= 0 else max(q_start + q_chunk - kv_span, 0)
        kc = k[:, k_start:k_start + kv_span]
        vc = v[:, k_start:k_start + kv_span]
        q_pos = torch.arange(q_start, q_start + q_chunk, device=q.device)
        k_pos = torch.arange(k_start, k_start + kc.shape[1], device=q.device)
        outs.append(attention_dense(q[:, q_start:q_start + q_chunk], kc, vc,
                                    q_pos, k_pos, window=window,
                                    causal=causal))
    return torch.cat(outs, dim=1)


def _grouped_decode(q, ck, cv, valid, cfg):
    """The grouped-GQA decode math of the dense-cache and gather branches:
    q (B, S, H, hd) against ck/cv (B, Sc, K, hd) with `valid` (B or 1, Sc)
    marking the positions attended to. Scores are f32 products of the
    operands (JAX's preferred_element_type=float32)."""
    B, S = q.shape[:2]
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qg = q.reshape(B, S, Kh, H // Kh, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), ck.float())
    scores = scores / math.sqrt(hd)
    scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(cv.dtype), cv)
    return out.reshape(B, S, H * hd)


def attn_apply(p, x, cfg, positions, cache=None, cross_kv=None, causal=True,
               fill_cache=False):
    """Prefill or train (cache None; with fill_cache=True the K/V come back
    as a decode-ready cache), dense-cache decode (cache {"k", "v", "pos"}),
    paged decode (cache {"k": pool, "v": pool, "table"}), or
    cross-attention (cross_kv: the encoder output (B, Se, d), which the
    block's k and v project; no mask, no cache). Returns (out,
    new_cache)."""
    B, S, d = x.shape
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if TP.current() is not None and cache is None:
        return _attn_train_tp(p, x, cfg, positions, causal, fill_cache,
                              enc=cross_kv)
    q = _split_heads(linear(p["q"], x), H, hd)
    if cross_kv is not None:
        k = _split_heads(linear(p["k"], cross_kv), Kh, hd)
        v = _split_heads(linear(p["v"], cross_kv), Kh, hd)
        out = attention_dense(q, k, v, positions,
                              torch.arange(k.shape[1], device=x.device),
                              causal=False)
        return linear(p["o"], out), None
    k = _split_heads(linear(p["k"], x), Kh, hd)
    v = _split_heads(linear(p["v"], x), Kh, hd)
    if cfg.use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    win = cfg.attention_window
    if cache is None:  # train / prefill
        if S > _CHUNKED_PREFILL:
            out = attention_chunked(q, k, v, window=win, causal=causal)
        else:
            pos = torch.arange(S, device=x.device)
            out = attention_dense(q, k, v, pos, pos, window=win,
                                  causal=causal)
        new_cache = None
        if fill_cache:
            if win > 0 and S >= win:
                # rolling layout: slot i holds position
                # S - win + ((i - S) mod win), so that it is ≡ i (mod win)
                idx = S - win + torch.remainder(
                    torch.arange(win, device=x.device) - S, win)
                k, v = k.index_select(1, idx), v.index_select(1, idx)
            elif win > 0:  # prompt shorter than the window: win slots
                k = F.pad(k, (0, 0, 0, 0, 0, win - S))
                v = F.pad(v, (0, 0, 0, 0, 0, win - S))
            new_cache = {"k": k, "v": v,
                         "pos": torch.tensor(S, dtype=torch.int32)}
        return linear(p["o"], out), new_cache

    # ---- decode with a KV cache ----------------------------------------- #
    if "table" in cache:
        return _paged_attn_decode(p, cfg, q, k, v, cache, positions)
    ck, cv = cache["k"], cache["v"]
    # "pos" is host state (a CPU int32 tensor): reading it needs no sync
    t = int(cache["pos"])
    if win > 0 and ck.shape[1] == win:
        # rolling: write at t mod win; slot i holds t - ((slot - i) mod win)
        slot = t % win
        ck[:, slot:slot + S] = k
        cv[:, slot:slot + S] = v
        k_pos = t - torch.remainder(
            slot - torch.arange(win, device=x.device), win)
        valid = (k_pos >= 0)[None]
    else:
        ck[:, t:t + S] = k
        cv[:, t:t + S] = v
        valid = (torch.arange(ck.shape[1], device=x.device) <= t)[None]
    out = _grouped_decode(q, ck, cv, valid, cfg)
    cache["pos"] += S
    return linear(p["o"], out), cache


def _attn_train_tp(p, x, cfg, positions, causal, fill_cache, enc=None):
    """Training attention under a model group: self-attention, or with
    `enc` (the encoder output) cross-attention, whose k and v project
    `enc`. The column-parallel q/k/v take their input through `copy_to`,
    replicated ones take it as it is. Head-local when q, k and v all
    shard on head boundaries (each rank's query heads then attend to its
    own KV heads); otherwise the sharded projections are gathered and
    attention runs replicated, and the row-parallel `o` takes the rank's
    slice of its output."""
    if fill_cache:
        raise ValueError("attn_apply: a tensor-parallel prefill is not "
                         "supported; the model axis is the trainer's")
    B, S, _ = x.shape
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = TP.current().size
    q_sh, kv_sh = TP.shards(H * hd), TP.shards(Kh * hd)
    xs = TP.copy_to(x) if q_sh or (kv_sh and enc is None) else x
    src = x if enc is None else enc
    srcs = (xs if enc is None else TP.copy_to(enc)) if kv_sh else src
    q = linear(p["q"], xs if q_sh else x)
    k = linear(p["k"], srcs)
    v = linear(p["v"], srcs)
    local = q_sh and kv_sh and H % g == 0 and Kh % g == 0
    if local:
        Hl, Kl = H // g, Kh // g
    else:
        if q_sh:
            q = TP.gather_from(q)
        if kv_sh:
            k, v = TP.gather_from(k), TP.gather_from(v)
        Hl, Kl = H, Kh
    q, k, v = (_split_heads(q, Hl, hd), _split_heads(k, Kl, hd),
               _split_heads(v, Kl, hd))
    win = cfg.attention_window
    if enc is not None:     # no positions, no mask
        out = attention_dense(q, k, v, positions,
                              torch.arange(k.shape[1], device=x.device),
                              causal=False)
    else:
        if cfg.use_rope:
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        pos = torch.arange(S, device=x.device)
        if S > _CHUNKED_PREFILL:
            out = attention_chunked(q, k, v, window=win, causal=causal)
        else:
            out = attention_dense(q, k, v, pos, pos, window=win,
                                  causal=causal)
    if not local and q_sh:
        out = TP.scatter_to(out)
    return row_linear(p["o"], out, H * hd), None


def _paged_attn_decode(p, cfg, q, k, v, cache, positions):
    """Single-token decode against a paged KV cache.

    q: (B, 1, H, hd) post-RoPE; k, v: (B, 1, K, hd) post-RoPE; positions
    (B, 1) int32 on the device, each row's write position. The incoming
    token's K/V are written (in place) into the pool block the row's table
    maps its write position to, then attention reads the row's blocks.
    Rows whose table is parked on the scratch block (inactive serving
    slots) write there harmlessly; their outputs are discarded.

    "gather" keeps the ops of the dense-cache branch, so an engine decode
    step computes what a dense sequential decode at the same context
    length computes; "kernel" launches B3.
    """
    pool_k, pool_v, table = cache["k"], cache["v"], cache["table"]
    B = q.shape[0]
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    bs = pool_k.shape[1]
    S = bs * table.shape[1]                              # gathered length
    t = positions[:, -1]                                 # (B,) write position
    rows = torch.arange(B, device=q.device)
    bidx = table[rows, t // bs].long()                   # (B,) pool block id
    slot = (t % bs).long()
    pool_k[bidx, slot] = k[:, 0]
    pool_v[bidx, slot] = v[:, 0]

    if _PAGED_ATTN_IMPL[0] == "kernel":
        out = paged_flash_attention(
            q[:, 0].reshape(B, Kh, H // Kh, hd).contiguous(), pool_k,
            pool_v, table, t + 1)
        return linear(p["o"], out.reshape(B, 1, H * hd)), cache

    tl = table.long()
    ck = pool_k[tl].reshape(B, S, Kh, hd)
    cv = pool_v[tl].reshape(B, S, Kh, hd)
    valid = torch.arange(S, device=q.device)[None, :] <= t[:, None]
    out = _grouped_decode(q, ck, cv, valid, cfg)
    return linear(p["o"], out), cache


def attn_cache_init(cfg, batch, seq, dtype, device=None):
    """A dense cache of `seq` positions; a windowed model's is rolling and
    holds min(seq, window)."""
    win = cfg.attention_window
    length = min(seq, win) if win > 0 else seq
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.zeros((), dtype=torch.int32)}
