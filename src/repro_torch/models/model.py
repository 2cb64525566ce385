"""The unified LM (counterpart of `repro.models.model`): a cycled pattern
of blocks (attention, RG-LRU or SSD mixers; dense MLP or MoE FFN,
`repro_torch.models.moe`), the encoder of encoder-decoder models, the
chunked cross-entropy, and the prefill and decode of the serving engine.

    init(cfg, generator=, device=, max_seq=)      -> params
    forward(params, cfg, tokens, positions, ...)  -> (hidden, caches, aux)
    encode(params, cfg, enc_embeds)               -> encoder output
    loss_fn(params, cfg, batch)                   -> (total, metrics)
    prefill(params, cfg, tokens, enc_embeds=, max_len=) -> (logits, caches)
    decode_step(params, cfg, tokens, caches)      -> (logits, caches)
    decode_step_paged(params, cfg, tokens, caches, lengths)
    init_cache(cfg, batch, seq, dtype, device)    -> cache tree

Parameters keep the JAX package's tree: layers stacked along a leading
axis under ``params["scan"]`` (one entry ``"b{i}"`` per position of the
layer pattern), unscanned layers in the list ``params["tail"]``, the
encoder under ``params["enc"]`` and the learned positions of an
absolute-position model under ``params["pos"]``, so that weights cross
over by copy (`repro_torch.convert`). `_stack_apply` loops over the
stacked axis in Python where the JAX package scans; in training each
period runs under `torch.utils.checkpoint` when ``cfg.remat`` asks for it
(the JAX package's `jax.checkpoint` of the scan body), and the MoE
router's aux losses are summed over the layers. Gradients of the
per-layer views land on the stacked leaves.

`loss_fn` returns the cross-entropy plus the aux losses, and the metrics
{"loss", **aux}; `chunked_xent` takes the logits ``xent_chunk`` tokens at
a time, each chunk recomputed in the backward pass, so that one (B,
chunk, V) block of logits is alive at a time.

Under a model group (`parallel.tensor`, the trainer's 'model' axis) the
embedding is vocab-parallel (a masked lookup of the rank's rows, then an
all-reduce), the unembedding column-parallel, so each rank holds a (...,
V / model) block of logits, and `_xent` takes the log-sum-exp as a
model-group max and sum and picks the target logit by a mask and a sum:
no rank holds a full (B, chunk, V) block. The SSD and RG-LRU mixers
(`mixers`), the encoder's self-attention and the decoder's
cross-attention (`layers.attn_apply`) run on the rank's shards too, so
the axis covers every arch; the learned positions stay replicated.
Prefill and decode run there as well, against a rank's part of the
decode cache (`parallel.sharding.shard_cache`, in `kv_layout`
"hd_model" or "seq_model"); they gather the rank's block of the
last-token logits, so they return the whole (B, V) logits, as the
reference's sharded functions do.

Under the fsdp parameter layout (`parallel.fsdp`, the trainer's Mode
B) the parameters are a rank's shards over 'data' as well: each period
of the stacked layers, each tail block and each encoder block gathers
its sharded leaves at its top (a period inside its checkpoint), and the
loss is the rank's share of its worker's.

Caches keep the JAX tree too ({"scan": ..., "tail": [...]}, and
``"enc_out"`` for an encoder-decoder model); decode writes into their
tensors in place (attention K/V, and a mixer's recurrent state and conv
buffer) and returns the same tree. A dense cache's ``"pos"`` is a CPU
int32 tensor (host state: reading it needs no device sync); the paged
cache has none, its positions come in `decode_step_paged`'s `lengths`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T
from repro_torch.parallel import fsdp as FS
from repro_torch.parallel import tensor as TP

from . import moe as moe_lib
from . import mixers
from .layers import (
    _randn,
    apply_norm,
    attn_apply,
    attn_cache_init,
    attn_init,
    embed_init,
    linear,
    mlp,
    mlp_init,
    norm_init,
)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg):
    return _DTYPES[cfg.param_dtype]


def pattern_kinds(cfg) -> list:
    return [cfg.layer_pattern[i % len(cfg.layer_pattern)]
            for i in range(cfg.num_layers)]


# ------------------------------------------------------------------------- #
# single block
# ------------------------------------------------------------------------- #
def block_init(cfg, kind: str, cross: bool = False, *, generator=None,
               device=None):
    kw = dict(device=device, dtype=_dtype(cfg))
    d = cfg.d_model
    gkw = dict(generator=generator, **kw)
    p = {"norm1": norm_init(cfg.norm, d, **kw)}
    if kind == "attn":
        p["attn"] = attn_init(d, cfg.num_heads, cfg.num_kv_heads,
                              cfg.head_dim, cfg.use_bias, **gkw)
    elif kind == "rglru":
        p["rglru"] = mixers.rglru_init(cfg, **gkw)
    elif kind == "ssd":
        p["ssd"] = mixers.ssd_init(cfg, **gkw)
    else:
        raise ValueError(kind)
    if cross:
        p["cross_norm"] = norm_init(cfg.norm, d, **kw)
        p["cross"] = attn_init(d, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, cfg.use_bias, **gkw)
    if cfg.d_ff > 0 or cfg.moe is not None:
        p["norm2"] = norm_init(cfg.norm, d, **kw)
        if cfg.moe is not None:
            p["moe"] = moe_lib.moe_init(cfg, **gkw)
        else:
            p["mlp"] = mlp_init(d, cfg.d_ff, cfg.activation, cfg.use_bias,
                                **gkw)
    return p


def block_apply(p, cfg, kind, x, positions, cache=None, cross_kv=None,
                causal=True, fill_cache=False):
    """Returns (x, new_cache, aux_losses): the MoE router's losses, or {}.
    cross_kv is the raw encoder output; each block projects its own K/V
    from it. `fill_cache` as `layers.attn_apply` takes it."""
    aux = {}
    h = apply_norm(cfg.norm, p["norm1"], x)
    if kind == "attn":
        out, new_cache = attn_apply(p["attn"], h, cfg, positions, cache=cache,
                                    causal=causal, fill_cache=fill_cache)
    elif kind == "rglru":
        out, new_cache = mixers.rglru_apply(p["rglru"], cfg, h, state=cache,
                                            return_state=bool(fill_cache))
    elif kind == "ssd":
        out, new_cache = mixers.ssd_apply(p["ssd"], cfg, h, state=cache,
                                          return_state=bool(fill_cache))
    else:
        raise ValueError(kind)
    x = x + out
    if "cross" in p and cross_kv is not None:
        h = apply_norm(cfg.norm, p["cross_norm"], x)
        out, _ = attn_apply(p["cross"], h, cfg, positions,
                            cross_kv=cross_kv)
        x = x + out
    if "mlp" in p:
        x = x + mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], x),
                    cfg.activation, cfg.d_ff)
    elif "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"], cfg,
                                   apply_norm(cfg.norm, p["norm2"], x))
        x = x + y
    return x, new_cache, aux


def block_cache_init(cfg, kind, batch, seq, dtype, device=None):
    if kind == "attn":
        return attn_cache_init(cfg, batch, seq, dtype, device)
    if kind == "rglru":
        return mixers.rglru_state_init(cfg, batch, dtype, device)
    if kind == "ssd":
        return mixers.ssd_state_init(cfg, batch, dtype, device)
    raise ValueError(kind)


# ------------------------------------------------------------------------- #
# parameter tree
# ------------------------------------------------------------------------- #
def _stack(trees):
    """One tree of the per-layer trees' leaves stacked on a leading axis."""
    return T.tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def _layer(tree, i):
    """Layer i of a stacked tree: views, so in-place writes reach it."""
    return T.tree_map(lambda a: a[i], tree)


def _unstack(tree, n):
    """The n layers of a stacked tree, views made by one `unbind` a leaf:
    its backward stacks the layers' gradients into the leaf's in one
    copy."""
    paths, leaves = T.flatten(tree)
    cols = [a.unbind(0) for a in leaves]
    return [T.unflatten(paths, [c[i] for c in cols]) for i in range(n)]


def _n_scan(cfg):
    period = len(cfg.layer_pattern)
    return period, (cfg.num_layers // period if cfg.scan_layers else 0)


def init(cfg, *, generator=None, device=None, max_seq: int = 0):
    """Full parameter tree; the scanned layers are stacked:
    params['scan']['b{i}'] has shape (n_periods, ...). An absolute-position
    model (whisper) needs `max_seq`, the length of its position table."""
    dt = _dtype(cfg)
    kinds = pattern_kinds(cfg)
    period, n_scan = _n_scan(cfg)
    cross = cfg.is_encdec
    kw = dict(generator=generator, device=device, dtype=dt)
    bkw = dict(generator=generator, device=device)
    p: dict = {"embed": embed_init(cfg.vocab_size, cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": embed_init(cfg.d_model, cfg.vocab_size, **kw)}
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, device=device,
                                dtype=dt)
    if n_scan:
        p["scan"] = {
            f"b{i}": _stack([block_init(cfg, cfg.layer_pattern[i], cross,
                                        **bkw)
                             for _ in range(n_scan)])
            for i in range(period)}
    tail_kinds = kinds[n_scan * period:]
    if tail_kinds:
        p["tail"] = [block_init(cfg, kind, cross, **bkw)
                     for kind in tail_kinds]
    if cfg.is_encdec:
        e = cfg.encdec
        p["enc"] = {
            "blocks": [block_init(cfg, "attn", **bkw)
                       for _ in range(e.enc_layers)],
            "final_norm": norm_init(cfg.norm, cfg.d_model, device=device,
                                    dtype=dt),
            "pos": (_randn((e.enc_seq, cfg.d_model), generator, device)
                    * 0.02).to(dt)}
    if cfg.positional == "learned":
        if max_seq <= 0:
            raise ValueError(f"{cfg.name}: an absolute-position model needs "
                             f"max_seq > 0")
        p["pos"] = (_randn((max_seq, cfg.d_model), generator, device)
                    * 0.02).to(dt)
    return p


# ------------------------------------------------------------------------- #
# forward over the block stack
# ------------------------------------------------------------------------- #
def _stack_apply(params, cfg, x, positions, caches=None, cross_kv=None,
                 fill_cache=False):
    """Run all layers. Three modes:
      train   : caches=None, fill_cache=False  (remat'd periods, aux summed)
      prefill : caches=None, fill_cache=(kv_layout, max_len)
                (caches stacked per layer)
      decode  : caches=tree                     (updated in place)
    Returns (x, new_caches, aux)."""
    period, n_scan = _n_scan(cfg)
    train = caches is None and not fill_cache
    aux_total = {}

    def add_aux(aux):
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v

    def period_fn(x, layer_p, layer_c):
        # the fsdp layout's gathers, inside the period's checkpoint: its
        # backward gathers again, and one period's weights live at a time
        layer_p = FS.gathered(layer_p, ("scan",), stacked=True)
        lc, aux_p = {}, {}
        for i in range(period):
            x, lc[f"b{i}"], aux = block_apply(
                layer_p[f"b{i}"], cfg, cfg.layer_pattern[i], x, positions,
                cache=None if layer_c is None else layer_c[f"b{i}"],
                cross_kv=cross_kv, fill_cache=fill_cache)
            for k, v in aux.items():
                aux_p[k] = aux_p.get(k, 0.0) + v
        return x, lc, aux_p

    new_caches = {"scan": None, "tail": []}
    if n_scan:
        layers_p = _unstack(params["scan"], n_scan)
        if train:
            if cfg.moe is not None:   # the JAX scan carries both from zero
                aux_total.update({k: torch.zeros((), device=x.device)
                                  for k in ("moe_load_balance",
                                            "moe_router_z")})
            remat = cfg.remat != "none" and torch.is_grad_enabled()
            for layer_p in layers_p:
                x, _, aux = (checkpoint(period_fn, x, layer_p, None,
                                        use_reentrant=False) if remat
                             else period_fn(x, layer_p, None))
                add_aux(aux)
        else:
            per_layer = []
            for layer, layer_p in enumerate(layers_p):
                layer_c = (None if caches is None
                           else _layer(caches["scan"], layer))
                x, lc, _ = period_fn(x, layer_p, layer_c)
                per_layer.append(lc)
            if fill_cache:
                new_caches["scan"] = _stack(per_layer)
            else:
                new_caches["scan"] = caches["scan"]
    for i, bp in enumerate(params.get("tail", [])):
        kind = cfg.layer_pattern[(n_scan * period + i) % period]
        c = None if caches is None else caches["tail"][i]
        bp = FS.gathered(bp, ("tail", i))
        x, nc, aux = block_apply(bp, cfg, kind, x, positions, cache=c,
                                 cross_kv=cross_kv, fill_cache=fill_cache)
        add_aux(aux)
        new_caches["tail"].append(nc)
    if train:
        new_caches = None
    return x, new_caches, aux_total


def encode(params, cfg, enc_embeds):
    """The encoder of an encoder-decoder model over precomputed frame
    embeddings (B, Se, d) (whisper's audio frontend is a stub, as in the
    JAX package): learned positions, non-causal attention blocks, the
    final norm."""
    e = params["enc"]
    x = enc_embeds.to(_dtype(cfg)) + e["pos"][None, :enc_embeds.shape[1]]
    pos = torch.arange(x.shape[1], device=x.device)
    for i, bp in enumerate(e["blocks"]):
        x, _, _ = block_apply(FS.gathered(bp, ("enc", "blocks", i)), cfg,
                              "attn", x, pos, causal=False)
    return apply_norm(cfg.norm, e["final_norm"], x)


def _embed_tokens(params, cfg, tokens, positions):
    # F.embedding's backward sums a token's rows in a fixed order on CUDA
    V = cfg.vocab_size
    if TP.shards(V):   # vocab-parallel: this rank's rows, then the sum
        g = TP.current()
        n = V // g.size
        local = tokens - g.index * n
        hit = (local >= 0) & (local < n)
        x = F.embedding(torch.where(hit, local, 0), params["embed"])
        x = TP.reduce_from(x * hit[..., None].to(x.dtype))
    else:
        x = F.embedding(tokens, params["embed"])
    # the JAX package multiplies by a weakly typed Python float, which
    # takes the activation's dtype: round the factor the same way
    scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    x = x * scale
    if cfg.positional == "learned" and "pos" in params:
        x = x + F.embedding(positions.expand(tokens.shape), params["pos"])
    return x.to(_dtype(cfg))


def forward(params, cfg, tokens, positions, caches=None, enc_out=None,
            fill_cache=False):
    """tokens: (B, S) integer. Returns (hidden, new_caches, aux)."""
    x = _embed_tokens(params, cfg, tokens, positions)
    x, new_caches, aux = _stack_apply(params, cfg, x, positions, caches,
                                      cross_kv=enc_out,
                                      fill_cache=fill_cache)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x, new_caches, aux


def logits_fn(params, cfg, hidden):
    """The logits; under a model group that shards the vocabulary, the
    rank's (..., V / model) block of them."""
    if TP.shards(cfg.vocab_size):
        hidden = TP.copy_to(hidden)
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return linear(params["unembed"], hidden)


def _last_logits(params, cfg, hidden):
    """The whole (B, V) logits of the last position: under a model group
    that shards the vocabulary, the ranks' blocks gathered."""
    logits = logits_fn(params, cfg, hidden[:, -1])
    return (TP.gather_from(logits) if TP.shards(cfg.vocab_size)
            else logits)


# ------------------------------------------------------------------------- #
# losses
# ------------------------------------------------------------------------- #
def _xent(logits, targets, vocab: int = 0):
    """Per-token cross-entropy in float32. Under a model group that shards
    `vocab`, `logits` is the rank's block of the vocabulary: the
    log-sum-exp is a model-group max and sum, the target's logit a masked
    pick and a sum."""
    if vocab and TP.shards(vocab):
        g = TP.current()
        lf = logits.float()
        top = TP.all_max(lf.amax(-1))
        lse = torch.log(TP.reduce_from(
            torch.exp(lf - top[..., None]).sum(-1))) + top
        n = vocab // g.size
        local = targets.long() - g.index * n
        hit = (local >= 0) & (local < n)
        ll = lf.gather(-1, torch.where(hit, local, 0)[..., None])[..., 0]
        return lse - TP.reduce_from(torch.where(hit, ll, 0.0))
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - ll


def chunked_xent(params, cfg, hidden, targets, chunk):
    """Mean cross-entropy without materializing (B, S, V): the float32
    total of each `chunk` tokens, divided once by B·S, as the JAX scan
    does (under the fsdp layout by the worker's B·S·data: the rank's
    share); under autograd each chunk's logits are recomputed in the
    backward pass (`torch.utils.checkpoint`, the JAX package's
    `jax.checkpoint` of the scan body)."""
    B, S, _ = hidden.shape
    if S % chunk:
        raise ValueError(f"chunked_xent: S={S} is not a multiple of "
                         f"chunk={chunk}")

    def body(h, t):
        return _xent(logits_fn(params, cfg, h), t, cfg.vocab_size).sum()

    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, S, chunk):
        h = hidden[:, start:start + chunk]
        t = targets[:, start:start + chunk]
        tot = tot + (checkpoint(body, h, t, use_reentrant=False) if remat
                     else body(h, t))
    return tot / (B * S * FS.data_size())


def loss_fn(params, cfg, batch, generator=None):
    """batch: {"tokens": (B, S), "targets": (B, S)} integer, and
    "enc_embeds" (B, Se, d) for an encoder-decoder model. Returns
    (loss + Σ aux, {"loss": loss, **aux}). The chunked cross-entropy is
    taken when ``cfg.xent_chunk`` divides S.

    Under the fsdp layout (`parallel.fsdp`) the batch is the rank's rows
    of its worker's, and the loss and the router-z term are the rank's
    shares of the worker's (the shares sum to them over the data
    group); the load-balance term is the worker's."""
    del generator   # the LM's loss draws nothing
    params = FS.prepare(params)
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_out = (encode(params, cfg, batch["enc_embeds"]) if cfg.is_encdec
               else None)
    hidden, _, aux = forward(params, cfg, tokens, positions, enc_out=enc_out)
    if cfg.xent_chunk and tokens.shape[1] % cfg.xent_chunk == 0:
        loss = chunked_xent(params, cfg, hidden, batch["targets"],
                            cfg.xent_chunk)
    else:
        xe = _xent(logits_fn(params, cfg, hidden), batch["targets"],
                   cfg.vocab_size)
        d = FS.data_size()
        loss = xe.mean() if d == 1 else xe.sum() / (xe.numel() * d)
    metrics = {"loss": loss, **aux}
    total = loss + sum(aux.values()) if aux else loss
    return total, metrics


# ------------------------------------------------------------------------- #
# serving
# ------------------------------------------------------------------------- #
def init_cache(cfg, batch, seq, dtype=None, device=None):
    """Decode caches: a dense (or rolling) K/V cache per attention layer,
    a zero recurrent state per mixer layer, and a zero ``"enc_out"`` for
    an encoder-decoder model."""
    dtype = dtype or _dtype(cfg)
    period, n_scan = _n_scan(cfg)

    def one(kind):
        return block_cache_init(cfg, kind, batch, seq, dtype, device)

    caches = {"scan": None, "tail": []}
    if n_scan:
        caches["scan"] = {
            f"b{i}": _stack([one(cfg.layer_pattern[i])
                             for _ in range(n_scan)])
            for i in range(period)}
    for kind in pattern_kinds(cfg)[n_scan * period:]:
        caches["tail"].append(one(kind))
    if cfg.is_encdec:
        caches["enc_out"] = torch.zeros(
            (batch, cfg.encdec.enc_seq, cfg.d_model), dtype=dtype,
            device=device)
    return caches


def decode_step(params, cfg, tokens, caches):
    """tokens: (B, 1). Writes into caches; returns (logits (B, V), caches)."""
    t = _cache_pos(caches, cfg)
    if cfg.positional == "learned" and "pos" in params:
        # checked here, on the host: on CUDA an index past the table is a
        # device-side assert that leaves the context unusable
        n_pos = params["pos"].shape[0]
        if t >= n_pos:
            raise ValueError(f"decode_step: position {t} is past the learned "
                             f"position table ({n_pos} positions, init's "
                             f"max_seq)")
    positions = torch.full((1,), t, dtype=torch.int32, device=tokens.device)
    enc_out = caches.get("enc_out")
    hidden, new_caches, _ = forward(params, cfg, tokens, positions,
                                    caches=caches, enc_out=enc_out)
    if enc_out is not None:
        new_caches["enc_out"] = enc_out
    return _last_logits(params, cfg, hidden), new_caches


def decode_step_paged(params, cfg, tokens, caches, lengths):
    """Decode one token per row against a paged KV cache (repro_torch.serve).

    tokens: (B, 1); lengths: (B,) int32 on the device — each row's context
    length, which is its RoPE position, its KV write position and its
    attention bound. Returns (logits (B, V), caches)."""
    positions = lengths[:, None]
    hidden, new_caches, _ = forward(params, cfg, tokens, positions,
                                    caches=caches)
    return logits_fn(params, cfg, hidden[:, -1]), new_caches


def prefill(params, cfg, tokens, enc_embeds=None, max_len: int = 0,
            kv_layout: str = "hd_model"):
    """Run the whole prompt in one pass; return (last_logits, decode-ready
    caches): attention K/V in cache layout, each mixer's final state, and
    the encoder output of an encoder-decoder model (from `enc_embeds`).
    max_len > prompt length reserves decode positions in global-attention
    caches (rolling-window caches are fixed-size). Under a model group
    the caches are the rank's part, K/V split as `kv_layout` says."""
    if kv_layout not in ("hd_model", "seq_model"):
        raise ValueError(f"kv_layout must be hd_model|seq_model, got "
                         f"{kv_layout!r}")
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    enc_out = encode(params, cfg, enc_embeds) if cfg.is_encdec else None
    hidden, caches, _ = forward(params, cfg, tokens, positions,
                                enc_out=enc_out,
                                fill_cache=(kv_layout, max_len))
    if cfg.is_encdec:
        caches["enc_out"] = enc_out
    return _last_logits(params, cfg, hidden), caches


def _cache_pos(caches, cfg) -> int:
    """The decode position of a dense cache: its first attention layer's
    "pos", or 0 for a purely recurrent model (which tracks none)."""
    del cfg
    if caches.get("scan") is not None:
        for v in caches["scan"].values():
            if isinstance(v, dict) and "pos" in v:
                return int(v["pos"][0] if v["pos"].ndim else v["pos"])
    for v in caches.get("tail") or []:
        if isinstance(v, dict) and "pos" in v:
            return int(v["pos"])
    return 0
