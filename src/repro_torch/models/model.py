"""The decoder LM (counterpart of `repro.models.model`): a cycled pattern
of attention blocks, each with a dense MLP or an MoE FFN
(`repro_torch.models.moe`), the chunked cross-entropy, and the prefill
and decode of the serving engine.

    init(cfg, generator=, device=)               -> params
    forward(params, cfg, tokens, positions, ...) -> (hidden, caches, aux)
    loss_fn(params, cfg, batch)                  -> (total, metrics)
    prefill(params, cfg, tokens, max_len=)       -> (logits_last, caches)
    decode_step(params, cfg, tokens, caches)     -> (logits, caches)
    decode_step_paged(params, cfg, tokens, caches, lengths)
    init_cache(cfg, batch, seq, dtype, device)   -> cache tree

Parameters keep the JAX package's tree: layers stacked along a leading
axis under ``params["scan"]`` (one entry ``"b{i}"`` per position of the
layer pattern), unscanned layers in the list ``params["tail"]``, so that
weights cross over by copy (`repro_torch.convert`). `_stack_apply` loops
over the stacked axis in Python where the JAX package scans; in training
each period runs under `torch.utils.checkpoint` when ``cfg.remat`` asks
for it (the JAX package's `jax.checkpoint` of the scan body), and the
MoE router's aux losses are summed over the layers. Gradients of the
per-layer views land on the stacked leaves.

`loss_fn` returns the cross-entropy plus the aux losses, and the metrics
{"loss", **aux}; `chunked_xent` takes the logits ``xent_chunk`` tokens at
a time, each chunk recomputed in the backward pass, so that one (B,
chunk, V) block of logits is alive at a time.

Caches keep the JAX tree too ({"scan": ..., "tail": [...]}); decode
writes into their tensors in place and returns the same tree. A dense
cache's ``"pos"`` is a CPU int32 tensor (host state: reading it needs no
device sync); the paged cache has none, its positions come in
`decode_step_paged`'s `lengths`.

Not ported yet, and refused by name: the encoder (`encode`) and the
RG-LRU and SSD mixers (ROADMAP §A slice 6).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as T

from . import moe as moe_lib
from .layers import (
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


def check_supported(cfg) -> None:
    """Refuse what the port's LM does not build yet, naming its slice."""
    missing = sorted(set(pattern_kinds(cfg)) - {"attn"})
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {'/'.join(missing)} blocks (the RG-LRU and SSD "
            f"mixers) arrive with ROADMAP §A slice 6 (LM zoo)")
    if cfg.is_encdec or cfg.embedding_inputs:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder models arrive with ROADMAP §A "
            f"slice 6 (LM zoo: encoder-decoder)")


# ------------------------------------------------------------------------- #
# single block
# ------------------------------------------------------------------------- #
def block_init(cfg, kind: str, *, generator=None, device=None):
    if kind != "attn":
        raise NotImplementedError(
            f"{kind} blocks (the RG-LRU and SSD mixers) arrive with ROADMAP "
            f"§A slice 6 (LM zoo)")
    kw = dict(device=device, dtype=_dtype(cfg))
    d = cfg.d_model
    p = {"norm1": norm_init(cfg.norm, d, **kw),
         "attn": attn_init(d, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                           cfg.use_bias, generator=generator, **kw)}
    if cfg.d_ff > 0 or cfg.moe is not None:
        p["norm2"] = norm_init(cfg.norm, d, **kw)
        if cfg.moe is not None:
            p["moe"] = moe_lib.moe_init(cfg, generator=generator, **kw)
        else:
            p["mlp"] = mlp_init(d, cfg.d_ff, cfg.activation, cfg.use_bias,
                                generator=generator, **kw)
    return p


def block_apply(p, cfg, kind, x, positions, cache=None, fill_cache=False):
    """Returns (x, new_cache, aux_losses): the MoE router's losses, or {}."""
    aux = {}
    h = apply_norm(cfg.norm, p["norm1"], x)
    out, new_cache = attn_apply(p["attn"], h, cfg, positions, cache=cache,
                                fill_cache=fill_cache)
    x = x + out
    if "mlp" in p:
        x = x + mlp(p["mlp"], apply_norm(cfg.norm, p["norm2"], x),
                    cfg.activation)
    elif "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"], cfg,
                                   apply_norm(cfg.norm, p["norm2"], x))
        x = x + y
    return x, new_cache, aux


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
    params['scan']['b{i}'] has shape (n_periods, ...)."""
    del max_seq  # only absolute-position models need it (not ported)
    check_supported(cfg)
    dt = _dtype(cfg)
    kinds = pattern_kinds(cfg)
    period, n_scan = _n_scan(cfg)
    kw = dict(generator=generator, device=device, dtype=dt)
    p: dict = {"embed": embed_init(cfg.vocab_size, cfg.d_model, **kw)}
    if not cfg.tie_embeddings:
        p["unembed"] = {"w": embed_init(cfg.d_model, cfg.vocab_size, **kw)}
    p["final_norm"] = norm_init(cfg.norm, cfg.d_model, device=device,
                                dtype=dt)
    if n_scan:
        p["scan"] = {
            f"b{i}": _stack([block_init(cfg, cfg.layer_pattern[i],
                                        generator=generator, device=device)
                             for _ in range(n_scan)])
            for i in range(period)}
    tail_kinds = kinds[n_scan * period:]
    if tail_kinds:
        p["tail"] = [block_init(cfg, kind, generator=generator,
                                device=device) for kind in tail_kinds]
    return p


# ------------------------------------------------------------------------- #
# forward over the block stack
# ------------------------------------------------------------------------- #
def _stack_apply(params, cfg, x, positions, caches=None, fill_cache=False):
    """Run all layers. Three modes:
      train   : caches=None, fill_cache=False  (remat'd periods, aux summed)
      prefill : caches=None, fill_cache=True   (caches stacked per layer)
      decode  : caches=tree                     (updated in place)
    Returns (x, new_caches, aux)."""
    period, n_scan = _n_scan(cfg)
    train = caches is None and not fill_cache
    aux_total = {}

    def add_aux(aux):
        for k, v in aux.items():
            aux_total[k] = aux_total.get(k, 0.0) + v

    def period_fn(x, layer_p, layer_c):
        lc, aux_p = {}, {}
        for i in range(period):
            x, lc[f"b{i}"], aux = block_apply(
                layer_p[f"b{i}"], cfg, cfg.layer_pattern[i], x, positions,
                cache=None if layer_c is None else layer_c[f"b{i}"],
                fill_cache=fill_cache)
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
        x, nc, aux = block_apply(bp, cfg, kind, x, positions, cache=c,
                                 fill_cache=fill_cache)
        add_aux(aux)
        new_caches["tail"].append(nc)
    if train:
        new_caches = None
    return x, new_caches, aux_total


def _embed_tokens(params, cfg, tokens, positions):
    del positions  # learned absolute positions are not ported
    # F.embedding's backward sums a token's rows in a fixed order on CUDA
    x = F.embedding(tokens, params["embed"])
    # the JAX package multiplies by a weakly typed Python float, which
    # takes the activation's dtype: round the factor the same way
    scale = float(torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype))
    return (x * scale).to(_dtype(cfg))


def forward(params, cfg, tokens, positions, caches=None, fill_cache=False):
    """tokens: (B, S) integer. Returns (hidden, new_caches, aux)."""
    x = _embed_tokens(params, cfg, tokens, positions)
    x, new_caches, aux = _stack_apply(params, cfg, x, positions, caches,
                                      fill_cache=fill_cache)
    x = apply_norm(cfg.norm, params["final_norm"], x)
    return x, new_caches, aux


def logits_fn(params, cfg, hidden):
    if cfg.tie_embeddings:
        return hidden @ params["embed"].T
    return linear(params["unembed"], hidden)


# ------------------------------------------------------------------------- #
# losses
# ------------------------------------------------------------------------- #
def _xent(logits, targets):
    """Per-token cross-entropy in float32."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, targets.long()[..., None])[..., 0]
    return lse - ll


def chunked_xent(params, cfg, hidden, targets, chunk):
    """Mean cross-entropy without materializing (B, S, V): the float32
    total of each `chunk` tokens, divided once by B·S, as the JAX scan
    does; under autograd each chunk's logits are recomputed in the
    backward pass (`torch.utils.checkpoint`, the JAX package's
    `jax.checkpoint` of the scan body)."""
    B, S, _ = hidden.shape
    if S % chunk:
        raise ValueError(f"chunked_xent: S={S} is not a multiple of "
                         f"chunk={chunk}")

    def body(h, t):
        return _xent(logits_fn(params, cfg, h), t).sum()

    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for start in range(0, S, chunk):
        h = hidden[:, start:start + chunk]
        t = targets[:, start:start + chunk]
        tot = tot + (checkpoint(body, h, t, use_reentrant=False) if remat
                     else body(h, t))
    return tot / (B * S)


def loss_fn(params, cfg, batch, generator=None):
    """batch: {"tokens": (B, S), "targets": (B, S)} integer. Returns
    (loss + Σ aux, {"loss": loss, **aux}). The chunked cross-entropy is
    taken when ``cfg.xent_chunk`` divides S."""
    del generator   # the LM's loss draws nothing
    if cfg.is_encdec:
        encode()
    tokens = batch["tokens"]
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    hidden, _, aux = forward(params, cfg, tokens, positions)
    if cfg.xent_chunk and tokens.shape[1] % cfg.xent_chunk == 0:
        loss = chunked_xent(params, cfg, hidden, batch["targets"],
                            cfg.xent_chunk)
    else:
        loss = _xent(logits_fn(params, cfg, hidden), batch["targets"]).mean()
    metrics = {"loss": loss, **aux}
    total = loss + sum(aux.values()) if aux else loss
    return total, metrics


def encode(*_, **__):
    raise NotImplementedError(
        "the encoder of encoder-decoder models arrives with ROADMAP §A slice "
        "6 (LM zoo: encoder-decoder)")


# ------------------------------------------------------------------------- #
# serving
# ------------------------------------------------------------------------- #
def init_cache(cfg, batch, seq, dtype=None, device=None):
    check_supported(cfg)
    dtype = dtype or _dtype(cfg)
    period, n_scan = _n_scan(cfg)
    caches = {"scan": None, "tail": []}
    if n_scan:
        caches["scan"] = {
            f"b{i}": _stack([attn_cache_init(cfg, batch, seq, dtype, device)
                             for _ in range(n_scan)])
            for i in range(period)}
    for _ in pattern_kinds(cfg)[n_scan * period:]:
        caches["tail"].append(attn_cache_init(cfg, batch, seq, dtype, device))
    return caches


def decode_step(params, cfg, tokens, caches):
    """tokens: (B, 1). Writes into caches; returns (logits (B, V), caches)."""
    t = _cache_pos(caches, cfg)
    positions = torch.full((1,), t, dtype=torch.int32, device=tokens.device)
    hidden, new_caches, _ = forward(params, cfg, tokens, positions,
                                    caches=caches)
    return logits_fn(params, cfg, hidden[:, -1]), new_caches


def decode_step_paged(params, cfg, tokens, caches, lengths):
    """Decode one token per row against a paged KV cache (repro_torch.serve).

    tokens: (B, 1); lengths: (B,) int32 on the device — each row's context
    length, which is its RoPE position, its KV write position and its
    attention bound. Returns (logits (B, V), caches)."""
    positions = lengths[:, None]
    hidden, new_caches, _ = forward(params, cfg, tokens, positions,
                                    caches=caches)
    return logits_fn(params, cfg, hidden[:, -1]), new_caches


def prefill(params, cfg, tokens, enc_embeds=None, max_len: int = 0):
    """Run the whole prompt in one pass; return (last_logits, decode-ready
    caches). max_len > prompt length reserves decode positions in
    global-attention caches (rolling-window caches are fixed-size)."""
    if enc_embeds is not None:
        encode()
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    hidden, caches, _ = forward(params, cfg, tokens, positions,
                                fill_cache=True)
    if max_len > tokens.shape[1] and cfg.attention_window == 0:
        caches = _pad_attn_caches(caches, max_len)
    return logits_fn(params, cfg, hidden[:, -1]), caches


def _pad_attn_caches(caches, max_len):
    def pad(sub):
        if isinstance(sub, dict):
            if "k" in sub and "pos" in sub:
                extra = max_len - sub["k"].shape[-3]
                if extra > 0:
                    widths = (0, 0, 0, 0, 0, extra)   # the sequence axis
                    sub = dict(sub, k=F.pad(sub["k"], widths),
                               v=F.pad(sub["v"], widths))
                return sub
            return {k: pad(v) for k, v in sub.items()}
        if isinstance(sub, list):
            return [pad(v) for v in sub]
        return sub

    return pad(caches)


def _cache_pos(caches, cfg) -> int:
    del cfg
    if caches.get("scan") is not None:
        for v in caches["scan"].values():
            if isinstance(v, dict) and "pos" in v:
                return int(v["pos"][0] if v["pos"].ndim else v["pos"])
    for v in caches.get("tail") or []:
        if isinstance(v, dict) and "pos" in v:
            return int(v["pos"])
    return 0
