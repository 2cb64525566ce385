"""Plain reference of a dense decoder LM of the StarCoder2 family
(arXiv:2402.19173), float32: pre-norm blocks of grouped-query attention
with rotary positions and a non-gated tanh-GELU MLP, LayerNorm, biases on
every projection, the mean token cross-entropy.

Departures from the published model, as the repo's model has them: the
embedding is multiplied by sqrt(d_model), the norms take eps 1e-6, RoPE
rotates the two halves of a head (not interleaved pairs). The unembedding
is a matrix of its own, or the embedding's transpose where the
configuration ties them.

The parameters are a flat {path: tensor} dict whose paths and shapes are
the layout the benchmark hands to both sides (layers stacked on a leading
axis under ("scan", "b0")). Imports nothing but torch and the reference's
own helpers.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from . import common as C

PREFIX = ("scan", "b0")


def spec(m):
    """[(path, shape, dtype, init)] of the parameters of model config `m`
    (the config file's "model" object). init: ("normal", std), ("ones",),
    ("zeros",)."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    H, K, hd, ff = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]
    dt = m["param_dtype"]
    out = [(("embed",), (V, d), dt, ("normal", 1 / math.sqrt(d))),
           (("final_norm", "scale"), (d,), dt, ("ones",)),
           (("final_norm", "bias"), (d,), dt, ("zeros",))]
    if not m["tie_embeddings"]:
        out.insert(1, (("unembed", "w"), (d, V), dt,
                       ("normal", 1 / math.sqrt(d))))

    def lin(name, d_in, d_out):
        out.append((PREFIX + name + ("w",), (L, d_in, d_out), dt,
                    ("normal", 1 / math.sqrt(d_in))))
        out.append((PREFIX + name + ("b",), (L, d_out), dt, ("zeros",)))

    for n in ("norm1", "norm2"):
        out.append((PREFIX + (n, "scale"), (L, d), dt, ("ones",)))
        out.append((PREFIX + (n, "bias"), (L, d), dt, ("zeros",)))
    lin(("attn", "q"), d, H * hd)
    lin(("attn", "k"), d, K * hd)
    lin(("attn", "v"), d, K * hd)
    lin(("attn", "o"), H * hd, d)
    lin(("mlp", "up"), d, ff)
    lin(("mlp", "down"), ff, d)
    return out


def rope(x, theta):
    """x (B, S, H, hd): each head's two halves rotated by position."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def block(x, p, m, compute):
    """One pre-norm block; p holds the layer's tensors by short name."""
    B, S, d = x.shape
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    h = C.layer_norm(x, p["norm1.scale"], p["norm1.bias"])
    q = C.linear(h, p["q.w"], p["q.b"], compute).view(B, S, H, hd)
    k = C.linear(h, p["k.w"], p["k.b"], compute).view(B, S, K, hd)
    v = C.linear(h, p["v.w"], p["v.b"], compute).view(B, S, K, hd)
    q, k = rope(q, m["rope_theta"]), rope(k, m["rope_theta"])
    g = H // K
    q = q.view(B, S, K, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k) / math.sqrt(hd)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~mask, float("-inf"))
    a = torch.einsum("bkgqs,bskd->bqkgd", torch.softmax(s, dim=-1), v)
    x = x + C.linear(a.reshape(B, S, H * hd), p["o.w"], p["o.b"], compute)
    h = C.layer_norm(x, p["norm2.scale"], p["norm2.bias"])
    h = C.gelu_tanh(C.linear(h, p["up.w"], p["up.b"], compute))
    return x + C.linear(h, p["down.w"], p["down.b"], compute)


_SHORT = {("attn", "q"): "q", ("attn", "k"): "k", ("attn", "v"): "v",
          ("attn", "o"): "o", ("mlp", "up"): "up", ("mlp", "down"): "down"}


def _layer(w, i):
    p = {}
    for path, t in w.items():
        if path[:2] != PREFIX:
            continue
        rest = path[2:]
        name = (_SHORT[rest[:2]] + "." + rest[2] if rest[:2] in _SHORT
                else ".".join(rest))
        p[name] = t[i]
    return p


def loss(w, m, batch, compute="f32"):
    tokens, targets = batch["tokens"], batch["targets"]
    x = w[("embed",)][tokens] * math.sqrt(m["d_model"])
    for i in range(m["num_layers"]):
        x = checkpoint(block, x, _layer(w, i), m, compute,
                       use_reentrant=False)
    x = C.layer_norm(x, w[("final_norm", "scale")], w[("final_norm", "bias")])
    head = (w[("embed",)].T if m["tie_embeddings"]
            else w[("unembed", "w")])
    logits = C.linear(x, head, None, compute)
    return C.cross_entropy(logits, targets)


def loss_and_grads(weights, m, batch, compute="f32"):
    """(loss, {path: float32 gradient}) at `weights` (any dtype; computed
    in float32)."""
    w = {p: t.detach().to(torch.float32, copy=True).requires_grad_()
         for p, t in weights.items()}
    with torch.enable_grad():
        total = loss(w, m, batch, compute)
        paths = list(w)
        grads = torch.autograd.grad(total, [w[p] for p in paths])
    return total.detach(), dict(zip(paths, grads))
