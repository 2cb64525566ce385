"""Plain reference of a Mamba-2 LM (arXiv:2405.21060), float32: pre-norm
blocks of the SSD mixer alone (no MLP), RMSNorm, the mean token
cross-entropy. The unembedding is a matrix of its own, or the embedding's
transpose where the configuration ties them (the released checkpoint
does).

A block: z, x, B, C and dt projected from the normed input (B and C one
group, shared by every head), dt = softplus(dt + dt_bias), a causal
depthwise convolution over [x | B | C] then SiLU, the SSD scan with
A = -exp(A_log) and the skip D x, the gated RMSNorm of y * silu(z), the
out projection. The scan is the paper's chunked form (its listing
"ssd_minimal_discrete"): within a chunk the segment sums of A dt are
masked to -inf above the diagonal before the exponential, so exp is taken
only under the causal mask; the chunk states are carried by the same
segment-sum decay across chunks.

Departures from the published model, as the repo's model has them: the
embedding is multiplied by sqrt(d_model), the norms take eps 1e-6, the
projections are separate matrices (the published in_proj concatenates
them).

Imports nothing but torch and the reference's own helpers.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import common as C

PREFIX = ("scan", "b0")


def dims(m):
    s = m["ssm"]
    di = s["expand"] * m["d_model"]
    return s, di, di // s["head_dim"]


def spec(m):
    """[(path, shape, dtype, init)] of the parameters of model config `m`.
    init: ("normal", std), ("ones",), ("zeros",), ("log_uniform", lo, hi)
    (log of U(lo, hi)), ("dt_bias", lo, hi) (softplus^-1 of a dt drawn
    log-uniform in [lo, hi])."""
    d, L, V = m["d_model"], m["num_layers"], m["vocab_size"]
    s, di, nh = dims(m)
    N, cw = s["state_dim"], s["conv_width"]
    dt = m["param_dtype"]
    conv = di + 2 * N
    ssd = PREFIX + ("ssd",)
    out = [(("embed",), (V, d), dt, ("normal", 1 / math.sqrt(d))),
           (("final_norm", "scale"), (d,), dt, ("ones",)),
           (PREFIX + ("norm1", "scale"), (L, d), dt, ("ones",))]
    if not m["tie_embeddings"]:
        out.insert(1, (("unembed", "w"), (d, V), dt,
                       ("normal", 1 / math.sqrt(d))))
    for name, n_out in (("z", di), ("x", di), ("B", N), ("C", N),
                        ("dt", nh)):
        out.append((ssd + (name, "w"), (L, d, n_out), dt,
                    ("normal", 1 / math.sqrt(d))))
    out += [(ssd + ("dt_bias",), (L, nh), dt, ("dt_bias", 1e-3, 1e-1)),
            (ssd + ("A_log",), (L, nh), "float32", ("log_uniform", 1.0, 16.0)),
            (ssd + ("D",), (L, nh), dt, ("ones",)),
            (ssd + ("conv", "w"), (L, cw, conv), dt,
             ("normal", 1 / math.sqrt(cw))),
            (ssd + ("conv", "b"), (L, conv), dt, ("zeros",)),
            (ssd + ("norm", "scale"), (L, di), dt, ("ones",)),
            (ssd + ("out", "w"), (L, di, d), dt,
             ("normal", 1 / math.sqrt(di)))]
    return out


def segsum(a):
    """a (..., T) -> (..., T, T): out[i, j] = sum of a[j+1..i] for j <= i,
    -inf above the diagonal."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)
    low = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~low, 0.0)
    x = torch.cumsum(x, dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return x.masked_fill(~keep, float("-inf"))


def ssd_scan(X, A, Bm, Cm, chunk):
    """X (b, T, h, p) the inputs times dt, A (b, T, h) the log decays A dt,
    Bm and Cm (b, T, n). Returns Y (b, T, h, p)."""
    b, T, h, p = X.shape
    c = T // chunk
    X = X.view(b, c, chunk, h, p)
    Bc = Bm.view(b, c, chunk, -1)
    Cc = Cm.view(b, c, chunk, -1)
    A = A.view(b, c, chunk, h).permute(0, 3, 1, 2)          # (b, h, c, l)
    A_cum = torch.cumsum(A, dim=-1)
    Lmat = torch.exp(segsum(A))                             # (b, h, c, l, s)
    G = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    Y_diag = torch.einsum("bhcls,bcshp->bclhp", G[:, None] * Lmat, X)
    decay = torch.exp(A_cum[..., -1:] - A_cum)              # (b, h, c, l)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    Y_off = torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(A_cum))
    return (Y_diag + Y_off).reshape(b, T, h, p)


def block(x, p, m, compute):
    B, T, d = x.shape
    s, di, nh = dims(m)
    N, P = s["state_dim"], s["head_dim"]
    u = C.rms_norm(x, p["norm1.scale"])
    z = C.linear(u, p["z.w"], None, compute)
    xs = C.linear(u, p["x.w"], None, compute)
    Bm = C.linear(u, p["B.w"], None, compute)
    Cm = C.linear(u, p["C.w"], None, compute)
    dt = F.softplus(C.linear(u, p["dt.w"], None, compute) + p["dt_bias"])
    xBC = torch.cat([xs, Bm, Cm], dim=-1)
    w, cw = p["conv.w"], s["conv_width"]
    pad = F.pad(xBC, (0, 0, cw - 1, 0))
    conv = sum(pad[:, i:i + T] * w[i] for i in range(cw)) + p["conv.b"]
    conv = C.silu(conv)
    xs, Bm, Cm = conv[..., :di], conv[..., di:di + N], conv[..., di + N:]
    A = -torch.exp(p["A_log"])
    xh = xs.view(B, T, nh, P)
    y = ssd_scan(xh * dt[..., None], A * dt, Bm, Cm, s["chunk_size"])
    y = y + p["D"][:, None] * xh
    y = C.rms_norm(y.reshape(B, T, di) * C.silu(z), p["norm.scale"])
    return x + C.linear(y, p["out.w"], None, compute)


def _layer(w, i):
    p = {}
    for path, t in w.items():
        if path[:2] != PREFIX:
            continue
        rest = path[2:]
        name = ".".join(rest[1:] if rest[0] == "ssd" else rest)
        p[name] = t[i]
    return p


def loss(w, m, batch, compute="f32"):
    tokens, targets = batch["tokens"], batch["targets"]
    x = w[("embed",)][tokens] * math.sqrt(m["d_model"])
    for i in range(m["num_layers"]):
        x = checkpoint(block, x, _layer(w, i), m, compute,
                       use_reentrant=False)
    x = C.rms_norm(x, w[("final_norm", "scale")])
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
