"""The plain reference of one DQGAN worker's training steps, in float32.

It follows what a configuration states and nothing of the program under
test: the optimistic mirror-descent step of the DQGAN paper (Algorithm 2,
one worker, the message eta * g), the gradient quantized to int8 with error
feedback in blocks of 1024 elements, and parameters stored in the
configuration's `param_dtype` (bfloat16: every update rounds the stored
weight). The arithmetic is float32 with TF32 off; `compute="fp8"` rounds
the operands of every linear layer to float8 e4m3 instead (the control).

The quantizer's blocks run over the flat gradient packed bucket by bucket
(the greedy 4 MiB layout below, a frozen copy of the rule the strategy
names), so that a block holds the same elements on both sides, and the
uniform draws are the benchmark's own, handed to both.

Imports nothing but torch.
"""
from __future__ import annotations

import math

import torch

BLOCK = 1024
CHUNK = 1 << 26     # elements a piece, where a pass would need big temporaries


# --------------------------------------------------------------------------- #
# precision
# --------------------------------------------------------------------------- #
def set_float32_exact():
    """float32 matmuls and convolutions without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def storage_dtype(name):
    return _DTYPES[name]


def fp8_round(t):
    """t with its values rounded to float8 e4m3 under one per-tensor scale
    (amax to 448), the rounding passed straight through in the backward."""
    amax = t.detach().abs().amax().clamp(min=1e-30)
    s = 448.0 / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).float() / s
    return t + (q - t.detach())


def linear(x, w, b=None, compute="f32"):
    if compute == "fp8":
        x, w = fp8_round(x), fp8_round(w)
    y = x @ w
    return y if b is None else y + b


def rms_norm(x, scale, eps=1e-6):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x, scale, bias, eps=1e-6):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def silu(x):
    return x * torch.sigmoid(x)


def cross_entropy(logits, targets):
    """Mean token cross-entropy, float32."""
    logits = logits.reshape(-1, logits.shape[-1])
    return torch.nn.functional.cross_entropy(logits, targets.reshape(-1))


# --------------------------------------------------------------------------- #
# the comm layout: greedy first fit in the parameters' sorted-path order
# --------------------------------------------------------------------------- #
def bucket_layout(shapes, bucket_bytes=4 << 20, align=BLOCK):
    """[(paths, padded size)] of the flat buckets over {path: shape}, paths
    (tuples) in sorted order: a leaf joins the open bucket unless that
    would pass `bucket_bytes` of float32, and each bucket is padded to a
    multiple of `align`."""
    cap = max(1, bucket_bytes // 4)
    out, cur, used = [], [], 0
    for p in sorted(shapes):
        n = math.prod(shapes[p])
        if used and used + n > cap:
            out.append((cur, -(-used // align) * align))
            cur, used = [], 0
        cur.append(p)
        used += n
    if cur:
        out.append((cur, -(-used // align) * align))
    return out


def pack(layout, tree, total, device):
    """One flat float32 buffer of the leaves of `tree`, bucket by bucket,
    zero-padded."""
    flat = torch.zeros(total, dtype=torch.float32, device=device)
    off = 0
    for paths, size in layout:
        o = off
        for p in paths:
            n = tree[p].numel()
            flat[o:o + n] = tree[p].reshape(-1)
            o += n
        off += size
    return flat


def unpack(layout, flat, shapes):
    """{path: view of `flat`} at the leaves' shapes."""
    out, off = {}, 0
    for paths, size in layout:
        o = off
        for p in paths:
            n = math.prod(shapes[p])
            out[p] = flat[o:o + n].view(shapes[p])
            o += n
        off += size
    return out


def layout_total(layout):
    return sum(size for _, size in layout)


# --------------------------------------------------------------------------- #
# int8 quantization with error feedback
# --------------------------------------------------------------------------- #
def quantize_ef_(m, rand, levels):
    """In place over the flat buffer m (the message plus the residual),
    blocks of 1024: scale = max|m| + 1e-20, codes = floor(m / scale * L)
    + (rand < frac), q = codes * (scale / L). m becomes q; returns the
    residual m - q (a new buffer)."""
    e = torch.empty_like(m)
    lvl = torch.tensor(float(levels), dtype=torch.float32, device=m.device)
    for a in range(0, m.numel(), CHUNK):
        b = min(m.numel(), a + CHUNK)
        mb = m[a:b].view(-1, BLOCK)
        rb = rand[a:b].view(-1, BLOCK)
        scale = mb.abs().amax(dim=1, keepdim=True) + 1e-20
        lv = mb / scale * lvl
        low = torch.floor(lv)
        codes = low + (rb < (lv - low)).float()
        q = codes * (scale / lvl)
        e[a:b] = (mb - q).view(-1)
        m[a:b] = q.view(-1)
    return e


# --------------------------------------------------------------------------- #
# what the comparison reads
# --------------------------------------------------------------------------- #
def leaf_norm(x):
    return float(torch.linalg.vector_norm(x.float().reshape(-1)))


PROBES = 4     # seeded normal probes a leaf


def leaf_sketch(x, generator, probes=PROBES):
    """[<x, r_j>] for `probes` standard normal r_j from `generator`, each
    drawn in pieces of CHUNK elements (the same pieces on both sides)."""
    flat = x.reshape(-1)
    out = []
    for _ in range(probes):
        tot = torch.zeros((), dtype=torch.float64, device=x.device)
        for a in range(0, flat.numel(), CHUNK):
            b = min(flat.numel(), a + CHUNK)
            r = torch.randn(b - a, generator=generator, device=x.device,
                            dtype=torch.float32)
            tot += (flat[a:b].float() * r).sum(dtype=torch.float64)
        out.append(float(tot))
    return out


def probe_generator(seed, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def readings_of(tree, probe_seed, sketch=True):
    """{path: (norm, [sketches] or None)} of a tree of tensors, the probes
    drawn in sorted-path order from one generator."""
    out = {}
    g = None
    for p in sorted(tree):
        x = tree[p]
        if sketch and g is None:
            g = probe_generator(probe_seed, x.device)
        out[".".join(p)] = (leaf_norm(x), leaf_sketch(x, g) if sketch
                            else None)
    return out


# --------------------------------------------------------------------------- #
# the training steps
# --------------------------------------------------------------------------- #
def follow(model, cfg, weights, batches, draws, steps, lr, levels,
           probe_seed, compute="f32", half_batch=False, bucket_bytes=4 << 20):
    """`steps` DQGAN steps of one worker from `weights` ({path: tensor}, as
    stored), on `batches` (one a step) and `draws` (a function of the
    step: the flat uniform draws over the packed buffer). Returns
    {"loss": [...], "grad": readings of the first gradient, "change":
    readings of the parameters' change over the steps, "ef": norms of the
    residuals after them}.

    OMD, local extrapolation, the message eta * g (the paper's Algorithm
    2 with one worker):
        w_half = w - (eta * g_prev + e)
        g      = grad loss(w_half)
        q, e   = Q(eta * g + e)
        w      = w - q
    with w, w_half and g_prev stored in each leaf's dtype (the
    configuration's parameter dtype) and e in float32; the model computes
    in float32."""
    set_float32_exact()
    pdt = storage_dtype(cfg["param_dtype"])
    paths = sorted(weights)
    shapes = {p: tuple(weights[p].shape) for p in paths}
    device = weights[paths[0]].device
    layout = bucket_layout(shapes, bucket_bytes)
    total = layout_total(layout)

    def stored(x, p):
        # each leaf keeps its own dtype (a float32 leaf in a bfloat16 tree)
        return x.to(weights[p].dtype)

    w0 = {p: weights[p] for p in paths}             # as stored
    w = dict(w0)
    g_prev = None
    e_flat = torch.zeros(total, dtype=torch.float32, device=device)
    losses, out = [], {}
    for t in range(steps):
        e_leaf = unpack(layout, e_flat, shapes)
        if g_prev is None:
            w_half = w
        else:
            w_half = {p: stored(w[p].float() - (lr * g_prev[p].float()
                                                + e_leaf[p]), p)
                      for p in paths}
        batch = batches[t]
        if half_batch:
            batch = halve(batch)
        loss, grads = model.loss_and_grads(w_half, cfg, batch, compute)
        del w_half
        losses.append(float(loss))
        if t == 0:
            out["grad"] = readings_of(grads, probe_seed)
        m = pack(layout, {p: lr * grads[p] for p in paths}, total, device)
        m += e_flat
        e_flat = quantize_ef_(m, draws(t), levels)
        q = unpack(layout, m, shapes)
        w = {p: stored(w[p].float() - q[p], p) for p in paths}
        g_prev = {p: stored(grads[p], p) for p in paths}
        del m, q, grads
    out["loss"] = losses
    out["change"] = readings_of({p: w[p] - w0[p].float() for p in paths},
                                probe_seed + 1)
    out["ef"] = readings_of(unpack(layout, e_flat, shapes), 0, sketch=False)
    return out


def halve(batch):
    """The batch's first half: half the rows, or of one row half the
    positions."""
    B, S = batch["tokens"].shape
    if B > 1:
        return {k: v[:B // 2] for k, v in batch.items()}
    return {k: v[:, :S // 2] for k, v in batch.items()}
