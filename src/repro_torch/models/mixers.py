"""Sequence mixers beyond attention (counterpart of `repro.models.mixers`):
the Mamba2 SSD mixer and the RG-LRU recurrent block of RecurrentGemma /
Griffin, each over a full sequence (train and prefill) and as an O(1)
decode step against a state.

The JAX package runs both as XLA programs and calls no Pallas kernel:
  * the SSD is the chunked form (state-space duality). On CUDA tensors it
    is kernel set B5 (`kernels.ssd`, hand-written, forward and backward:
    no (L, L) block of a head in device memory, the recurrence over chunks
    one small kernel); on the CPU and the meta device its plain version
    (`kernels.ref.ssd_chunked_ref`): intra-chunk work as batched products
    over (L, L) blocks, and the inter-chunk state a Python loop over the
    ``T / chunk_size`` chunks (the JAX package's `lax.scan`);
  * the RG-LRU's linear recurrence h_t = a_t h_{t-1} + b_t is
    `associative_scan`, the odd/even recursion of
    `jax.lax.associative_scan` (log-depth: about 2 log2 T levels of
    batched ops, not T steps).

A decode step writes its new state into the state tensors it was given
(``copy_``) and returns that dict: the decode of `models.model` walks
views of a layer-stacked cache, so a fresh tensor would be lost.

Under a model group (`parallel.tensor`, the trainer's 'model' axis, by
`parallel.sharding`'s rules: z, x, B, C, dt, in_x, in_gate, W_a and W_i
column-parallel, `out` row-parallel, the rest replicated) the mixers
run on the rank's shards, over a full sequence (train, prefill) and as a
decode step: the SSD on its heads with B and C gathered whole (`_ssd_tp`),
the RG-LRU on its channels with the gates' input gathered (`_rglru_tp`).
A rank's state is its part of the reference's (`parallel.sharding.
cache_spec`): the SSD's h on its heads (B, H / size, P, N), the RG-LRU's
h and conv buffer on its channels, and the SSD's conv buffer the rank's
[x_r | B_r | C_r] channels (`parallel.sharding.shard_cache`). The math is
the one-device math; only its layout and the order of a few sums
change.

Activations follow the reference in bfloat16: `layers._silu` for
`jax.nn.silu` and `layers._gelu_tanh` for `jax.nn.gelu(approximate=True)`,
op by op in the activation's dtype. ``A_log`` and the RG-LRU's ``lam``
are float32 leaves in a bfloat16 tree, as in the JAX package.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ssd as SSD
from repro_torch.parallel import tensor as TP

from .layers import (_gelu_tanh, _randn, _silu, apply_norm, linear,
                     linear_init, row_linear)


# ------------------------------------------------------------------------- #
# causal depthwise conv1d (shared by SSD and RG-LRU)
# ------------------------------------------------------------------------- #
def conv1d_init(channels, width, *, generator=None, device=None,
                dtype=torch.float32):
    return {"w": (_randn((width, channels), generator, device)
                  / math.sqrt(width)).to(dtype),
            "b": torch.zeros((channels,), dtype=dtype, device=device)}


def causal_conv1d(p, x):
    """x: (B, T, C) -> (B, T, C), causal, depthwise; the taps summed in
    the reference's order."""
    width, T = p["w"].shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:T] * p["w"][0]
    for i in range(1, width):
        out = out + pad[:, i:i + T] * p["w"][i]
    return out + p["b"]


def conv_step(p, buf, x_t):
    """One decode step. buf: (B, width-1, C) past inputs; x_t: (B, 1, C).
    Returns (out (B, 1, C), the new buffer (B, width-1, C))."""
    window = torch.cat([buf, x_t], dim=1)                  # (B, width, C)
    out = torch.einsum("bwc,wc->bc", window, p["w"]) + p["b"]
    return out[:, None, :], window[:, 1:, :]


# ------------------------------------------------------------------------- #
# Mamba2 / SSD
# ------------------------------------------------------------------------- #
def _ssd_dims(cfg):
    s = cfg.ssm
    di = s.expand * cfg.d_model
    return s, di, di // s.head_dim


def ssd_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    s, di, n_h = _ssd_dims(cfg)
    d = cfg.d_model
    kw = dict(generator=generator, device=device, dtype=dtype)
    return {
        "z": linear_init(d, di, **kw),
        "x": linear_init(d, di, **kw),
        "B": linear_init(d, s.state_dim, **kw),
        "C": linear_init(d, s.state_dim, **kw),
        "dt": linear_init(d, n_h, **kw),
        "dt_bias": torch.zeros((n_h,), dtype=dtype, device=device),
        "A_log": torch.zeros((n_h,), dtype=torch.float32, device=device),
        "D": torch.ones((n_h,), dtype=dtype, device=device),
        "conv": conv1d_init(di + 2 * s.state_dim, s.conv_width, **kw),
        "norm": {"scale": torch.ones((di,), dtype=dtype, device=device)},
        "out": linear_init(di, d, scale=1 / math.sqrt(di), **kw),
    }


def _ssd_inputs(p, u):
    """The projections shared by prefill and decode: (z, xBC, dt), dt in
    float32."""
    z = linear(p["z"], u)
    xBC = torch.cat([linear(p["x"], u), linear(p["B"], u),
                     linear(p["C"], u)], dim=-1)
    dt = F.softplus(linear(p["dt"], u).float() + p["dt_bias"].float())
    return z, xBC, dt


def _ssd_split(xBC, cfg):
    s, di, _ = _ssd_dims(cfg)
    return (xBC[..., :di], xBC[..., di:di + s.state_dim],
            xBC[..., di + s.state_dim:])


def _gated_norm(norm_p, y, z):
    return apply_norm("rmsnorm", norm_p, y * _silu(z))


def ssd_apply(p, cfg, u, state=None, return_state=False):
    """u: (B, T, d). state None: the full sequence (chunked SSD), with
    return_state=True the final recurrent state and conv buffer too
    (prefill); state {"h", "conv"}: one decode token, the state updated in
    place. Returns (y, state)."""
    if TP.current() is not None:
        return _ssd_tp(p, cfg, u, state, return_state)
    s, di, n_h = _ssd_dims(cfg)
    A = -torch.exp(p["A_log"])                  # (H,) negative decay rates
    z, xBC, dt = _ssd_inputs(p, u)

    if state is not None:
        conv_out, conv_buf = conv_step(p["conv"], state["conv"], xBC)
        x, Bm, Cm = _ssd_split(_silu(conv_out), cfg)
        y, h = _ssd_step(state["h"], x, Bm, Cm, dt, A, p["D"], s.head_dim)
        y = _gated_norm(p["norm"], y, z)
        state["h"].copy_(h)
        state["conv"].copy_(conv_buf)
        return linear(p["out"], y), state

    # ---- chunked SSD over the full sequence ------------------------------ #
    x, Bm, Cm = _ssd_split(_silu(causal_conv1d(p["conv"], xBC)), cfg)
    y, h = SSD.ssd_chunked(x, Bm, Cm, dt, A, p["D"], s.head_dim,
                           s.chunk_size)
    y = _gated_norm(p["norm"], y, z)
    new_state = None
    if return_state:
        new_state = {"h": h,
                     "conv": xBC[:, -(s.conv_width - 1):, :].clone()}
    return linear(p["out"], y), new_state


def _ssd_step(h0, x, Bm, Cm, dt, A, D, P_):
    """One decode token of the SSD: x (B, 1, H·P) (its dtype is the
    output's), Bm and Cm (B, 1, N), dt (B, 1, H) float32, A and D (H,),
    the state h0 (B, H, P, N) float32. Returns y (B, 1, H·P) with the
    skip D·x, before the gated norm, and the new state. The heads are
    independent: a model rank runs this on its own heads with B and C
    whole."""
    B_, _, di = x.shape
    xh = x.reshape(B_, -1, P_)
    dt1 = dt[:, 0]                                         # (B, H)
    da = torch.exp(A[None] * dt1)
    h = h0 * da[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt1, xh.float(), Bm[:, 0].float())
    y = torch.einsum("bhpn,bn->bhp", h, Cm[:, 0].float())
    y = y.to(x.dtype) + D.to(x.dtype)[None, :, None] * xh
    return y.reshape(B_, 1, di), h


def _ssd_tp(p, cfg, u, state=None, return_state=False):
    """The SSD under a model group: the full sequence (training, and with
    `return_state` prefill) or, with the rank's `state`, one decode token
    (its state updated in place).

    The heads and the state dimension N shard (the group's size divides
    n_h and N: z, x and dt are column-parallel on head boundaries, B and
    C over N), and each rank runs its own heads: its channels of x, B and
    C, [x_r | B_r | C_r] (the layout of its conv buffer), through its
    slice of the depthwise conv, B and C gathered whole after it (the SSD
    contracts over N in C·Bᵀ, in the chunk states and in y_inter, and in
    a decode step's state update and read; their backward sums the
    ranks' heads, then takes the rank's slice), the gated RMSNorm's mean
    of squares summed over the group, and the row-parallel `out`. The
    replicated leaves a rank uses a slice of (conv, norm.scale, dt_bias,
    A_log, D) go through `scatter_to`, whose backward gathers the slices'
    gradients, so the whole leaf's gradient is the same on every rank. A
    group whose size does not divide the heads or N is refused (every
    arch's are multiples of the model axes the launcher and the dry-run
    take)."""
    s, di, n_h = _ssd_dims(cfg)
    N = s.state_dim
    for n, what in ((n_h, "heads"), (N, "state channels")):
        if not TP.shards(n):
            raise ValueError(f"ssd_apply: {n} {what} do not split over a "
                             f"model group of {TP.current().size}")
    size = TP.current().size
    xs = TP.copy_to(u)
    # the rank's conv channels, in its buffer's [x_r | B_r | C_r] order
    cp = {k: torch.cat([TP.scatter_to(t[..., lo:lo + n])
                        for lo, n in ((0, di), (di, N), (di + N, N))], -1)
          for k, t in p["conv"].items()}
    xBC = torch.cat([linear(p[k], xs) for k in ("x", "B", "C")], dim=-1)
    z = linear(p["z"], xs)
    dt = F.softplus(linear(p["dt"], xs).float()
                    + TP.scatter_to(p["dt_bias"]).float())
    A = -torch.exp(TP.scatter_to(p["A_log"]))
    D = TP.scatter_to(p["D"])
    if state is not None:
        conv_out, conv_buf = conv_step(cp, state["conv"], xBC)
    else:
        conv_out = causal_conv1d(cp, xBC)
    # B or C after the conv, whole on every rank; the gradient that leaves
    # it is the sum over the ranks' heads
    x, Bm, Cm = _silu(conv_out).split([di // size, N // size, N // size],
                                      dim=-1)
    Bm, Cm = (TP.copy_to(TP.gather_from(m)) for m in (Bm, Cm))
    if state is not None:
        y, h = _ssd_step(state["h"], x, Bm, Cm, dt, A, D, s.head_dim)
        state["h"].copy_(h)
        state["conv"].copy_(conv_buf)
        new_state = state
    else:
        y, h = SSD.ssd_chunked(x, Bm, Cm, dt, A, D, s.head_dim,
                               s.chunk_size)
        new_state = None
        if return_state:
            new_state = {"h": h,
                         "conv": xBC[:, -(s.conv_width - 1):, :].clone()}
    # the gated RMSNorm over the sharded di: the mean of squares is a
    # group sum (whose gradient, partial on each rank, is summed too)
    v = (y * _silu(z)).float()
    ms = TP.copy_to(TP.reduce_from(v.square().sum(-1, keepdim=True))) / di
    v = v * torch.rsqrt(ms + 1e-6)
    y = (v * TP.scatter_to(p["norm"]["scale"]).float()).to(y.dtype)
    return row_linear(p["out"], y, di), new_state


def ssd_state_init(cfg, batch, dtype, device=None):
    s, di, n_h = _ssd_dims(cfg)
    return {"h": torch.zeros((batch, n_h, s.head_dim, s.state_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.conv_width - 1,
                                 di + 2 * s.state_dim), dtype=dtype,
                                device=device)}


# ------------------------------------------------------------------------- #
# RG-LRU (RecurrentGemma / Griffin recurrent block)
# ------------------------------------------------------------------------- #
def rglru_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    r = cfg.rglru
    d = cfg.d_model
    w = r.expand * d
    kw = dict(generator=generator, device=device, dtype=dtype)
    # Λ set so that a = σ(Λ)^c lands in [0.9, 0.999] (the Griffin init),
    # kept in float32
    lam = 0.9 + 0.099 * torch.rand((w,), generator=generator, device=device,
                                   dtype=torch.float32)
    root = lam ** (1.0 / r.c_constant)
    return {
        "in_x": linear_init(d, w, **kw),
        "in_gate": linear_init(d, w, **kw),
        "conv": conv1d_init(w, r.conv_width, **kw),
        "W_a": linear_init(w, w, True, **kw),
        "W_i": linear_init(w, w, True, **kw),
        "lam": torch.log(root / (1 - root)),
        "out": linear_init(w, d, scale=1 / math.sqrt(w), **kw),
    }


def _rglru_gates(p, cfg, u, u_whole=None, lam=None):
    """u: the conv'd x branch, (B, T, w). Returns the recurrence's
    coefficients (a, b), float32. Under a model group u and `lam` are the
    rank's channels and `u_whole` the whole u, which the column-parallel
    W_a and W_i take."""
    c = cfg.rglru.c_constant
    u_whole = u if u_whole is None else u_whole
    lam = p["lam"] if lam is None else lam
    r_gate = torch.sigmoid(linear(p["W_a"], u_whole).float())
    i_gate = torch.sigmoid(linear(p["W_i"], u_whole).float())
    log_a = -c * F.softplus(lam) * r_gate                   # log a_t (B, T, w)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (
        i_gate * u.float())
    return a, b


def _interleave(even, odd):
    """Along dim 1: even[0], odd[0], even[1], ... (len(odd) is len(even)
    or one less)."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    pairs = pairs.reshape((even.shape[0], 2 * n) + tuple(even.shape[2:]))
    return torch.cat([pairs, even[:, n:]], dim=1) if even.shape[1] > n \
        else pairs


def associative_scan(a, b):
    """The prefix of (a_1, b_1) ∘ ... ∘ (a_t, b_t) along dim 1 under
    (a1, b1) ∘ (a2, b2) = (a1 a2, a2 b1 + b2): returns (A_t, h_t) with
    h_t = a_t h_{t-1} + b_t from h_0 = 0. `jax.lax.associative_scan`'s
    recursion: combine neighbouring pairs, scan those, then fill in the
    even positions."""
    T = a.shape[1]
    if T < 2:
        return a, b

    def combine(a1, b1, a2, b2):
        return a1 * a2, a2 * b1 + b2

    ra, rb = combine(a[:, 0:-1:2], b[:, 0:-1:2], a[:, 1::2], b[:, 1::2])
    oa, ob = associative_scan(ra, rb)                 # the odd positions
    if T % 2 == 0:
        ea, eb = combine(oa[:, :-1], ob[:, :-1], a[:, 2::2], b[:, 2::2])
    else:
        ea, eb = combine(oa, ob, a[:, 2::2], b[:, 2::2])
    ea = torch.cat([a[:, :1], ea], dim=1)
    eb = torch.cat([b[:, :1], eb], dim=1)
    return _interleave(ea, oa), _interleave(eb, ob)


def rglru_apply(p, cfg, x, state=None, return_state=False):
    """x: (B, T, d). state None: the full sequence (with return_state=True
    the final state too); state {"h": (B, w), "conv": buffer}: one decode
    token, the state updated in place. Returns (y, state)."""
    if TP.shards(cfg.rglru.expand * cfg.d_model):
        return _rglru_tp(p, cfg, x, state, return_state)
    u0 = linear(p["in_x"], x)
    gate = _gelu_tanh(linear(p["in_gate"], x))

    if state is not None:
        conv_out, conv_buf = conv_step(p["conv"], state["conv"], u0)
        a, b = _rglru_gates(p, cfg, conv_out)
        h = a[:, 0] * state["h"] + b[:, 0]                 # (B, w)
        y = h[:, None, :].to(x.dtype) * gate
        state["h"].copy_(h)
        state["conv"].copy_(conv_buf)
        return linear(p["out"], y), state

    a, b = _rglru_gates(p, cfg, causal_conv1d(p["conv"], u0))
    _, h = associative_scan(a, b)
    y = h.to(x.dtype) * gate
    new_state = None
    if return_state:
        width = cfg.rglru.conv_width
        new_state = {"h": h[:, -1].clone(),
                     "conv": u0[:, -(width - 1):, :].clone()}
    return linear(p["out"], y), new_state


def _rglru_tp(p, cfg, x, state=None, return_state=False):
    """The RG-LRU under a model group that shards its width w: the full
    sequence (training, and with `return_state` prefill) or, with the
    rank's `state` (h and conv buffer on its channels), one decode token
    (the state updated in place). in_x and in_gate are column-parallel,
    so the conv (its replicated weights sliced by `scatter_to`) and the
    recurrence run on the rank's w / size channels; W_a and W_i,
    column-parallel too, take the whole conv output (gathered; their
    backward sums the ranks' partial input gradients, then takes the
    rank's slice); `out` row-parallel."""
    w = cfg.rglru.expand * cfg.d_model
    xs = TP.copy_to(x)
    u0 = linear(p["in_x"], xs)
    gate = _gelu_tanh(linear(p["in_gate"], xs))
    cp = {k: TP.scatter_to(t) for k, t in p["conv"].items()}
    lam = TP.scatter_to(p["lam"])
    if state is not None:
        conv_out, conv_buf = conv_step(cp, state["conv"], u0)
        a, b = _rglru_gates(p, cfg, conv_out,
                            TP.copy_to(TP.gather_from(conv_out)), lam)
        h = a[:, 0] * state["h"] + b[:, 0]                 # (B, w / size)
        state["h"].copy_(h)
        state["conv"].copy_(conv_buf)
        return row_linear(p["out"], h[:, None, :].to(x.dtype) * gate,
                          w), state
    u = causal_conv1d(cp, u0)
    a, b = _rglru_gates(p, cfg, u, TP.copy_to(TP.gather_from(u)), lam)
    _, h = associative_scan(a, b)
    new_state = None
    if return_state:
        width = cfg.rglru.conv_width
        new_state = {"h": h[:, -1].clone(),
                     "conv": u0[:, -(width - 1):, :].clone()}
    return row_linear(p["out"], h.to(x.dtype) * gate, w), new_state


def rglru_state_init(cfg, batch, dtype, device=None):
    w = cfg.rglru.expand * cfg.d_model
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                                dtype=dtype, device=device)}
