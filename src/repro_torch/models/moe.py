"""Mixture-of-experts FFN (counterpart of `repro.models.moe`): top-k
routing with capacity-based one-hot-cumsum dispatch, the load-balance and
router-z aux losses, and Arctic's dense residual (a dense FFN added in
parallel with the experts).

    moe_init(cfg, generator=, device=, dtype=) -> params
    moe_apply(p, cfg, x)                       -> (y, aux)

The router computes in float32 whatever the activations' dtype, as the
JAX package's does. Dispatch ``"global"`` ranks every token of the batch
against one capacity pool; ``"per_row"`` gives each batch row its own pool
(a loop over the rows where the JAX package vmaps). The expert FFN is one
batched einsum over the (experts, capacity, d) buffer; its activation is
the port's `_silu` or `_gelu_tanh`, which round where `jax.nn` rounds.

Expert-parallel under a model group (`parallel.tensor`, the trainer's
'model' axis): each rank keeps its E / model experts and its slice of
the one-hot dispatch along E, runs the three einsums on its experts, and
the combine is all-reduced. The router, the capacity ranks and the aux
losses stay replicated, the same on every rank; the tokens and gates
enter the expert region through `copy_to`. Arctic's dense residual
follows the MLP's rules.

Under the fsdp layout (`parallel.fsdp`) a rank holds its rows of its
worker's batch. The global dispatch ranks the worker's tokens against
the worker's pool of `_capacity(m, S) · B_worker` slots: a token's rank
within its expert starts at the count of that expert's tokens on the
lower data ranks (an exclusive prefix of the (E,) counts, one small
all-gather over the data group a layer), and the rank's buffer holds its
own kept tokens. The load-balance term takes `me` and `ce` over the
worker's tokens (group sums; `ce` carries no gradient) and is the
worker's on every rank; the router-z term is the rank's share, as the
cross-entropy is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import fsdp as FS
from repro_torch.parallel import tensor as TP

from .layers import _gelu_tanh, _silu, linear, linear_init, mlp, mlp_init


def moe_init(cfg, *, generator=None, device=None, dtype=torch.float32):
    m = cfg.moe
    d = cfg.d_model

    def experts(shape, scale):
        return (torch.randn(shape, generator=generator, device=device,
                            dtype=torch.float32) * scale).to(dtype)

    p = {"router": linear_init(d, m.num_experts, False, generator=generator,
                               device=device, dtype=torch.float32),
         "gate_proj": experts((m.num_experts, d, m.d_ff_expert),
                              1.0 / math.sqrt(d)),
         "up_proj": experts((m.num_experts, d, m.d_ff_expert),
                            1.0 / math.sqrt(d)),
         "down_proj": experts((m.num_experts, m.d_ff_expert, d),
                              1.0 / math.sqrt(m.d_ff_expert))}
    if m.has_dense_residual:
        p["dense"] = mlp_init(d, m.dense_residual_d_ff, cfg.activation,
                              cfg.use_bias, generator=generator,
                              device=device, dtype=dtype)
    return p


def _capacity(m, S):
    """Slots an expert holds for S tokens (the JAX package's formula)."""
    return int(max(m.top_k, math.ceil(m.top_k * S / m.num_experts
                                      * m.capacity_factor)))


def moe_apply(p, cfg, x):
    """x: (B, S, d) -> (y (B, S, d), {"moe_load_balance", "moe_router_z"})."""
    m = cfg.moe
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    logits = linear(p["router"], xt.float())                   # (T, E)
    probs = torch.softmax(logits, dim=-1)
    # ties between f32 router probabilities have measure zero, so the
    # order topk returns them in (JAX's lax.top_k: lower index first)
    # never decides a route
    gate_vals, expert_idx = torch.topk(probs, m.top_k, dim=-1)   # (T, k)
    gate_vals = gate_vals / (gate_vals.sum(-1, keepdim=True) + 1e-9)

    fg = FS.current()
    counts = F.one_hot(expert_idx, m.num_experts).sum(1).float()
    z2 = torch.logsumexp(logits, dim=-1).square()
    if fg is None:
        me = probs.mean(0)                                       # (E,)
        ce = counts.mean(0)
        z = z2.mean()
    else:   # the worker's tokens: sums over the data group
        n = B * S * fg.size
        me = TP.reduce_from(probs.sum(0), group=fg) / n
        ce = fg.all_reduce(counts.sum(0).detach()) / n
        z = z2.sum() / n
    aux = {"moe_load_balance": m.router_aux_coef * m.num_experts
           * (me * ce).sum(),
           "moe_router_z": m.router_z_coef * z}

    if m.dispatch == "per_row":
        cap = _capacity(m, S)
        ei = expert_idx.reshape(B, S, m.top_k)
        gv = gate_vals.reshape(B, S, m.top_k)
        y = torch.stack([_dispatch_combine(p, cfg, x[b], ei[b], gv[b], cap)
                         for b in range(B)])
    else:
        y = _dispatch_combine(p, cfg, xt, expert_idx, gate_vals,
                              _capacity(m, S) * B * FS.data_size(),
                              fg).reshape(B, S, d)

    if "dense" in p:   # Arctic: a dense FFN in parallel with the experts
        y = y + mlp(p["dense"], xt, cfg.activation,
                    m.dense_residual_d_ff).reshape(B, S, d)
    return y, aux


def dispatch_keep(flat_e, E: int, cap: int, fg=None):
    """(rank, keep) of each (token, choice) routed to expert `flat_e`
    (T·k,): its rank within its expert's tokens, in order, and whether it
    fits the expert's `cap` slots. `fg` (an fsdp group): the tokens are
    this data rank's, after the expert's tokens on the lower ranks, which
    count toward the pool (the rank returned is the token's own)."""
    onehot = F.one_hot(flat_e, E)
    ranks = torch.cumsum(onehot, dim=0) - onehot        # rank within expert
    rank = ranks.gather(1, flat_e[:, None])[:, 0]
    if fg is None:
        return rank, rank < cap
    counts = fg.all_gather(onehot.sum(0)[None], 0)      # (data, E)
    below = counts[:fg.index].sum(0)
    return rank, rank + below[flat_e] < cap


def _dispatch_combine(p, cfg, xt, expert_idx, gate_vals, cap, fg=None):
    """One-hot-cumsum capacity dispatch, the batched expert FFN, and the
    gate-weighted combine. xt: (T, d); expert_idx, gate_vals: (T, k).
    `fg` (an fsdp group): xt is this data rank's part of a pool of `cap`
    slots shared with the group's lower ranks."""
    m = cfg.moe
    T, d = xt.shape
    k, E = m.top_k, m.num_experts

    flat_e = expert_idx.reshape(T * k)
    rank, keep = dispatch_keep(flat_e, E, cap, fg)
    # under fsdp a kept token's own rank is below both
    slots = cap if fg is None else min(cap, T * k)
    rank_c = torch.where(keep, rank, 0)
    El = p["gate_proj"].shape[0]          # this rank's experts
    tp = TP.shards(E)
    if tp:   # the rank's experts, [start, start + El), of the dispatch
        start = TP.current().index * El
        mine = (flat_e >= start) & (flat_e < start + El)
        flat_e = torch.where(mine, flat_e - start, 0)
        keep = keep & mine
        xt, gate_vals = TP.copy_to(xt), TP.copy_to(gate_vals)

    # a dropped token adds an exact zero into slot 0 of its expert (the
    # JAX package's .at[].add(mode="drop") of a masked row), so however
    # the device orders the accumulation no kept sum changes
    x_rep = torch.repeat_interleave(xt, k, dim=0)                # (T·k, d)
    buf = torch.zeros((El, slots, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((flat_e, rank_c),
                        torch.where(keep[:, None], x_rep, 0),
                        accumulate=True)

    act = _silu if cfg.activation == "silu" else _gelu_tanh
    h = (act(torch.einsum("ecd,edf->ecf", buf, p["gate_proj"]))
         * torch.einsum("ecd,edf->ecf", buf, p["up_proj"]))
    out_buf = torch.einsum("ecf,efd->ecd", h, p["down_proj"])   # (E, cap, d)

    tok_out = torch.where(keep[:, None], out_buf[flat_e, rank_c], 0)
    w = gate_vals.reshape(T * k)[:, None].to(tok_out.dtype)
    y = (tok_out * w).reshape(T, k, d).sum(1)
    return TP.reduce_from(y) if tp else y
