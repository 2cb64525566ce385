"""The rule by which two runs of DQGAN over W workers agree, when their
float sums are taken in different orders: the JAX package against the
port, or the workers stacked on one device against the workers spread
over a process group.

Quantization turns a rounding difference in the message into a code one
level apart, so the parameters alone cannot be held to float32 rounding.
The sum p + (1/n)·Σ_m e1_m (n reporting workers) is invariant to such a
flip, as is p − (W/n)·e2 under two_phase: that part of the state is held
to float32 rounding, the parameters to within one quantization step, and
at most 1e-3 of the residual elements may differ (flipped codes).
Versions, where the schedule keeps them, agree exactly.

Under fsdp the shard owners hold the authoritative state, P: under zero-3
the parameter shards `w`; under zero-2 the replicated parameters less the
all-gather residuals `age` (the gathered update is u + age_prev − age).
P − (1/W)·Σ_w e1_w moves by the mean message whatever the codes of either
leg did, so `fsdp_agreement` holds P by `agreement`'s rule, the
replicated parameters to P within four all-gather residuals (two each
side), and at most 1e-3 of the residuals `age` may differ by more than
1e-3 of their largest plus the invariant's float32 rounding bound.

The step's telemetry (`metrics["obs"]`, `obs_agreement`) follows: the
staleness histogram counts versions and agrees exactly; a flipped code
moves its element's residual by one quantization step, so δ̂ = 1 −
Σe'²/Σm² moves by at most step²/Σm² for it. So δ̂ and bucket_delta are
held as the residual ratio 1 − δ̂ = Σe'²/Σm², relative to itself
(`RESIDUAL_RTOL`, plus float32 rounding of δ̂ next to 1): near 1 an
absolute bound on δ̂ would be as large as the ratio it has to check.
The moments and EF norms are sums in another order: rtol 1e-5.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm import buckets as B

MAX_FLIPPED = 1e-3


class Agreement(NamedTuple):
    d_params: float     # largest parameter difference
    d_invariant: float  # largest difference of the invariant part
    atol: float         # float32 rounding bound of the invariant part
    emax: float         # one quantization step (the largest residual)
    problems: List[str]  # empty where the two runs agree


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu()
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _flipped(ref, got, thresholds) -> float:
    bad = sum(int(((a - b).abs() > t).sum())
              for a, b, t in zip(ref, got, thresholds))
    return bad / sum(a.numel() for a in ref)


def _unchunk(e2, shape):
    """A per-tensor two_phase residual laid back onto the leaf's `shape`:
    owner w's row of e2 (W, *stored) is its chunk w along the chunk axis
    ax (the one the stored shape cuts), held as the exchange holds it,
    the chunk moved to lead, (c, *rest), reshaped to the stored shape."""
    ax = next(i for i, (c, d) in enumerate(zip(e2.shape[1:], shape))
              if c != d)
    rest = tuple(d for i, d in enumerate(shape) if i != ax)
    return torch.cat([torch.movedim(e.reshape((e2.shape[1 + ax],) + rest),
                                    0, ax) for e in e2], dim=ax)


def agreement(params, e1, W: int, n: int, *, e2=None, layout=None,
              versions=None, leaf_e2=None) -> Agreement:
    """`params`, `e1` and `e2` are (ref, got) pairs of lists of arrays
    (numpy or torch): the parameter leaves, each leaf's (W, ...) residual
    e1, and each bucket's e2 in `layout`'s order (two_phase, else None).
    `versions` is a (ref, got) pair of arrays or None. `leaf_e2` holds
    the per-tensor two_phase residuals as (ref, got) pairs of {leaf
    index: (W, *chunk)} (the leaves the buckets skip, or every leaf
    without buckets), held like the buckets' e2."""
    rp, gp = [_t(x) for x in params[0]], [_t(x) for x in params[1]]
    re1, ge1 = [_t(x) for x in e1[0]], [_t(x) for x in e1[1]]
    problems = []
    if [x.shape for x in re1] != [x.shape for x in ge1] or any(
            x.shape[0] != W for x in re1) or len(re1) != len(rp):
        problems.append("the e1 leaves differ in shape or worker count")
        return Agreement(float("inf"), float("inf"), 0.0, 0.0, problems)
    inv_r = [p - e.sum(0) / n for p, e in zip(rp, re1)]
    inv_g = [p - e.sum(0) / n for p, e in zip(gp, ge1)]
    emax = max(e.abs().max().item() for e in re1)
    if e2 is not None:
        re2 = [_t(x).reshape(-1) for x in e2[0]]
        ge2 = [_t(x).reshape(-1) for x in e2[1]]
        flips2 = _flipped(re2, ge2, [1e-3 * a.abs().max() for a in re2])
        if not flips2 <= MAX_FLIPPED:
            problems.append(f"{flips2:.2e} of the e2 residuals flipped")
        # (W/n)·e2, unchunked onto the leaves (zero on the leaves the
        # buckets skip)
        zeros = [torch.zeros_like(p) for p in rp]
        ur, ug = (B.unpack_into(layout, re2, zeros),
                  B.unpack_into(layout, ge2, zeros))
        inv_r = [a - W / n * u for a, u in zip(inv_r, ur)]
        inv_g = [a - W / n * u for a, u in zip(inv_g, ug)]
        emax = max(emax, W / n * max(a.abs().max().item() for a in re2))
    if leaf_e2:
        ref2 = {i: _t(x) for i, x in leaf_e2[0].items()}
        got2 = {i: _t(x) for i, x in leaf_e2[1].items()}
        keys = sorted(ref2)
        flips2 = _flipped([ref2[i] for i in keys], [got2[i] for i in keys],
                          [1e-3 * ref2[i].abs().max() for i in keys])
        if not flips2 <= MAX_FLIPPED:
            problems.append(f"{flips2:.2e} of the leaves' e2 flipped")
        for i in keys:
            inv_r[i] = inv_r[i] - W / n * _unchunk(ref2[i], rp[i].shape)
            inv_g[i] = inv_g[i] - W / n * _unchunk(got2[i], gp[i].shape)
            emax = max(emax, W / n * ref2[i].abs().max().item())
    flips = _flipped(re1, ge1, [1e-3 * emax] * len(re1))
    if not flips <= MAX_FLIPPED:
        problems.append(f"{flips:.2e} of the e1 residuals flipped")
    scale = max(p.abs().max().item() for p in rp)
    atol = 1e-6 * scale + 1e-6 * 127 * emax
    d_inv = max((a - b).abs().max().item() for a, b in zip(inv_r, inv_g))
    d_par = max((a - b).abs().max().item() for a, b in zip(rp, gp))
    if not d_inv <= atol:
        problems.append(f"params - e1/n differ by {d_inv:.3e} > {atol:.3e}")
    if not d_par <= atol + emax:
        problems.append(f"params differ by {d_par:.3e} > {atol + emax:.3e}")
    if versions is not None and not torch.equal(_t(versions[0]),
                                                _t(versions[1])):
        problems.append("versions differ")
    return Agreement(d_par, d_inv, atol, emax, problems)


def named_agreement(ref: dict, got: dict, W: int, n: int,
                    layout: Optional[object] = None) -> Agreement:
    """`agreement` of two named global states ({name: array}, the
    checkpoint layout's names: params/..., ef/leaf/.../e1,
    ef/bucket/<bid>/e2, sched/versions; fsdp/<bid>/<slot> under fsdp,
    which `fsdp_agreement` holds, given the bucket `layout`)."""
    if list(ref) != list(got):
        return Agreement(float("inf"), float("inf"), 0.0, 0.0,
                         ["the states hold different members"])
    if any(k.startswith("fsdp/") for k in ref):
        return fsdp_agreement(ref, got, W, layout)
    params = [k for k in ref if k.startswith("params/")]
    e1 = [k for k in ref if k.startswith("ef/") and k.endswith("/e1")]
    e2 = sorted((k for k in ref if k.startswith("ef/bucket/")),
                key=lambda k: int(k.split("/")[2]))
    # per-tensor two_phase residuals, by the index of their leaf
    leaf = {k[len("ef/"):-len("/e2")].removeprefix("leaf/"): k
            for k in ref if k.startswith("ef/") and k.endswith("/e2")
            and not k.startswith("ef/bucket/")}
    names = [k[len("params/"):] for k in params]
    leaf_e2 = ({names.index(p): ref[k] for p, k in leaf.items()},
               {names.index(p): got[k] for p, k in leaf.items()})
    pair = lambda keys: ([ref[k] for k in keys], [got[k] for k in keys])
    return agreement(pair(params), pair(e1), W, n,
                     e2=pair(e2) if e2 else None, layout=layout,
                     versions=(ref["sched/versions"], got["sched/versions"])
                     if "sched/versions" in ref else None,
                     leaf_e2=leaf_e2 if leaf else None)


def fsdp_agreement(ref: dict, got: dict, W: int, layout) -> Agreement:
    """`agreement` of two named fsdp states of W workers over the bucket
    `layout` (see the module docstring). Without EF (an exact gradient
    leg) the residuals count as zeros."""
    params = [k for k in ref if k.startswith("params/")]
    bids = [b.bid for b in layout.buckets]
    zero3 = f"fsdp/{bids[0]}/w" in ref

    def unpacked(state, slot):
        flats = [_t(state[f"fsdp/{b}/{slot}"]).reshape(-1) for b in bids]
        return B.unpack_into(layout, flats,
                             [_t(state[k]) for k in params])

    def authoritative(state):
        if zero3:
            return unpacked(state, "w")
        return [_t(state[k]) - a
                for k, a in zip(params, unpacked(state, "age"))]

    def residuals(state):
        e1 = [k for k in state if k.startswith("ef/") and k.endswith("/e1")]
        if e1:
            return [state[k] for k in e1]
        return [torch.zeros((W,) + tuple(_t(state[k]).shape))
                for k in params]

    agree = agreement((authoritative(ref), authoritative(got)),
                      (residuals(ref), residuals(got)), W, W)
    problems = list(agree.problems)
    ra = [_t(ref[f"fsdp/{b}/age"]).reshape(-1) for b in bids]
    ga = [_t(got[f"fsdp/{b}/age"]).reshape(-1) for b in bids]
    amax = max(a.abs().max().item() for a in ra)
    # beyond rounding: a residual next to zero (zero-2's update shard
    # already on the quantizer's grid) differs by float32 rounding of its
    # operand, which the invariant's atol bounds
    flips = _flipped(ra, ga, [1e-3 * amax + agree.atol] * len(ra))
    if not flips <= MAX_FLIPPED:
        problems.append(f"{flips:.2e} of the age residuals flipped")
    d_rep = max((_t(ref[k]) - _t(got[k])).abs().max().item()
                for k in params)
    bound = agree.atol + agree.emax + 4 * amax
    if not d_rep <= bound:
        problems.append(f"replicated params differ by {d_rep:.3e} > "
                        f"{bound:.3e}")
    return agree._replace(d_params=d_rep, problems=problems)


# 1 − δ̂ = Σe'²/Σm², the residual's share of the operand: a flipped code
# moves its element's e'² by at most one step², and stochastic rounding
# leaves e'² about step²/6 on average, so MAX_FLIPPED of the codes
# flipped move Σe'² by about 6·MAX_FLIPPED of itself: relative 1e-2. Each
# side's δ̂ is a float32 next to 1, where an ulp is 2⁻²⁴: two ulps.
RESIDUAL_RTOL = 1e-2
DELTA_ROUNDING = 2.0 ** -23


def obs_agreement(ref: dict, got: dict) -> List[str]:
    """Problems of `got` against `ref`, two `metrics["obs"]` dicts (tensors,
    arrays or lists) of runs that agree by `agreement`; empty where they
    agree (see the module docstring)."""
    if list(ref) != list(got):
        return [f"obs keys differ: {list(ref)} vs {list(got)}"]
    problems = []
    for k in ref:
        a, b = _t(ref[k]).double(), _t(got[k]).double()
        if a.shape != b.shape:
            problems.append(f"obs {k}: shape {tuple(b.shape)} vs "
                            f"{tuple(a.shape)}")
        elif k == "staleness_hist":
            if not torch.equal(a, b):
                problems.append(f"obs {k}: {b.tolist()} vs {a.tolist()}")
        elif k in ("delta_hat", "bucket_delta"):
            # held as the residual ratio 1 − δ̂, relative to itself
            ra, rb = 1.0 - a, 1.0 - b
            bad = (rb - ra).abs() > RESIDUAL_RTOL * ra.abs() + DELTA_ROUNDING
            if bool(bad.any()):
                problems.append(f"obs {k}: 1 − δ̂ {rb.tolist()} vs "
                                f"{ra.tolist()} beyond rtol "
                                f"{RESIDUAL_RTOL:.0e}")
        elif not torch.allclose(b, a, rtol=1e-5,
                                atol=1e-6 * a.abs().max().item()):
            problems.append(f"obs {k}: {b.tolist()} vs {a.tolist()} "
                            f"beyond rtol 1e-5")
    return problems
