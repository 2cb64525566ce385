"""Layer-wise compression planning (counterpart of `repro.comm.planner`).

One compressor per bucket, from three policies:

  uniform      : every bucket gets the base compressor (paper semantics).
  size_tiered  : buckets made only of small tensors (< SMALL_ELEMS) stay
                 full precision; the rest get the base compressor.
  delta_budget : greedy bit-width descent. While the modeled payload
                 exceeds ``budget_bytes``, move the bucket with the best
                 (bytes saved) / (δ lost) one rung down the ladder: the
                 8→4→2-bit quant ladder for linf StochasticQuant bases
                 (quant_ladder), base → qsgd4_linf → sign otherwise.

δ for the stochastic quantizers uses a Gaussian heuristic, enough to rank
buckets. A round-adaptive `PlanFamily` holds one delta_budget plan per
participant count n, each cut from the same descent at the effective
budget B·M/n (`plan_family`).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core import compressors as C

from .buckets import BucketLayout

POLICIES = ("uniform", "size_tiered", "delta_budget")
# the full DQConfig.comm_plan / Compression.plan domain: "none" keeps the
# seed per-tensor exchange, any planner policy routes through buckets
ALL_POLICIES = ("none",) + POLICIES

SMALL_ELEMS = 1 << 16           # size_tiered: "small" bucket threshold
LADDER = ("qsgd4_linf", "sign")  # delta_budget downgrade rungs after base


def analytic_delta(comp: C.Compressor, d: int) -> float:
    """δ hint in (0, 1]. Exact where the compressor reports one (identity,
    topk, randk); for linf stochastic quantizers use the Gaussian-input
    estimate E||Q(v)-v||²/||v||² ≈ d·(s/2L)²·(1/3)/||v||² with s² ≈
    2·ln(d)·σ² (expected max² of d gaussians) and ||v||² ≈ d·σ², i.e.
    δ ≈ 1 − ln(d)/(6L²); for sign, δ = (E|v|)²/E[v²] = 2/π."""
    exact = comp.delta(d)
    if exact is not None:
        return float(exact)
    if isinstance(comp, C.StochasticQuant):
        block = comp.per_block if comp.per_block > 0 else d
        loss = math.log(max(block, 2)) / (6.0 * comp.levels**2)
        return max(1e-3, 1.0 - loss)
    if isinstance(comp, C.SignMean):
        return 2.0 / math.pi
    return 0.5


@dataclass(frozen=True)
class BucketAssignment:
    bid: int
    compressor: str
    elems: int
    wire_bytes: int             # analytic payload bytes for this bucket
    delta: float                # δ hint for the assigned compressor


@dataclass(frozen=True)
class CommPlan:
    policy: str
    assignments: Tuple[BucketAssignment, ...]
    base_compressor: str

    @property
    def payload_bytes(self) -> int:
        """Per-worker compressed payload bytes per step (before the
        strategy's collective multiplier — see ledger.strategy_multiplier)."""
        return sum(a.wire_bytes for a in self.assignments)

    @property
    def min_delta(self) -> float:
        return min((a.delta for a in self.assignments), default=1.0)

    def compressor_for(self, bid: int) -> str:
        return self.assignments[bid].compressor

    def describe(self) -> str:
        by = {}
        for a in self.assignments:
            by[a.compressor] = by.get(a.compressor, 0) + 1
        mix = " ".join(f"{k}x{n}" for k, n in sorted(by.items()))
        return (f"policy={self.policy} [{mix}] payload={self.payload_bytes}B "
                f"min_delta={self.min_delta:.3f}")


def _assign(bid: int, name: str, elems: int) -> BucketAssignment:
    comp = C.get(name)
    return BucketAssignment(
        bid=bid, compressor=name, elems=elems,
        wire_bytes=int(comp.wire_bytes((elems,))),
        delta=analytic_delta(comp, elems),
    )


def _descent_trajectory(layout: BucketLayout,
                        ladder: List[str]) -> List[Tuple[List[str], int]]:
    """The greedy bit-width descent as a budget-independent trajectory.

    Each iteration downgrades the bucket with the best (bytes saved)/(δ
    lost) ratio one rung down `ladder`; the pick depends only on the
    current rung state, never on the budget — the budget only decides how
    far along the trajectory to stop. Returns the list of
    (bucket→compressor names, total payload bytes) states from "all at
    base" down to "all at the cheapest rung", so every budget (and every
    PlanFamily member) is a prefix cut of ONE descent — which is what
    makes family bit-widths monotone in the participant count for free.
    """
    names = [ladder[0]] * len(layout.buckets)
    rung = [0] * len(layout.buckets)

    def total():
        return sum(_assign(b.bid, names[b.bid], b.size).wire_bytes
                   for b in layout.buckets)

    states = [(list(names), total())]
    while True:
        best, best_score = None, 0.0
        for b in layout.buckets:
            r = rung[b.bid]
            if r + 1 >= len(ladder):
                continue
            cur = _assign(b.bid, ladder[r], b.size)
            nxt = _assign(b.bid, ladder[r + 1], b.size)
            saved = cur.wire_bytes - nxt.wire_bytes
            lost = max(cur.delta - nxt.delta, 1e-6)
            if saved <= 0:
                continue
            score = saved / lost
            if best is None or score > best_score:
                best, best_score = b.bid, score
        if best is None:
            return states  # every bucket already at the cheapest rung
        rung[best] += 1
        names[best] = ladder[rung[best]]
        states.append((list(names), total()))


def _cut_trajectory(states, budget_bytes: int) -> List[str]:
    """First trajectory state fitting the budget (or the floor state)."""
    for names, payload in states:
        if payload <= budget_bytes:
            return names
    return states[-1][0]


def _warn_floor_overrun(layout, names, ladder, budget_bytes: int) -> None:
    """The descent can bottom out above the budget (every bucket at the
    cheapest rung). That was always silent; since the linf quant ladder's
    floor is 2-bit ternary (vs the legacy 1-bit sign floor) the overrun
    can now be up to 2x — surface it so a too-tight budget_mb is a
    visible modeling decision, not a quiet one."""
    payload = sum(_assign(b.bid, names[b.bid], b.size).wire_bytes
                  for b in layout.buckets)
    if payload > budget_bytes:
        import warnings
        warnings.warn(
            f"delta_budget: the descent floor ({ladder[-1]}) still costs "
            f"{payload} B/step, over the {budget_bytes} B budget — the "
            f"plan ships the floor and overruns the budget",
            stacklevel=3)


def plan_comm(
    layout: BucketLayout,
    base_compressor: str,
    policy: str = "uniform",
    budget_bytes: int = 0,
) -> CommPlan:
    if policy not in POLICIES:
        raise ValueError(f"unknown comm policy {policy!r}; have {POLICIES}")
    if policy == "delta_budget" and budget_bytes <= 0:
        raise ValueError(
            "comm policy 'delta_budget' needs a positive byte budget "
            "(set DQConfig.comm_budget_mb / --comm-budget-mb)")
    C.get(base_compressor)  # fail fast on bad names

    names = [base_compressor] * len(layout.buckets)

    if policy == "size_tiered":
        for b in layout.buckets:
            if all(s.size < SMALL_ELEMS for s in b.slots):
                names[b.bid] = "identity"

    if policy == "delta_budget":
        # linf StochasticQuant bases descend the same-structure 8→4→2-bit
        # ladder (identical payload layout per rung — what makes the
        # adaptive PlanFamily's full-participation member bit-exact with
        # this static plan at any budget); other bases keep the legacy
        # mixed ladder ending in sign.
        try:
            ladder = quant_ladder(base_compressor)
        except ValueError:
            ladder = [base_compressor] + [n for n in LADDER
                                          if n != base_compressor]
        names = _cut_trajectory(_descent_trajectory(layout, ladder),
                                budget_bytes)
        _warn_floor_overrun(layout, names, ladder, budget_bytes)

    assignments = tuple(_assign(b.bid, names[b.bid], b.size)
                        for b in layout.buckets)
    return CommPlan(policy=policy, assignments=assignments,
                    base_compressor=base_compressor)


def quant_ladder(base_compressor: str) -> List[str]:
    """The same-structure downgrade ladder for an adaptive family.

    Every rung is a linf `StochasticQuant` with the base's block layout
    and a lower bit-width (8 → 4 → 2), so every family member emits the
    SAME payload pytree (int8 codes + f32 scales, shapes fixed by
    per_block) and the per-round selection reduces to gathering a levels
    scalar from a jit-static table — no `lax.switch` over structurally
    different payloads, no retrace. Raises for bases outside that shape
    (sign/topk/l2 quantizers change the payload structure or the scale
    semantics between rungs).
    """
    base = C.get(base_compressor)
    if not (isinstance(base, C.StochasticQuant) and base.norm == "linf"):
        raise ValueError(
            f"adaptive plan families need a linf StochasticQuant base "
            f"(same-structure bit-width ladder); got {base_compressor!r}")
    out = []
    for bits in (8, 4, 2):
        if bits > base.bits:
            continue
        suffix = (f"block{base.per_block}" if base.per_block > 0 else "linf")
        name = f"qsgd{bits}_{suffix}"
        comp = C.REGISTRY.get(name)
        if (comp is None or not isinstance(comp, C.StochasticQuant)
                or comp.per_block != base.per_block or comp.bits != bits):
            raise ValueError(
                f"adaptive ladder rung {name!r} missing from the "
                f"compressor registry for base {base_compressor!r}")
        out.append(name)
    if out[0] != base_compressor:
        raise ValueError(
            f"adaptive plan families start at a registry 8/4/2-bit rung; "
            f"got base {base_compressor!r}")
    return out


@dataclass(frozen=True)
class PlanFamily:
    """One `CommPlan` per participation count n ∈ {1..n_workers}.

    Built by `plan_family` from one descent trajectory, cut at the
    *effective* per-round budget ``budget_bytes · M / n`` for each n —
    when only n of M workers report, each reporting worker may spend the
    absent workers' share on finer quantization. Because every member is
    a prefix cut of the same trajectory the family is monotone by
    construction: fewer participants ⇒ per-bucket bit-widths
    non-decreasing and min_delta non-increasing in n (finer plans for
    smaller rounds), and every member's payload fits its effective
    budget (or sits at the ladder floor). Frozen and hashable; built once
    on the host.
    """
    plans: Tuple[CommPlan, ...]     # index n-1 → plan for n participants
    n_workers: int
    budget_bytes: int
    base_compressor: str

    def __post_init__(self):
        if len(self.plans) != self.n_workers:
            raise ValueError(f"PlanFamily: {len(self.plans)} plans for "
                             f"{self.n_workers} workers")

    def plan_for(self, n: int) -> CommPlan:
        if not 1 <= n <= self.n_workers:
            raise ValueError(
                f"participant count {n} outside 1..{self.n_workers}")
        return self.plans[n - 1]

    @property
    def full(self) -> CommPlan:
        """The full-participation (n = M) plan — today's static plan."""
        return self.plans[-1]

    @property
    def n_distinct(self) -> int:
        return len({p.assignments for p in self.plans})

    def effective_budget(self, n: int) -> int:
        return int(self.budget_bytes * self.n_workers / max(n, 1))

    def levels_table(self) -> Tuple[Tuple[int, ...], ...]:
        """(n_workers, n_buckets) quantization level counts: the table the
        step copies to the device once and indexes there with the round's
        participant count (row n-1 is the plan for n participants)."""
        return tuple(
            tuple(C.get(a.compressor).levels for a in p.assignments)
            for p in self.plans)

    def bits_table(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(
            tuple(C.get(a.compressor).bits for a in p.assignments)
            for p in self.plans)

    def diff(self, other: "PlanFamily") -> List[str]:
        """Field-level differences, naming the participation count whose
        sub-plan differs (the strategy-CLI / resume-guard rendering)."""
        out = []
        if self.n_workers != other.n_workers:
            out.append(f"plan_family.n_workers: {self.n_workers} != "
                       f"{other.n_workers}")
        if self.budget_bytes != other.budget_bytes:
            out.append(f"plan_family.budget_bytes: {self.budget_bytes} != "
                       f"{other.budget_bytes}")
        for n in range(1, min(self.n_workers, other.n_workers) + 1):
            a, b = self.plan_for(n), other.plan_for(n)
            if len(a.assignments) != len(b.assignments):
                out.append(
                    f"plan_family[n={n}]: {len(a.assignments)} buckets "
                    f"!= {len(b.assignments)} buckets (different layouts)")
                continue
            for aa, bb in zip(a.assignments, b.assignments):
                if aa.compressor != bb.compressor:
                    out.append(
                        f"plan_family[n={n}].bucket{aa.bid}: "
                        f"{aa.compressor!r} != {bb.compressor!r}")
        return out

    def describe(self) -> str:
        cuts = " | ".join(
            f"n={n}:{self.plan_for(n).payload_bytes}B"
            for n in range(1, self.n_workers + 1))
        return (f"family[{self.n_workers}] base={self.base_compressor} "
                f"budget={self.budget_bytes}B distinct={self.n_distinct} "
                f"({cuts})")


def plan_family(
    layout: BucketLayout,
    base_compressor: str,
    budget_bytes: int,
    n_workers: int,
) -> PlanFamily:
    """Precompute the delta_budget plan for every participation count.

    One `_descent_trajectory` walk; member n is the first trajectory
    state fitting ``budget_bytes · M / n``. Monotonicity (fewer
    participants ⇒ finer or equal bits everywhere) holds because smaller
    n ⇒ larger effective budget ⇒ an earlier (finer) prefix cut of the
    same descent.
    """
    if budget_bytes <= 0:
        raise ValueError(
            "plan_family needs a positive per-round byte budget")
    M = max(n_workers, 1)
    ladder = quant_ladder(base_compressor)
    states = _descent_trajectory(layout, ladder)
    # the n = M member has the tightest effective budget; if even the
    # floor overruns it, say so once for the whole family
    _warn_floor_overrun(layout, _cut_trajectory(states, budget_bytes),
                        ladder, budget_bytes)
    plans = []
    for n in range(1, M + 1):
        eff = int(budget_bytes * M / n)
        names = _cut_trajectory(states, eff)
        plans.append(CommPlan(
            policy="delta_budget",
            assignments=tuple(_assign(b.bid, names[b.bid], b.size)
                              for b in layout.buckets),
            base_compressor=base_compressor))
    return PlanFamily(plans=tuple(plans), n_workers=M,
                      budget_bytes=int(budget_bytes),
                      base_compressor=base_compressor)
