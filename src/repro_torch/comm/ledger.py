"""Wire-byte telemetry (counterpart of `repro.comm.ledger`).

`CommLedger` answers "how many bytes did this step move?" from static
payload shapes, computed once at plan time and accumulated host-side as
training ticks. Two counts per entry:

  wire_bytes    : analytic bits on the wire (Compressor.wire_bytes × the
                  strategy's collective multiplier).
  carried_bytes : bytes of the payload buffers the collectives move
                  (compress run on meta tensors: shapes only, no data).

The numbers equal the JAX package's for the same layout and plan.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import torch

from repro_torch import tree as T
from repro_torch.core import compressors as C
from repro_torch.core import exchange as X

from .buckets import BucketLayout
from .planner import CommPlan, analytic_delta


# --------------------------------------------------------------------------- #
# static payload measurement
# --------------------------------------------------------------------------- #
def payload_nbytes(comp: C.Compressor, shape) -> int:
    """Bytes of the buffers comp.compress emits for one f32 tensor (codes +
    scales + indices ...), measured on meta tensors: no data, no FLOPs."""
    v = torch.empty(tuple(shape), dtype=torch.float32, device="meta")
    payload = comp.compress(v)
    return int(sum(p.numel() * p.element_size() for p in payload.values()))


def strategy_wire_bytes(strategy: str, comp: C.Compressor, shape,
                        n_workers: int, carried: bool = False) -> float:
    """Per-worker send+receive bytes for one tensor under a strategy;
    ``carried`` swaps the analytic model for payload buffer sizes."""
    if not carried:
        return X.modeled_wire_bytes(strategy, comp, shape, n_workers)
    d = math.prod(shape)
    W = n_workers
    cb = payload_nbytes(comp, shape)
    if strategy in ("exact", "sim"):
        return 2 * (W - 1) / W * 4 * d     # float ring all-reduce either way
    if strategy == "allgather":
        return cb + (W - 1) * cb
    if strategy == "two_phase":
        return 2 * (W - 1) / W * cb
    raise ValueError(strategy)


# --------------------------------------------------------------------------- #
# the ledger
# --------------------------------------------------------------------------- #
@dataclass
class LedgerEntry:
    tag: str
    strategy: str
    compressor: str
    elems: int
    n_workers: int
    wire_bytes: float
    carried_bytes: float
    fallback: bool = False
    bucket: int = -1         # comm-bucket id; -1 for per-tensor leaves
    skipped: bool = False    # sharded leaf bypassing buckets (per-tensor)


@dataclass
class CommLedger:
    """Accumulates per-step wire cost. Register entries once (at plan
    time), then ``tick()`` each training step; read ``summary()``. Steps
    and exchange rounds are counted apart (a schedule may skip rounds).

    Participation-aware: ``tick(participants=n)`` bills the round at the
    bytes the n reporting workers move, the fleet average (n/M)·payload,
    with the payload of the round-adaptive ``family`` member for n when
    one is attached."""
    entries: List[LedgerEntry] = field(default_factory=list)
    steps: int = 0
    rounds: int = 0          # exchange rounds actually executed
    sim_clock_s: float = 0.0  # accumulated simulated wall clock
    n_workers: int = 0       # fleet size M (0 = unknown)
    family: Optional[object] = None   # planner.PlanFamily | None
    cum_wire: float = 0.0
    cum_carried: float = 0.0
    budget_bytes: float = 0.0  # delta_budget payload target/worker (0 = none)
    last_participants: Optional[int] = None
    _round_memo: dict = field(default_factory=dict, repr=False)

    # -- registration ------------------------------------------------------- #
    def register(self, tag, strategy, comp: C.Compressor, shape,
                 n_workers: int, fallback: bool = False, bucket: int = -1,
                 skipped: bool = False, wire_bytes: Optional[float] = None,
                 carried_bytes: Optional[float] = None):
        """Record one per-step exchange entry; explicit wire/carried bytes
        bill a composite exchange (fsdp's reduce-scatter + all-gather) at
        its two legs instead of the one-collective model."""
        self.entries.append(LedgerEntry(
            tag=tag, strategy=strategy, compressor=comp.name,
            elems=math.prod(shape), n_workers=n_workers,
            wire_bytes=(strategy_wire_bytes(strategy, comp, shape, n_workers)
                        if wire_bytes is None else wire_bytes),
            carried_bytes=(strategy_wire_bytes(strategy, comp, shape,
                                               n_workers, carried=True)
                           if carried_bytes is None else carried_bytes),
            fallback=fallback, bucket=bucket, skipped=skipped,
        ))

    @classmethod
    def from_plan(cls, layout: BucketLayout, plan: CommPlan, strategy: str,
                  n_workers: int, base_compressor: str,
                  leaf_plans: Optional[list] = None, family=None,
                  budget_bytes: float = 0.0,
                  moment_compressor: Optional[str] = None) -> "CommLedger":
        """Ledger for the bucketed path: one entry per bucket (its assigned
        compressor) + one per skipped leaf on the per-tensor path.
        ``leaf_plans`` are the exchange.plan_leaf dicts of the skipped
        leaves; without them they are billed as sim fallbacks
        (full-precision wire). ``family`` attaches the round-adaptive
        PlanFamily, so that rounds billed at participants=n price the
        buckets under the member for n. ``budget_bytes`` is the
        delta_budget target the per-bucket rows report utilization
        against (the family's when not given). ``moment_compressor`` marks
        the fsdp layout: each bucket is billed for both legs, the gradient
        reduce-scatter and the moments/parameter all-gather
        (exchange.modeled_fsdp_wire_bytes), instead of one replicated
        collective."""
        if not budget_bytes and family is not None:
            budget_bytes = float(getattr(family, "budget_bytes", 0) or 0)
        led = cls(n_workers=max(n_workers, 1), family=family,
                  budget_bytes=float(budget_bytes))
        W = max(n_workers, 2)  # collective multipliers degenerate at W=1
        mom = C.get(moment_compressor) if moment_compressor else None
        for b, a in zip(layout.buckets, plan.assignments):
            comp = C.get(a.compressor)
            wire = carried = None
            if mom is not None:
                wire = X.modeled_fsdp_wire_bytes(
                    strategy, comp, mom, (b.size,), W)
                f = (W - 1) / W
                carried = f * ((4 * b.size if strategy == "exact"
                                else payload_nbytes(comp, (b.size,)))
                               + payload_nbytes(mom, (b.size,)))
            led.register(f"bucket/{b.bid}", strategy, comp, (b.size,), W,
                         bucket=b.bid, wire_bytes=wire,
                         carried_bytes=carried)
        base = C.get(base_compressor)
        for i, s in enumerate(layout.skipped):
            if leaf_plans:
                lp = leaf_plans[i]
            else:
                lp = {"strategy": "sim" if strategy == "two_phase"
                      else strategy,
                      "fallback": strategy == "two_phase"}
            led.register(f"leaf{s.path}", lp["strategy"], base, s.shape, W,
                         fallback=lp.get("fallback", False), skipped=True)
        return led

    @classmethod
    def from_tree(cls, strategy: str, comp_name: str, shapes_tree,
                  specs_tree, n_workers: int) -> "CommLedger":
        """Ledger for the per-tensor path (comm_plan='none')."""
        led = cls(n_workers=max(n_workers, 1))
        W = max(n_workers, 2)
        plans = X.plan_for_tree(strategy, shapes_tree, specs_tree, n_workers)
        comp = C.get(comp_name)
        paths, shapes = T.flatten(shapes_tree)
        for path, shape, lp in zip(paths, shapes,
                                   T.flatten_up_to(paths, plans)):
            led.register(f"leaf{T.keystr(path)}",
                         lp["strategy"], comp, shape, W,
                         fallback=lp.get("fallback", False))
        return led

    # -- accumulation ------------------------------------------------------- #
    def round_bytes(self, participants: Optional[int] = None):
        """(wire, carried) bytes one exchange round moves, fleet-averaged
        per worker. With ``participants=n < M`` only n workers ship a
        payload, and under an attached PlanFamily they ship the n-member
        plan, not the full-M plan."""
        n, M = participants, self.n_workers
        if n is None or not M or n >= M:
            return self.wire_bytes_per_step, self.carried_bytes_per_step
        hit = self._round_memo.get(n)
        if hit is not None:
            return hit
        frac = n / M
        plan = self.family.plan_for(n) if self.family is not None else None
        wire = carried = 0.0
        for e in self.entries:
            if plan is not None and e.bucket >= 0:
                comp = C.get(plan.assignments[e.bucket].compressor)
            else:
                comp = C.get(e.compressor)
            wire += frac * strategy_wire_bytes(
                e.strategy, comp, (e.elems,), e.n_workers)
            carried += frac * strategy_wire_bytes(
                e.strategy, comp, (e.elems,), e.n_workers, carried=True)
        self._round_memo[n] = (wire, carried)
        return wire, carried

    def tick(self, n: int = 1, exchanged: bool = True, wall_s: float = 0.0,
             participants: Optional[int] = None):
        """Advance `n` steps; ``exchanged=False`` records steps that moved
        no bytes; ``wall_s`` adds simulated wall clock; ``participants``
        bills the rounds at what the reporting workers moved
        (round_bytes)."""
        self.steps += n
        if exchanged:
            self.rounds += n
            w, c = self.round_bytes(participants)
            self.cum_wire += n * w
            self.cum_carried += n * c
        if participants is not None:
            self.last_participants = participants
        self.sim_clock_s += wall_s

    # -- readouts ----------------------------------------------------------- #
    @property
    def wire_bytes_per_step(self) -> float:
        return sum(e.wire_bytes for e in self.entries)

    @property
    def carried_bytes_per_step(self) -> float:
        return sum(e.carried_bytes for e in self.entries)

    @property
    def raw_bytes_per_step(self) -> float:
        """What the exact (f32 ring all-reduce) exchange would move."""
        return sum(strategy_wire_bytes("exact", C.get("identity"),
                                       (e.elems,), e.n_workers)
                   for e in self.entries)

    @property
    def cumulative_wire_bytes(self) -> float:
        return self.cum_wire

    @property
    def compression_ratio(self) -> float:
        w = self.wire_bytes_per_step
        return self.raw_bytes_per_step / w if w else 1.0

    def n_fallbacks(self) -> int:
        return sum(1 for e in self.entries if e.fallback)

    def skipped_leaves(self) -> Tuple[int, float]:
        """(count, wire bytes/step) of sharded leaves that bypassed the
        bucket pipeline onto the per-tensor path."""
        hits = [e for e in self.entries if e.skipped]
        return len(hits), sum(e.wire_bytes for e in hits)

    def effective_budget(self, participants: Optional[int] = None) -> float:
        """The per-participant payload budget of a round: B at full
        participation, B·M/n when only n of M workers report. 0 when no
        budget."""
        if not self.budget_bytes:
            return 0.0
        n, M = participants, self.n_workers
        if n is None or not M or n >= M:
            return self.budget_bytes
        return self.budget_bytes * M / max(n, 1)

    def per_bucket(self, participants: Optional[int] = None) -> list:
        """One row per comm bucket: bits, payload, analytic δ and, under a
        budget, its share of the round's effective budget, priced under
        the plan the round selected (the family member for
        ``participants=n``, else the static full plan)."""
        n, M = participants, self.n_workers
        plan = None
        if n is not None and M and n < M and self.family is not None:
            plan = self.family.plan_for(n)
        eff = self.effective_budget(participants)
        rows = []
        for e in self.entries:
            if e.bucket < 0:
                continue
            name = (plan.assignments[e.bucket].compressor if plan is not None
                    else e.compressor)
            comp = C.get(name)
            payload = int(comp.wire_bytes((e.elems,)))
            row = {
                "bucket": e.bucket,
                "compressor": name,
                "bits": getattr(comp, "bits", None),
                "elems": e.elems,
                "payload_bytes": payload,
                "wire_bytes": round(strategy_wire_bytes(
                    e.strategy, comp, (e.elems,), e.n_workers), 1),
                "delta": round(analytic_delta(comp, e.elems), 4),
            }
            if eff:
                row["budget_share"] = round(payload / eff, 4)
            rows.append(row)
        return rows

    def summary(self) -> dict:
        out = {
            "steps": self.steps,
            "rounds": self.rounds,
            "sim_clock_s": round(self.sim_clock_s, 4),
            "wire_bytes_per_step": round(self.wire_bytes_per_step),
            "carried_bytes_per_step": round(self.carried_bytes_per_step),
            "raw_bytes_per_step": round(self.raw_bytes_per_step),
            "cumulative_wire_bytes": round(self.cumulative_wire_bytes),
            "compression_ratio": round(self.compression_ratio, 2),
            "n_entries": len(self.entries),
            "n_fallbacks": self.n_fallbacks(),
        }
        n_skip, skip_bytes = self.skipped_leaves()
        if n_skip:
            out["skipped_leaves"] = n_skip
            out["skipped_leaf_bytes_per_step"] = round(skip_bytes)
        if self.last_participants is not None:
            out["participants"] = self.last_participants
        rows = self.per_bucket(self.last_participants)
        if rows:
            out["per_bucket"] = rows
            if self.budget_bytes:
                eff = self.effective_budget(self.last_participants)
                out["budget_bytes"] = round(self.budget_bytes)
                out["budget_utilization"] = round(
                    sum(r["payload_bytes"] for r in rows) / eff, 4)
        return out
