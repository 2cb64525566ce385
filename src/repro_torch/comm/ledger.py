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
    Billing a round at fewer participants, against a PlanFamily member,
    arrives with the multi-worker slice (ROADMAP §A slice 2)."""
    entries: List[LedgerEntry] = field(default_factory=list)
    steps: int = 0
    rounds: int = 0          # exchange rounds actually executed
    sim_clock_s: float = 0.0  # accumulated simulated wall clock
    n_workers: int = 0       # fleet size M (0 = unknown)
    cum_wire: float = 0.0
    cum_carried: float = 0.0
    budget_bytes: float = 0.0  # delta_budget payload target/worker (0 = none)

    # -- registration ------------------------------------------------------- #
    def register(self, tag, strategy, comp: C.Compressor, shape,
                 n_workers: int, fallback: bool = False, bucket: int = -1,
                 skipped: bool = False):
        """Record one per-step exchange entry."""
        self.entries.append(LedgerEntry(
            tag=tag, strategy=strategy, compressor=comp.name,
            elems=math.prod(shape), n_workers=n_workers,
            wire_bytes=strategy_wire_bytes(strategy, comp, shape, n_workers),
            carried_bytes=strategy_wire_bytes(strategy, comp, shape,
                                              n_workers, carried=True),
            fallback=fallback, bucket=bucket, skipped=skipped,
        ))

    @classmethod
    def from_plan(cls, layout: BucketLayout, plan: CommPlan, strategy: str,
                  n_workers: int, base_compressor: str,
                  leaf_plans: Optional[list] = None,
                  budget_bytes: float = 0.0) -> "CommLedger":
        """Ledger for the bucketed path: one entry per bucket (its assigned
        compressor) + one per skipped leaf on the per-tensor path.
        ``leaf_plans`` are the exchange.plan_leaf dicts of the skipped
        leaves; without them they are billed as sim fallbacks
        (full-precision wire). ``budget_bytes`` is the delta_budget target
        the per-bucket rows report utilization against."""
        led = cls(n_workers=max(n_workers, 1),
                  budget_bytes=float(budget_bytes))
        W = max(n_workers, 2)  # collective multipliers degenerate at W=1
        for b, a in zip(layout.buckets, plan.assignments):
            led.register(f"bucket/{b.bid}", strategy, C.get(a.compressor),
                         (b.size,), W, bucket=b.bid)
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
    def tick(self, n: int = 1, exchanged: bool = True, wall_s: float = 0.0):
        """Advance `n` steps; ``exchanged=False`` records steps that moved
        no bytes; ``wall_s`` adds simulated wall clock."""
        self.steps += n
        if exchanged:
            self.rounds += n
            self.cum_wire += n * self.wire_bytes_per_step
            self.cum_carried += n * self.carried_bytes_per_step
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

    def per_bucket(self) -> list:
        """One row per comm bucket: bits, payload, analytic δ and, under a
        budget, its share of the budget."""
        rows = []
        for e in self.entries:
            if e.bucket < 0:
                continue
            comp = C.get(e.compressor)
            payload = int(comp.wire_bytes((e.elems,)))
            row = {
                "bucket": e.bucket,
                "compressor": e.compressor,
                "bits": getattr(comp, "bits", None),
                "elems": e.elems,
                "payload_bytes": payload,
                "wire_bytes": round(e.wire_bytes, 1),
                "delta": round(analytic_delta(comp, e.elems), 4),
            }
            if self.budget_bytes:
                row["budget_share"] = round(payload / self.budget_bytes, 4)
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
        rows = self.per_bucket()
        if rows:
            out["per_bucket"] = rows
            if self.budget_bytes:
                out["budget_bytes"] = round(self.budget_bytes)
                out["budget_utilization"] = round(
                    sum(r["payload_bytes"] for r in rows)
                    / self.budget_bytes, 4)
        return out
