"""Exchange schedules: WHEN the workers of Algorithm 2 talk.
(Counterpart of `repro.sched.schedule`: numpy only, copied, not
imported.)

The seed repo ran one lockstep compressed exchange per step. That is one
point in a schedule space that QODA (layer-wise quantized optimistic dual
averaging) and delayed/overlapped extra-gradient methods show is as
decisive for wall-clock time as the bits on the wire. `ExchangeSchedule`
names the point; `core.dqgan` implements the per-step dataflow; this
module holds the host-side arithmetic (which step exchanges, how many
rounds a run has) used by the launcher, the ledger and the wall-clock
model.

Schedules
---------
every_step : exchange at every step — the seed semantics, the default.
local_k    : exchange every K steps. Between rounds the per-worker message
             (η·g, plus EF at compression time) accumulates into
             `DQState.sched["accum"]`; params and server-side state only
             move at round boundaries. `local_k=1` is bit-exact
             `every_step` (the accumulator is 0 + message).
delayed    : bounded-staleness exchange with pipeline depth τ (>= 1).
             Step t compresses and averages the message produced at step
             t-τ — the oldest slot of the `DQState.sched["pending"]` ring
             buffer — while step t's field evaluation proceeds. With
             `exchange.overlap=True` that exchange starts before the
             field (a side CUDA stream on the card), as the JAX
             package issues it. The OMD extrapolation
             subtracts the SUM of the worker's pending (not-yet-applied)
             messages as the staleness correction (the τ-step recursion).
             τ=1 keeps the single-slot layout (W, *shape).

`is_exchange_step` takes the 0-based step index; with `local_k` the
exchange fires on steps K-1, 2K-1, ... so every round closes with one.

The typed front-end is `repro_torch.strategy.Schedule` —
constructors `every_step()`/`local_k(K)`/`delayed(tau)` whose
`.runtime()` resolves to an `ExchangeSchedule` here; the in-step
dataflow (accumulate / ring-shift / staleness correction) lives on that
component, used by `core.dqgan`'s stacked step.
"""
from __future__ import annotations

from dataclasses import dataclass

SCHEDULES = ("every_step", "local_k", "delayed")


@dataclass(frozen=True)
class ExchangeSchedule:
    """A named point in (exchange cadence × staleness) space."""
    name: str
    local_k: int = 1
    tau: int = 1

    def __post_init__(self):
        if self.name not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.name!r}; choose from {SCHEDULES}")
        if self.local_k < 1:
            raise ValueError(f"local_k must be >= 1, got {self.local_k}")
        if self.name != "local_k" and self.local_k != 1:
            raise ValueError(
                f"local_k={self.local_k} only meaningful with the "
                f"'local_k' schedule, not {self.name!r}")
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.name != "delayed" and self.tau != 1:
            raise ValueError(
                f"tau={self.tau} only meaningful with the 'delayed' "
                f"schedule, not {self.name!r}")

    # ------------------------------------------------------------------ #
    @property
    def staleness(self) -> int:
        """Steps between producing a message and applying its average."""
        return self.tau if self.name == "delayed" else 0

    @property
    def period(self) -> int:
        """Steps per exchange round."""
        return self.local_k if self.name == "local_k" else 1

    def is_exchange_step(self, step: int) -> bool:
        """Does 0-based step `step` run the collective?"""
        return (step + 1) % self.period == 0

    def round_index(self, step: int) -> int:
        """Which exchange round 0-based step `step` belongs to."""
        return step // self.period

    def exchanges_in(self, steps: int) -> int:
        """Number of collectives over `steps` training steps."""
        return steps // self.period

    def describe(self) -> str:
        if self.name == "local_k":
            return f"local_k(K={self.local_k})"
        if self.name == "delayed" and self.tau > 1:
            return f"delayed(tau={self.tau})"
        return self.name


def get(name: str, local_k: int = 1, tau: int = 1) -> ExchangeSchedule:
    """Resolve a schedule by name (+ K for 'local_k', τ for 'delayed')."""
    if name == "local_k":
        return ExchangeSchedule("local_k", local_k)
    if name == "delayed":
        return ExchangeSchedule("delayed", tau=tau)
    return ExchangeSchedule(name)


def seeded_tau_vector(tau_max: int, n_workers: int, seed: int = 0) -> tuple:
    """Seeded heterogeneous per-worker pull cadences τ_m ∈ {1..τ_max} for
    `Schedule.delayed(tau_max, tau_vector=...)` — deterministic in
    (τ_max, M, seed), with max(τ_m) pinned to τ_max so the ring depth is
    exactly what the schedule advertises. Mirrors the straggler profiles'
    host-side seeding discipline: the training step only ever sees the
    resulting static tuple."""
    import numpy as np
    if tau_max < 1:
        raise ValueError(f"tau_max must be >= 1, got {tau_max}")
    rs = np.random.RandomState(seed)
    taus = rs.randint(1, tau_max + 1, size=n_workers)
    taus[rs.randint(n_workers)] = tau_max  # the ring depth is max τ_m
    return tuple(int(t) for t in taus)
