"""Versioned parameter server: bounded-staleness push/pull.
(Counterpart of `repro.sched.server`: numpy only, copied, not
imported.)

The paper states its convergence and linear-speedup results in the
parameter-server model; lockstep collectives cover at most one step of
staleness. This module is the server-side half of the τ>1
generalization:

  * `VersionedServer` — the host-side semantics object. The server holds
    parameters at an integer version (one version per applied round);
    each worker `pull`s the current version, computes, and `push`es a
    message tagged with its pull version. A push whose staleness
    (server version − pull version) exceeds τ violates the bounded-
    staleness contract and raises — the scheduler (or the SSP gate in
    `simulate_push_pull`) must block the worker first.

  * `simulate_push_pull` — the event-driven wall-clock model behind
    `sched.clock`'s ``server`` dataflow. Workers run at their own seeded
    straggler pace; round r's aggregate becomes available t_exchange
    after its last participant pushed; worker m may start local step s
    only once round s−τ−1 has been applied (the SSP gate), which bounds
    every applied contribution's staleness by τ. Larger τ gives
    stragglers more slack to absorb (wall-clock win) at the price of
    staler contributions (convergence loss) — the frontier
    `benchmarks.run --only sched` sweeps.

The in-step dataflow that mirrors this over the workers — the pending
ring buffer and per-worker version vector under `DQState.sched` — lives
in `core.dqgan`; both sides agree that steady-state staleness is exactly
τ under full participation, and that a skipped round extends a worker's
staleness (content clamped at τ by folding ring overflow into EF).

Everything here is host-side numpy, deterministic in (times, τ, seed).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Set

import numpy as np

from . import participation as part


class StalenessBoundExceeded(RuntimeError):
    """A push violated the bounded-staleness contract (staleness > τ)."""


@dataclass
class VersionedServer:
    """Versioned parameter store, one version per applied round.

    Rounds aggregate: round r applies (version r → r+1) once `n_round`
    DISTINCT workers have pushed into it (a duplicate push from the same
    worker lands in the same round's aggregate and does not advance the
    round). `pull` hands out the current version; `push` validates the
    bounded-staleness contract.
    """
    n_workers: int
    tau: int
    n_round: Optional[int] = None     # pushes per round (participation); M
    version: int = 0                  # applied rounds so far
    # derived in __post_init__ — not constructor arguments
    pull_versions: List[int] = field(default_factory=list, init=False)
    push_counts: List[int] = field(default_factory=list, init=False)
    _round_pushed: Set[int] = field(default_factory=set, init=False)

    def __post_init__(self):
        if self.tau < 1:
            raise ValueError(f"tau must be >= 1, got {self.tau}")
        if self.n_round is None:
            self.n_round = self.n_workers
        if not 1 <= self.n_round <= self.n_workers:
            raise ValueError(f"n_round must be in [1, {self.n_workers}]")
        self.pull_versions = [0] * self.n_workers
        self.push_counts = [0] * self.n_workers

    # ------------------------------------------------------------------ #
    def pull(self, worker: int) -> int:
        """Worker reads the current parameters; returns their version."""
        self.pull_versions[worker] = self.version
        return self.version

    def staleness(self, worker: int) -> int:
        """Versions the worker's last pull is behind the server."""
        return self.version - self.pull_versions[worker]

    def can_push(self, worker: int) -> bool:
        """Would a push from this worker satisfy the τ bound?"""
        return self.staleness(worker) <= self.tau

    def push(self, worker: int) -> int:
        """Apply one message from `worker` (tagged with its last pull
        version). Returns the observed staleness; raises
        StalenessBoundExceeded past τ — the caller must re-pull/block
        first, exactly what the SSP gate in `simulate_push_pull` (and the
        synchronous pipeline in `core.dqgan`) guarantees never happens."""
        stale = self.staleness(worker)
        if stale > self.tau:
            raise StalenessBoundExceeded(
                f"worker {worker} pushed at staleness {stale} > tau={self.tau}"
                " — pull before pushing")
        self.push_counts[worker] += 1
        self._round_pushed.add(worker)
        if len(self._round_pushed) >= self.n_round:
            self._round_pushed.clear()
            self.version += 1
        return stale


# --------------------------------------------------------------------------- #
def simulate_push_pull(times: np.ndarray, t_exchange: float, tau: int,
                       participation: float = 1.0, seed: int = 0) -> dict:
    """Event-driven bounded-staleness PS loop over `times` ((steps, M)
    per-step per-worker compute seconds).

    Dataflow: worker m's step s starts at
        start[s,m] = max(finish[s-1,m], apply[s-1-τ])
    (the SSP gate: the parameters it pulls already contain round s−1−τ,
    so every contribution it pushes lands within τ rounds of its pull);
    round r's aggregate is available at
        apply[r] = max over round-r participants of finish[r,m] + T_ex
    — pushes overlap later compute, only the aggregate's arrival gates.
    Partial participation drops the sampled-out workers from the round's
    max (their message rides EF, as in the in-step runtime).

    Returns the `sched.clock.simulate` dict plus per-step staleness
    statistics (max/mean over applied contributions), with
    max ≤ τ guaranteed by construction under full participation.
    """
    if tau < 1:
        raise ValueError(f"tau must be >= 1, got {tau}")
    steps, M = times.shape
    n_part = part.n_participants(participation, M)
    rng = np.random.RandomState(seed + 2)

    start = np.zeros((steps, M))
    finish = np.zeros((steps, M))
    apply_t = np.zeros(steps)          # round r aggregate available
    part_masks = np.ones((steps, M), bool)
    for s in range(steps):
        if n_part < M:
            part_masks[s] = False
            part_masks[s, part.host_round_participants(rng, M, n_part)] = True
        gate = apply_t[s - 1 - tau] if s - 1 - tau >= 0 else 0.0
        start[s] = np.maximum(finish[s - 1] if s else 0.0, gate)
        finish[s] = start[s] + times[s]
        ready = finish[s][part_masks[s]].max() + t_exchange
        # versions apply IN ORDER: round s's aggregate may be ready before
        # a straggler-gated earlier round (possible under partial
        # participation), but the server only bumps s once every r <= s is
        # applied — this keeps apply_t monotone, which the staleness
        # bookkeeping below (searchsorted) relies on.
        apply_t[s] = max(ready, apply_t[s - 1]) if s else ready

    # staleness of worker m's round-s contribution: s − (rounds applied by
    # its pull at start[s,m]); the gate makes that ≤ τ for participants.
    stale = np.empty((steps, M))
    for m in range(M):
        pulled = np.searchsorted(apply_t, start[:, m], side="right")
        stale[:, m] = np.arange(steps) - np.minimum(pulled, np.arange(steps))
    stale_part = stale[part_masks]

    makespan = finish.max(axis=1)
    per_step = np.diff(np.concatenate([[0.0], makespan]))
    total = float(makespan[-1] + t_exchange) if steps else 0.0  # drain
    return {
        "per_step_s": per_step,
        "total_s": total,
        "mean_step_s": total / max(steps, 1),
        "n_exchanges": steps,
        "tau": tau,
        "staleness_max": float(stale_part.max()) if steps else 0.0,
        "staleness_mean": float(stale_part.mean()) if steps else 0.0,
    }
