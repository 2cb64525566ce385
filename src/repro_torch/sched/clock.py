"""Simulated wall clock: schedule × stragglers × wire bytes.
(Counterpart of `repro.sched.clock`: numpy only, copied, not
imported.)

The paper's linear-speedup claim is about time, but the repo's benchmarks
only modeled the homogeneous lockstep case (`T(M) = T₁/M + T_comm`). This
module composes the three things that actually set the clock:

  * per-worker compute times from a seeded `straggler.StragglerProfile`,
  * per-exchange wire time from `comm.ledger` byte counts over a
    `LinkModel` (bandwidth + per-collective latency),
  * the `ExchangeSchedule` dataflow, which decides what gates what:

      every_step : every step is a barrier over the round's participants,
                   then the collective — cost = max_m(compute) + T_ex.
      local_k    : workers run K steps unsynchronized, barrier once —
                   cost/round = max_m(Σ_K compute) + T_ex. The max of
                   sums is below the sum of maxes (jitter averages out
                   *within* a worker before the barrier), and T_ex is
                   paid once per K.
      delayed    : the collective for step t-1 overlaps compute of step
                   t — cost = max(max_m(compute), T_ex), plus a one-time
                   pipeline fill/drain of T_ex.
      server     : the bounded-staleness push/pull loop (`sched.server`,
                   DESIGN.md §8) — no per-step barrier at all; worker m's
                   step s only waits for round s−1−τ's aggregate. The
                   default for delayed(τ>1); `dataflow="server"` forces
                   it for any τ (the τ∈{1,2,4,8} frontier sweep).

Partial participation gates the barrier on the sampled participants only
(non-participants are assumed to overlap their local work; their later
rounds are not penalized — a deliberate idealization, noted here so the
benchmark numbers are read correctly).

Everything is host-side numpy, deterministic in (profile, M, steps, seed).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import participation as part
from . import straggler as strag
from .schedule import ExchangeSchedule
from .server import simulate_push_pull


@dataclass(frozen=True)
class LinkModel:
    """Per-worker network link: the PS-uplink regime of the paper's Fig 4
    (at NVLink speeds compression — and scheduling — is moot)."""
    bandwidth_Bps: float = 1e9
    latency_s: float = 1e-4      # per-collective constant term

    def exchange_time(self, bytes_per_worker: float) -> float:
        if bytes_per_worker <= 0:
            return 0.0
        return self.latency_s + bytes_per_worker / self.bandwidth_Bps

    @classmethod
    def from_dict(cls, d: dict) -> "LinkModel":
        """Build from a calibration payload (`repro.obs.calibrate` output
        or any dict carrying the two link constants)."""
        return cls(bandwidth_Bps=float(d["bandwidth_Bps"]),
                   latency_s=float(d["latency_s"]))


def load_calibration(path: str):
    """(LinkModel, full payload) from a calibration JSON written by
    ``python -m repro.obs calibrate --out PATH`` (DESIGN.md §12.3). The
    payload carries ``t_compute_s`` and the per-run drift table beyond
    the link constants."""
    import json
    with open(path) as fh:
        d = json.load(fh)
    return LinkModel.from_dict(d), d


def simulate(schedule: ExchangeSchedule, times: np.ndarray,
             t_exchange: float, participation: float = 1.0,
             seed: int = 0, dataflow: str = "auto") -> dict:
    """Walk `times` ((steps, M) per-step per-worker compute seconds)
    through the schedule's dataflow. Returns per-step and total simulated
    seconds plus the exchange count.

    ``dataflow`` picks the cost model: "auto" keeps the synchronous
    models below for every_step/local_k/delayed(1) and routes
    delayed(τ>1) to the bounded-staleness push/pull loop;
    "server" forces the push/pull loop (sched.server) for any τ;
    "sync" forces the synchronous pipelined model."""
    if dataflow not in ("auto", "sync", "server"):
        raise ValueError(f"unknown dataflow {dataflow!r}")
    if dataflow == "server" and schedule.name != "delayed":
        raise ValueError(
            f"dataflow='server' models the bounded-staleness push/pull "
            f"loop, which only the 'delayed' schedule runs — got "
            f"{schedule.describe()}")
    if dataflow == "server" or (dataflow == "auto"
                                and schedule.name == "delayed"
                                and schedule.tau > 1):
        return simulate_push_pull(times, t_exchange, schedule.tau,
                                  participation, seed)
    steps, M = times.shape
    n_part = part.n_participants(participation, M)
    rng = np.random.RandomState(seed + 2)
    per_step = np.zeros(steps)
    n_exchanges = 0
    K = schedule.period

    for r0 in range(0, steps, K):
        r1 = min(r0 + K, steps)
        if n_part < M:
            who = part.host_round_participants(rng, M, n_part)
        else:
            who = slice(None)
        block = times[r0:r1, who]
        if schedule.name == "local_k":
            # no barrier inside the round: each worker sums its own steps
            gate = float(block.sum(axis=0).max())
            t_ex = t_exchange if r1 - r0 == K else 0.0  # partial tail round
            n_exchanges += r1 - r0 == K
            per_step[r0:r1] = (gate + t_ex) / (r1 - r0)
        elif schedule.name == "delayed":
            gate = float(block.max(axis=1)[0])
            # steady state: comm for the previous step hides under compute
            per_step[r0] = gate if r0 == 0 else max(gate, t_exchange)
            n_exchanges += 1
        else:  # every_step
            per_step[r0] = float(block.max(axis=1)[0]) + t_exchange
            n_exchanges += 1

    total = float(per_step.sum())
    if schedule.name == "delayed" and steps > 0:
        total += t_exchange  # drain the last in-flight collective
    return {
        "per_step_s": per_step,
        "total_s": total,
        "mean_step_s": total / max(steps, 1),
        "n_exchanges": n_exchanges,
    }


def time_per_step(schedule: ExchangeSchedule, profile: strag.StragglerProfile,
                  M: int, steps: int, t_compute_single: float,
                  bytes_per_exchange: float, link: LinkModel = LinkModel(),
                  participation: float = 1.0, seed: int = 0,
                  dataflow: str = "auto") -> dict:
    """Mean simulated seconds/step for M workers splitting a fixed global
    batch (per-worker compute = t_compute_single / M), under `profile`.
    `bytes_per_exchange` is the per-worker wire cost of ONE exchange
    (e.g. `CommLedger.wire_bytes_per_step` or
    `exchange.modeled_wire_bytes`); pass 0 for M == 1."""
    times = strag.step_times(profile, M, steps, seed,
                             base=t_compute_single / M)
    t_ex = link.exchange_time(bytes_per_exchange) if M > 1 else 0.0
    out = simulate(schedule, times, t_ex, participation, seed, dataflow)
    out["t_exchange_s"] = t_ex
    return out


def baseline_mean_step(profile: strag.StragglerProfile, steps: int,
                       t_compute_single: float,
                       link: LinkModel = LinkModel(), seed: int = 0) -> float:
    """Mean seconds/step of the M=1 run (no comm). With one worker every
    schedule degenerates to the same compute-only walk, so this baseline
    is shared across schedules AND compressors — compute it once per
    (profile, steps, t_compute, seed) and pass it to `speedup_vs_M`
    instead of re-simulating it per sweep (the `benchmarks.run --only
    sched` quick tier halves its work this way)."""
    return time_per_step(ExchangeSchedule("every_step"), profile, 1, steps,
                         t_compute_single, 0.0, link, 1.0,
                         seed)["mean_step_s"]


def speedup_vs_M(schedule: ExchangeSchedule, profile: strag.StragglerProfile,
                 Ms, steps: int, t_compute_single: float, bytes_fn,
                 link: LinkModel = LinkModel(), participation: float = 1.0,
                 seed: int = 0, base: float = 0.0,
                 dataflow: str = "auto") -> list:
    """Speedup rows for a worker-count sweep. `bytes_fn(M)` gives the
    per-worker wire bytes of one exchange at that M. The M=1 run (same
    profile, no comm) is the baseline; pass it via `base` (from
    `baseline_mean_step`) when sweeping several schedules/compressors so
    it is not re-simulated once per sweep."""
    if not base:
        base = baseline_mean_step(profile, steps, t_compute_single, link,
                                  seed)
    rows = []
    for M in Ms:
        if M == 1:
            # the baseline IS the M=1 point (no comm, every schedule
            # walks the same compute times) — reuse it, don't re-simulate
            rows.append({
                "M": 1,
                "mean_step_s": base,
                "t_exchange_s": 0.0,
                "n_exchanges": schedule.exchanges_in(steps),
                "speedup": 1.0,
            })
            continue
        sim = time_per_step(schedule, profile, M, steps, t_compute_single,
                            bytes_fn(M), link, participation, seed, dataflow)
        rows.append({
            "M": M,
            "mean_step_s": sim["mean_step_s"],
            "t_exchange_s": sim["t_exchange_s"],
            "n_exchanges": sim["n_exchanges"],
            "speedup": base / sim["mean_step_s"],
        })
    return rows
