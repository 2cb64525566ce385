"""Wall-clock calibration: fit the modeled clock to measured runs (a copy
of `repro.obs.calibrate` over the port's `strategy` and `sched`).

    PYTHONPATH=src python -m repro_torch.obs calibrate run.jsonl [...]

`sched.clock` prices a run with three constants it has no way to know:
the per-worker compute time, the link bandwidth and the per-collective
latency. This module recovers them from recorded sink files — the
``timing``/``profile`` events are device-synced measurements, the
``run_meta`` strategy tells the cost model which dataflow produced them,
and the ``comm_summary`` wire bytes price the exchange — then reports
how far the calibrated model drifts from what was measured.

The fit: for the *linear* schedules the modeled mean step time is

    t̄ = g·t_c + n_ex·(latency + B·inv_bw)

where ``g`` is the schedule×straggler compute-gate factor (simulated
with unit compute and zero comm — deterministic in the strategy),
``n_ex`` the exchanges per step (1 for every_step, 1/K for local_k, 0
for W=1) and ``B`` the per-worker wire bytes of one exchange. Runs at
different schedules / byte counts give a least-squares system in
(t_c, latency, inv_bw). ``delayed`` overlaps comm under compute
(max(), not +) — nonlinear, so it is excluded from the fit but included
in the drift evaluation through the full `sched.clock.simulate`.

Degenerate inputs degrade explicitly (the ``method`` field says which
path fired): 3 independent rows → full ``lstsq3``; rank 2 → latency
pinned at the `LinkModel` default (``fixed_latency``); a single run →
compute floor from the minimum step wall and bandwidth from the mean's
residual (``residual`` — coarse, but enough for a smoke drift gate).

The output JSON is simultaneously a schema-v2 ``calibration`` event and
the file `sched.clock.load_calibration` consumes. All runs being fit
together are assumed to share one compute workload (same arch / batch /
device class); calibrate per-arch otherwise.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.obs import cli
from repro_torch.obs.sink import SCHEMA_VERSION, validate_event

# cap on simulated steps for gate/drift evaluation — the cost models are
# O(steps·M) numpy; beyond a few hundred steps the gate factor has
# converged for every profile the repo ships
_SIM_STEPS_CAP = 512


# --------------------------------------------------------------------------- #
# extraction: sink events -> run samples
# --------------------------------------------------------------------------- #
@dataclass
class RunSample:
    """One recorded run, reduced to what the cost model speaks."""
    strategy_json: dict
    n_workers: int
    steps: int
    measured_step_s: float       # robust (trimmed-mean) per-step wall
    measured_min_s: float        # the no-jitter floor
    wire_bytes: float            # per-worker bytes of ONE exchange
    n_samples: int
    source: str                  # "profile" | "timing"

    # derived lazily (need the strategy / sched imports)
    def schedule(self):
        from repro_torch.strategy import Strategy
        return Strategy.from_dict(self.strategy_json)

    def cost_inputs(self):
        """(ExchangeSchedule, StragglerProfile, participation)."""
        strat = self.schedule()
        return (strat.schedule.runtime(), strat.participation.profile(),
                strat.participation.fraction)


def _trimmed_mean(walls: List[float]) -> float:
    """Mean of the samples excluding gross outliers (> 3× median) — one
    compile-step wall in the window must not poison the calibration."""
    med = float(np.median(walls))
    kept = [w for w in walls if w <= 3.0 * med] or list(walls)
    return float(np.mean(kept))


def extract_runs(events: List[dict]) -> List[RunSample]:
    """Split a sink event stream at each ``run_meta`` and reduce every
    complete run to a `RunSample`. Runs without a strategy or without
    any measured step are dropped."""
    runs: List[RunSample] = []
    segment: List[dict] = []
    for ev in events:
        if ev.get("kind") == "run_meta" and segment:
            s = _reduce(segment)
            if s is not None:
                runs.append(s)
            segment = []
        segment.append(ev)
    if segment:
        s = _reduce(segment)
        if s is not None:
            runs.append(s)
    return runs


def _reduce(segment: List[dict]) -> Optional[RunSample]:
    meta = next((e for e in segment if e.get("kind") == "run_meta"), None)
    if meta is None or not isinstance(meta.get("strategy_json"), dict):
        return None
    walls: List[float] = []
    source = "timing"
    profiles = [e for e in segment if e.get("kind") == "profile"]
    if profiles:
        # the profiled window holds every per-step wall — the richest
        # measurement; fall through to sparse timing samples without it
        walls = [float(w) for p in profiles
                 for w in p.get("step_walls_s", [])]
        source = "profile"
    if not walls:
        walls = [float(e["step_s"]) for e in segment
                 if e.get("kind") == "timing"]
    if not walls:
        return None
    comm = next((e for e in reversed(segment)
                 if e.get("kind") == "comm_summary"), None)
    W = int(meta.get("n_workers", 1) or 1)
    wire = float(comm.get("wire_bytes_per_step", 0.0)) if comm else 0.0
    return RunSample(
        strategy_json=meta["strategy_json"],
        n_workers=W,
        steps=int(meta.get("steps", len(walls)) or len(walls)),
        measured_step_s=_trimmed_mean(walls),
        measured_min_s=float(min(walls)),
        wire_bytes=wire if W > 1 else 0.0,
        n_samples=len(walls),
        source=source,
    )


# --------------------------------------------------------------------------- #
# the fit
# --------------------------------------------------------------------------- #
def _sim_steps(run: RunSample) -> int:
    return int(min(max(run.steps, 8), _SIM_STEPS_CAP))


def gate_factor(run: RunSample, seed: int = 0) -> float:
    """Schedule×straggler compute-gate multiplier: mean simulated step
    at unit compute and zero comm. 1.0 for a homogeneous lockstep run;
    > 1 under stragglers (the barrier waits for the max)."""
    from repro_torch.sched import clock as sclock
    from repro_torch.sched import straggler as strag
    sched, profile, particip = run.cost_inputs()
    times = strag.step_times(profile, max(run.n_workers, 1),
                             _sim_steps(run), seed, base=1.0)
    return float(sclock.simulate(sched, times, 0.0, particip,
                                 seed)["mean_step_s"])


def _row(run: RunSample, seed: int = 0) -> Optional[tuple]:
    """(g, n_ex, B) for the linear model, or None when this schedule's
    clock is nonlinear in the constants (delayed: comm hides under
    compute via max())."""
    sched, _, _ = run.cost_inputs()
    if sched.name == "delayed" and run.n_workers > 1:
        return None
    g = gate_factor(run, seed)
    n_ex = (1.0 / sched.period) if run.n_workers > 1 else 0.0
    return (g, n_ex, run.wire_bytes)


def fit(runs: List[RunSample], seed: int = 0) -> dict:
    """Recover (t_compute_s, latency_s, bandwidth_Bps) from run samples.
    Returns the constants plus the ``method`` that produced them."""
    from repro_torch.sched.clock import LinkModel
    default = LinkModel()
    rows, ts = [], []
    for r in runs:
        lin = _row(r, seed)
        if lin is not None:
            rows.append(lin)
            ts.append(r.measured_step_s)
    if not rows:
        raise ValueError(
            "calibrate: no linear-schedule runs to fit (delayed-only "
            "input) — record at least one every_step or local_k run")
    A = np.array([[g, n, n * b] for g, n, b in rows])
    b = np.array(ts)
    method = None
    t_c = lat = inv_bw = 0.0
    if np.linalg.matrix_rank(A) >= 3:
        x = np.linalg.lstsq(A, b, rcond=None)[0]
        t_c, lat, inv_bw = (float(x[0]), max(float(x[1]), 0.0),
                            max(float(x[2]), 0.0))
        method = "lstsq3"
    if method is None:
        # rank 2: pin latency at the default, solve (t_c, inv_bw)
        A2 = A[:, [0, 2]]
        if np.linalg.matrix_rank(A2) >= 2:
            lat = default.latency_s
            b2 = b - A[:, 1] * lat
            x = np.linalg.lstsq(A2, b2, rcond=None)[0]
            t_c, inv_bw = float(x[0]), max(float(x[1]), 0.0)
            method = "fixed_latency"
    if method is None:
        # single/degenerate run: compute floor from the minimum wall,
        # bandwidth from the residual of the most comm-heavy run
        lat = default.latency_s
        t_c = min(r.measured_min_s for r in runs)
        heavy = max(zip(rows, ts), key=lambda rt: rt[0][1] * rt[0][2])
        (g, n, B), t_meas = heavy
        inv_bw = (max(t_meas - g * t_c - n * lat, 0.0) / (n * B)
                  if n * B > 0 else 0.0)
        method = "residual"
    if t_c <= 0:
        # a negative compute intercept means the inputs contradict the
        # model; clamp to the observed floor rather than emit nonsense
        t_c = min(r.measured_min_s for r in runs)
        method += "+tc_floor"
    bw = (1.0 / inv_bw) if inv_bw > 0 else default.bandwidth_Bps
    return {"t_compute_s": t_c, "latency_s": lat, "bandwidth_Bps": bw,
            "method": method, "n_fit_runs": len(rows)}


# --------------------------------------------------------------------------- #
# drift: calibrated model vs every measured run
# --------------------------------------------------------------------------- #
def modeled_step_s(run: RunSample, t_compute_s: float, link,
                   seed: int = 0) -> float:
    """Mean step the calibrated `sched.clock` predicts for this run —
    the FULL simulate (delayed's overlap included), not the linear fit
    surrogate."""
    from repro_torch.sched import clock as sclock
    from repro_torch.sched import straggler as strag
    sched, profile, particip = run.cost_inputs()
    W = max(run.n_workers, 1)
    times = strag.step_times(profile, W, _sim_steps(run), seed,
                             base=t_compute_s)
    t_ex = link.exchange_time(run.wire_bytes) if W > 1 else 0.0
    return float(sclock.simulate(sched, times, t_ex, particip,
                                 seed)["mean_step_s"])


def calibrate(runs: List[RunSample], seed: int = 0) -> dict:
    """fit + per-run drift. The returned dict is a valid schema-v2
    ``calibration`` event AND the `sched.clock.load_calibration` file
    format."""
    from repro_torch.sched.clock import LinkModel
    constants = fit(runs, seed)
    link = LinkModel(bandwidth_Bps=constants["bandwidth_Bps"],
                     latency_s=constants["latency_s"])
    rows = []
    drifts = []
    for r in runs:
        modeled = modeled_step_s(r, constants["t_compute_s"], link, seed)
        drift = (modeled / r.measured_step_s - 1.0
                 if r.measured_step_s else 0.0)
        drifts.append(abs(drift))
        sched, _, _ = r.cost_inputs()
        rows.append({
            "schedule": sched.describe(),
            "n_workers": r.n_workers,
            "wire_bytes": r.wire_bytes,
            "n_samples": r.n_samples,
            "source": r.source,
            "measured_step_s": round(r.measured_step_s, 6),
            "modeled_step_s": round(modeled, 6),
            "drift": round(drift, 4),
        })
    out = {"v": SCHEMA_VERSION, "kind": "calibration"}
    out.update(constants)
    out["n_runs"] = len(runs)
    out["runs"] = rows
    out["max_abs_drift"] = round(max(drifts), 4) if drifts else 0.0
    validate_event(out)
    return out


# --------------------------------------------------------------------------- #
def render(cal: dict) -> str:
    lines = [
        f"calibrated constants ({cal['method']}, "
        f"{cal['n_fit_runs']}/{cal['n_runs']} runs in fit):",
        f"  t_compute  {cal['t_compute_s'] * 1e3:10.3f} ms/step",
        f"  latency    {cal['latency_s'] * 1e6:10.1f} us/collective",
        f"  bandwidth  {cal['bandwidth_Bps'] / 1e9:10.3f} GB/s",
        "",
        "measured vs modeled (mean step):",
    ]
    for r in cal["runs"]:
        lines.append(
            f"  {r['schedule']:<18} W={r['n_workers']:<3} "
            f"{r['wire_bytes'] / 1e6:8.3f}MB/ex  "
            f"measured {r['measured_step_s'] * 1e3:8.2f}ms  "
            f"modeled {r['modeled_step_s'] * 1e3:8.2f}ms  "
            f"drift {r['drift'] * 100:+6.1f}%")
    lines.append("")
    lines.append(f"max |drift| = {cal['max_abs_drift'] * 100:.1f}%")
    return "\n".join(lines)


DESCRIPTION = ("fit sched.clock LinkModel + compute constants from "
               "recorded run-sink files and report modeled-vs-measured "
               "drift")


def add_args(ap: argparse.ArgumentParser) -> None:
    """Mount the calibrate arguments (shared IO contract: repro_torch.obs.cli)."""
    ap.add_argument("paths", nargs="+",
                    help="sink JSONL file(s) written by --obs-sink PATH "
                         "(fit jointly — same arch/batch assumed)")
    ap.add_argument("--max-drift", type=float, default=0.0, metavar="F",
                    help="fail (exit 3) when max |drift| exceeds this "
                         "fraction, e.g. 0.5 = 50%% (0 = report only)")
    cli.add_io_args(ap, out_help="write the calibration JSON here (a "
                                 "schema-v2 calibration event; "
                                 "sched.clock.load_calibration reads it)")


def run(args: argparse.Namespace) -> int:
    events = cli.read_paths(args.paths, validate=not args.no_validate)
    runs = extract_runs(events)
    if not runs:
        print("calibrate: no complete runs (run_meta + timing/profile "
              "events) in input")
        return 2
    cal = calibrate(runs)
    cli.emit(args, cal, render(cal))
    if args.max_drift and cal["max_abs_drift"] > args.max_drift:
        print(f"calibrate: DRIFT GATE FAILED — max |drift| "
              f"{cal['max_abs_drift']:.3f} > {args.max_drift:.3f}")
        return 3
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs calibrate",
                                 description=DESCRIPTION)
    add_args(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    raise SystemExit(main())
