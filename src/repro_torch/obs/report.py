"""Render a run-sink JSONL file (a copy of `repro.obs.report`: either
package's report reads either package's sink, with the same output).

    PYTHONPATH=src python -m repro_torch.obs report run_sink.jsonl

Sections (each skipped cleanly when its events are absent):

* **timing** — synced per-step wall times from ``timing`` events: the
  per-step series (mean / min / max) and interval throughput. These are
  real device-synced times (train.py blocks on the step output every
  step), not dispatch latencies.
* **empirical δ vs assumed δ** — joins the last ``obs_metrics`` event's
  per-bucket δ̂ against the analytic per-bucket δ the planner assumed
  (``comm_summary.per_bucket[*].delta``); the gap says how conservative
  the δ-budget plan really is on this gradient stream.
* **bytes vs budget** — payload utilization against the effective byte
  budget, overall and per bucket.
* **EF residual growth** — the fleet ‖e1‖ / ‖e2‖ series across the run;
  unbounded growth here is the classic sign of a divergent
  error-feedback loop (paper Thm. 2 needs it bounded).
* **profile** — the step-profiler window (schema v2 ``profile``
  events): per-window step-wall stats, host-phase split and, when spans
  were on, the device-phase attribution (`obs.profile`: kernels and
  allocated bytes per phase from the profiler here, HLO ops and result
  bytes in the JAX package) and, from the port's phase clock, each
  span's device, device-self and host milliseconds a step and the host
  gap a step, and the launches of each hand-written kernel in those
  steps (`kernels.launch_counts`: B1-B4, B5's forward and backward).
* **measured vs modeled** — when the file holds enough to calibrate
  (run_meta + timing/profile + comm_summary), the report runs
  `repro_torch.obs.calibrate` on its own events and prints the fitted
  constants plus per-run drift (DESIGN.md §12.3).
* **overlap** — when the file holds paired runs whose strategies differ
  only in ``exchange.overlap`` (the split-phase A/B, DESIGN.md §13),
  each pair is reduced by `obs.profile.overlap_ratio`: the step wall
  the overlap lowering hid, and — when the calibration fit supplied a
  compute floor — what fraction of the off-run's exposed exchange wall
  that is.
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from repro_torch.obs import cli


def _series(events: List[dict], kind: str) -> List[dict]:
    return [e for e in events if e.get("kind") == kind]


def _stats(xs: List[float]) -> Dict[str, float]:
    return {"mean": sum(xs) / len(xs), "min": min(xs), "max": max(xs),
            "n": len(xs)}


def summarize(events: List[dict]) -> dict:
    """The report's data model: pure function of the event list so tests
    can assert on it and ``--json`` can dump it."""
    out: dict = {}
    meta = _series(events, "run_meta")
    if meta:
        out["run"] = {k: meta[-1].get(k) for k in
                      ("strategy", "arch", "steps", "n_workers",
                       "obs_metrics")}

    timing = _series(events, "timing")
    if timing:
        steps_s = [e["step_s"] for e in timing]
        out["timing"] = {
            "step_s": _stats(steps_s),
            "intervals": [{"step": e["step"],
                           "interval_s": e["interval_s"],
                           "steps": e.get("steps_in_interval", 1)}
                          for e in timing],
        }

    obs = _series(events, "obs_metrics")
    comm = _series(events, "comm_summary")
    if obs:
        last = obs[-1]
        ef1 = [e["ef_e1_norm"] for e in obs if "ef_e1_norm" in e]
        ef2 = [e["ef_e2_norm"] for e in obs if "ef_e2_norm" in e]
        o: dict = {"last_step": last.get("step"),
                   "delta_hat": last.get("delta_hat")}
        if ef1:
            o["ef_e1"] = {"first": ef1[0], "last": ef1[-1],
                          "growth": (ef1[-1] / ef1[0]
                                     if ef1[0] else None)}
        if ef2:
            o["ef_e2"] = {"first": ef2[0], "last": ef2[-1]}
        if "staleness_hist" in last:
            o["staleness_hist"] = last["staleness_hist"]
        if "msg_var" in last:
            o["msg_mean"] = last.get("msg_mean")
            o["msg_var"] = last["msg_var"]
        out["obs"] = o

        # δ̂ vs the planner's analytic δ, per bucket
        rows = (comm[-1].get("per_bucket") or []) if comm else []
        measured = last.get("bucket_delta")
        if rows and measured is not None:
            out["delta_gap"] = [
                {"bucket": r["bucket"], "compressor": r["compressor"],
                 "assumed": r["delta"], "measured": measured[r["bucket"]],
                 "gap": measured[r["bucket"]] - r["delta"]}
                for r in rows if r["bucket"] < len(measured)]

    if comm:
        last = comm[-1]
        c = {k: last[k] for k in
             ("wire_bytes_per_step", "compression_ratio", "sim_clock_s")
             if k in last}
        if "budget_utilization" in last:
            c["budget_bytes"] = last.get("budget_bytes")
            c["budget_utilization"] = last["budget_utilization"]
        if last.get("per_bucket"):
            c["per_bucket"] = last["per_bucket"]
        out["comm"] = c

    prof = _series(events, "profile")
    if prof:
        out["profile"] = prof[-1]

    # measured-vs-modeled: calibrate on the file's own events (skipped
    # cleanly when the fit has nothing to chew on)
    from repro_torch.obs import calibrate as _cal
    runs = _cal.extract_runs(events)
    if runs:
        try:
            out["calibration"] = _cal.calibrate(runs)
        except (ValueError, KeyError):
            pass  # e.g. delayed-only input: no linear run to fit
        overlap = _overlap_rows(runs, out.get("calibration"))
        if overlap:
            out["overlap"] = overlap
    return out


# --------------------------------------------------------------------------- #
def _sans_overlap(strategy_json: dict) -> str:
    """Pairing key: the strategy JSON with exchange.overlap removed."""
    sj = json.loads(json.dumps(strategy_json))
    if isinstance(sj.get("exchange"), dict):
        sj["exchange"].pop("overlap", None)
    return json.dumps(sj, sort_keys=True)


def _overlap_rows(runs, calibration: Optional[dict]) -> List[dict]:
    """Measured overlap rows (DESIGN.md §13): match recorded runs whose
    strategies differ ONLY in ``exchange.overlap`` and reduce each
    on/off pair with `obs.profile.overlap_ratio`. The exposed exchange
    wall of the off run is estimated as ``t_off - t_compute`` when a
    calibration fit is available; without one the row still reports the
    hidden seconds, just not the fraction."""
    from repro_torch.obs.profile import overlap_ratio
    groups: Dict[tuple, list] = {}
    for r in runs:
        groups.setdefault(
            (_sans_overlap(r.strategy_json), r.n_workers), []).append(r)
    t_c = (calibration or {}).get("t_compute_s")
    rows: List[dict] = []
    for (_, W), grp in sorted(groups.items()):
        def _is_on(r):
            ex = r.strategy_json.get("exchange")
            return bool(isinstance(ex, dict) and ex.get("overlap"))
        on = [r for r in grp if _is_on(r)]
        off = [r for r in grp if not _is_on(r)]
        if not on or not off:
            continue
        a, b = on[-1], off[-1]
        exchange_s = None
        if t_c is not None:
            exchange_s = max(b.measured_step_s - t_c, 0.0) or None
        ratio = overlap_ratio(a.measured_step_s, b.measured_step_s,
                              exchange_s)
        try:
            schedule = a.cost_inputs()[0].describe()
        except Exception:
            schedule = "?"
        rows.append({"schedule": schedule, "n_workers": W,
                     **{k: round(v, 6) for k, v in ratio.items()}})
    return rows


# --------------------------------------------------------------------------- #
def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"


def render(summary: dict) -> str:
    lines: List[str] = []
    run = summary.get("run")
    if run:
        lines.append(f"run {run.get('strategy')}  arch={run.get('arch')}  "
                     f"steps={run.get('steps')}  W={run.get('n_workers')}  "
                     f"obs={run.get('obs_metrics')}")

    t = summary.get("timing")
    if t:
        s = t["step_s"]
        lines.append("")
        lines.append(f"timing (synced): step {s['mean'] * 1e3:.2f}ms mean  "
                     f"[{s['min'] * 1e3:.2f} .. {s['max'] * 1e3:.2f}]  "
                     f"over {s['n']} logged steps")
        for iv in t["intervals"]:
            per = iv["interval_s"] / max(iv["steps"], 1)
            lines.append(f"  step {iv['step']:>6}: interval "
                         f"{iv['interval_s'] * 1e3:8.2f}ms / "
                         f"{iv['steps']} steps = {per * 1e3:.2f}ms/step")

    prof = summary.get("profile")
    if prof:
        s = prof["step_s"]
        lines.append("")
        lines.append(
            f"profile window: steps {prof['step0']}..."
            f"{prof['step0'] + prof['n_steps'] - 1}  "
            f"step {s['mean'] * 1e3:.2f}ms mean  "
            f"[{s['min'] * 1e3:.2f} .. {s['max'] * 1e3:.2f}]  "
            f"p50 {s['p50'] * 1e3:.2f}ms  "
            f"({prof.get('exchange_steps', '?')} exchange steps)")
        for name, rec in (prof.get("host_phases") or {}).items():
            lines.append(f"  host  {name:>9}: {rec['total_s'] * 1e3:8.2f}ms "
                         f"over {rec['n']} calls")
        for name, rec in (prof.get("device_phases") or {}).items():
            lines.append(f"  device{name:>9}: {rec['ops']:>5} ops  "
                         f"{_fmt_bytes(rec['bytes'])} result traffic")
        if prof.get("phase_ms"):
            lines.append(f"  clock (ms a step over {prof['phase_steps']} "
                         f"steps): device / device self / host")
        for name, rec in (prof.get("phase_ms") or {}).items():
            dev = "  ".join("       -" if rec[k] is None else
                            f"{rec[k]:8.3f}"
                            for k in ("device_ms", "device_self_ms"))
            lines.append(f"  clock {name:>9}: {dev}  {rec['host_ms']:8.3f}"
                         f"  ({rec['count']} spans)")
        if prof.get("host_gap_ms") is not None:
            lines.append(f"  host gap: {prof['host_gap_ms']:.3f}ms a step "
                         f"with no step phase on the device")
        if prof.get("kernel_launches"):
            ran = ", ".join(f"{k} {v}" for k, v in
                            prof["kernel_launches"].items() if v)
            lines.append(f"  kernel launches over the {prof['phase_steps']} "
                         f"clocked steps: {ran or 'none'}")
        if prof.get("trace_dir"):
            lines.append(f"  trace: {prof['trace_dir']}")

    gap = summary.get("delta_gap")
    if gap:
        lines.append("")
        lines.append("empirical δ̂ vs assumed δ (last logged step):")
        for g in gap:
            lines.append(f"  bucket {g['bucket']:>3} {g['compressor']:>14}: "
                         f"assumed {g['assumed']:.4f}  measured "
                         f"{g['measured']:.4f}  gap {g['gap']:+.4f}")
    obs = summary.get("obs")
    if obs and not gap and obs.get("delta_hat") is not None:
        lines.append("")
        lines.append(f"empirical δ̂ (aggregate, last logged step): "
                     f"{obs['delta_hat']:.4f}")

    comm = summary.get("comm")
    if comm:
        lines.append("")
        if "budget_utilization" in comm:
            lines.append(f"bytes vs budget: "
                         f"{_fmt_bytes(comm['wire_bytes_per_step'])}/step "
                         f"against {_fmt_bytes(comm['budget_bytes'])} "
                         f"budget = {comm['budget_utilization'] * 100:.1f}% "
                         f"utilization")
        else:
            lines.append(f"wire: {_fmt_bytes(comm['wire_bytes_per_step'])}"
                         f"/step  ratio {comm.get('compression_ratio')}x")
        for r in comm.get("per_bucket", []):
            share = (f"  {r['budget_share'] * 100:5.1f}% of budget"
                     if "budget_share" in r else "")
            bits = f"{r['bits']}b" if r.get("bits") else "fp"
            lines.append(f"  bucket {r['bucket']:>3} "
                         f"{r['compressor']:>14} ({bits:>3}): "
                         f"{r['elems']:>9} elems  "
                         f"{_fmt_bytes(r['payload_bytes'])}{share}")

    if obs:
        ef = obs.get("ef_e1")
        if ef:
            lines.append("")
            growth = (f"  ({ef['growth']:.2f}x over the run)"
                      if ef.get("growth") else "")
            lines.append(f"EF residual ‖e1‖: {ef['first']:.4f} → "
                         f"{ef['last']:.4f}{growth}")
            e2 = obs.get("ef_e2")
            if e2 and (e2["first"] or e2["last"]):
                lines.append(f"EF residual ‖e2‖: {e2['first']:.4f} → "
                             f"{e2['last']:.4f}")
        if "staleness_hist" in obs:
            hist = obs["staleness_hist"]
            cells = "  ".join(f"τ={i}:{int(c)}" for i, c in enumerate(hist))
            lines.append(f"staleness histogram (last logged step): {cells}")
        if "msg_var" in obs:
            lines.append(f"message moments (aggregate): mean "
                         f"{obs['msg_mean']:.3e}  var {obs['msg_var']:.3e}")

    ov = summary.get("overlap")
    if ov:
        lines.append("")
        lines.append("overlap (paired exchange.overlap on/off runs):")
        for r in ov:
            row = (f"  {r['schedule']:<18} W={r['n_workers']:<3} "
                   f"step on {r['t_on_s'] * 1e3:8.2f}ms / "
                   f"off {r['t_off_s'] * 1e3:8.2f}ms  "
                   f"hidden {r['hidden_s'] * 1e3:.2f}ms")
            if "hidden_frac" in r:
                row += (f" of {r['exchange_s'] * 1e3:.2f}ms exchange "
                        f"({r['hidden_frac'] * 100:.0f}% hidden, "
                        f"{r['exposed_s'] * 1e3:.2f}ms exposed)")
            lines.append(row)

    cal = summary.get("calibration")
    if cal:
        from repro_torch.obs import calibrate as _cal
        lines.append("")
        lines.append(_cal.render(cal))

    if not lines:
        lines.append("no renderable events (is this a sink file?)")
    return "\n".join(lines)


DESCRIPTION = "render a repro.obs run-sink JSONL file"


def add_args(ap: argparse.ArgumentParser) -> None:
    """Mount the report arguments (shared IO contract: repro_torch.obs.cli)."""
    ap.add_argument("path", help="sink file written by --obs-sink PATH")
    cli.add_io_args(ap, out_help="write the summary JSON here")


def run(args: argparse.Namespace) -> int:
    events = cli.read_paths([args.path], validate=not args.no_validate)
    summary = summarize(events)
    cli.emit(args, summary, render(summary))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.obs report",
                                 description=DESCRIPTION)
    add_args(ap)
    return run(ap.parse_args(argv))


if __name__ == "__main__":  # pragma: no cover - exercised via __main__
    raise SystemExit(main())
