"""Step profiler: the measured side of the wall clock (counterpart of
`repro.obs.profile`).

`sched.clock` *models* the step time; this module *measures* it. A
`StepProfiler` watches the first ``--profile-steps N`` training steps:

* **step walls** — the launcher ends every step in a device synchronize
  (`torch.cuda.synchronize` on the card), so the wall it hands to
  `record_step` is the step's device time as the host sees it, not
  launch latency. The profiler keeps the whole window and reports
  mean/min/max/p50.
* **host phases** — `phase(name)` contexts accumulate wall time per
  host-side phase, keyed by the span names `tracing` uses (``data`` /
  ``step`` / ``eval``).
* **device phases** — with spans on (`device_phases=True`), a
  `torch.profiler` capture runs over the window from its second step on
  (the first pays the one-time costs: kernel builds, cuDNN's algorithm
  search) to its end, and `device_phase_costs` attributes it to the
  ``repro.obs/<phase>`` ranges of `tracing.device_span`. Each operator
  belongs to the innermost such range around it on its own thread; an
  operator of another thread with no such range around it (on CUDA,
  autograd runs the field's backward on its device thread) belongs to
  the innermost range, of any thread, open at its start. A kernel
  belongs where the host call that launched it does. For each phase:

    ``ops``   on a CUDA device, the CUDA kernels launched inside the
              phase, each charged through the launch call that made it
              (copies, fills and synchronizations excluded);
              on the CPU, the phase's top-level ``aten::`` operators (those
              not called by another aten operator);
    ``bytes`` the bytes the phase's operators allocate: each operator's
              own allocations net of its own frees, where positive
              (``profile_memory``; device memory on CUDA, host memory on
              the CPU).

  Both are totals over the captured steps (``device_phase_steps`` in the
  event); ``device_unattributed`` holds the same two counts of what
  lies outside every phase (the step's extrapolation, message, schedule
  fold and metrics, the launcher's data). The JAX package counts the
  compiled step's HLO ops and their result bytes instead
  (`launch.hlo_analysis.scope_costs`): the two packages' numbers share
  their keys, not their units. On a CUDA device
  a capture that saw no kernel is an error, never a report of host
  times.
* **phase clock** — with spans on, a `tracing.PhaseClock` runs over the
  same window as the capture and times every span on the device and the
  host: ``phase_ms`` holds, for each span name, its count over the window
  and its device, device-self and host milliseconds a step (device
  entries null off CUDA), ``phase_steps`` the steps it timed, and
  ``host_gap_ms`` the wall time a step in which the device ran no
  top-level span of the step (null off CUDA). The profiler's capture
  runs beside the clock, so these times carry its host cost; the
  benchmark's are taken without it.
* **trace capture** — ``trace_dir`` keeps the capture as a Chrome trace
  (``repro_obs_steps_<first>_<last>.json``) in that directory; it too
  starts at the window's second step.

The window closes after N recorded steps and `emit` writes ONE schema-v2
``profile`` event into the run sink. The profiler reads what the step
does and changes none of it: parameters and EF are bit-equal with it on
or off.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, List, Optional

import torch

from repro_torch.kernels import launch_counts, launches_since

from .tracing import DEVICE_PHASES, HOST_PHASES, PREFIX, PhaseClock

DEFAULT_WINDOW = 32


def _stats(xs: List[float]) -> Dict[str, float]:
    ordered = sorted(xs)
    return {
        "mean": sum(xs) / len(xs),
        "min": ordered[0],
        "max": ordered[-1],
        "p50": ordered[len(ordered) // 2],
        "n": len(xs),
    }


def overlap_ratio(walls_on, walls_off, exchange_s: Optional[float] = None
                  ) -> Dict[str, float]:
    """Measured overlap from a paired A/B run: the same strategy timed
    with ``exchange.overlap`` on and off. ``hidden_s`` is the step wall
    the overlap removed (p50-off minus p50-on, clamped at 0). With
    ``exchange_s`` — the exposed exchange wall of the *off* run, e.g.
    ``t_off - t_compute`` from a calibration fit — the result also
    carries ``hidden_frac`` and ``exposed_s``.

    Inputs are either full per-step wall lists (profile windows) or
    scalar means (timing events); pure function, no profiler state."""
    walls_on = [float(walls_on)] if isinstance(
        walls_on, (int, float)) else [float(w) for w in walls_on]
    walls_off = [float(walls_off)] if isinstance(
        walls_off, (int, float)) else [float(w) for w in walls_off]
    if not walls_on or not walls_off:
        raise ValueError("overlap_ratio: need at least one step wall "
                         "on each side of the A/B pair")
    t_on = _stats(walls_on)["p50"]
    t_off = _stats(walls_off)["p50"]
    hidden = max(t_off - t_on, 0.0)
    out = {"t_on_s": t_on, "t_off_s": t_off, "hidden_s": hidden}
    if exchange_s is not None and exchange_s > 0:
        out["exchange_s"] = float(exchange_s)
        out["exposed_s"] = max(float(exchange_s) - hidden, 0.0)
        out["hidden_frac"] = min(hidden / float(exchange_s), 1.0)
    return out


# --------------------------------------------------------------------------- #
# attribution of a torch.profiler capture to the repro.obs/ ranges
# --------------------------------------------------------------------------- #
def phase_of(event, known=DEVICE_PHASES) -> Optional[str]:
    """The phase of the innermost ``repro.obs/<phase>`` range around a
    profiler event (the event itself included), or None."""
    e = event
    while e is not None:
        if e.name.startswith(PREFIX) and e.name[len(PREFIX):] in known:
            return e.name[len(PREFIX):]
        e = e.cpu_parent
    return None


def _phase_ranges(events):
    """[(start_us, end_us, phase)] of the capture's ``repro.obs/<phase>``
    ranges, innermost last among those open at any one time."""
    out = [(e.time_range.start, e.time_range.end, e.name[len(PREFIX):])
           for e in events if e.name.startswith(PREFIX)
           and e.name[len(PREFIX):] in DEVICE_PHASES]
    return sorted(out)


def _phase_by_time(ranges, t) -> Optional[str]:
    """The phase of the innermost range open at time `t`, or None."""
    phase = None
    for start, end, name in ranges:
        if start > t:
            break
        if t < end:
            phase = name
    return phase


def phase_costs(prof, cuda: bool) -> Dict[Optional[str], dict]:
    """{phase: {"ops", "bytes"}} of a `torch.profiler` capture, plus the
    same two counts of what lies outside every phase under the key None
    (see the module docstring for the definitions). `cuda`: the capture
    ran on a CUDA device with CUDA activity on; it must hold at least one
    kernel.

    A kernel is a device event that a launch call made
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ...: the same correlation
    id), not a copy, a fill or a synchronization, and is charged to the
    phase of that call: this covers kernels that no aten operator
    launched, such as the port's own, launched through their C
    interface."""
    events = prof.events()
    cpu = torch.autograd.DeviceType.CPU
    host = [e for e in events if e.device_type == cpu]
    ranges = _phase_ranges(host)

    def phase(e):
        p = phase_of(e)
        return p if p is not None else _phase_by_time(ranges,
                                                      e.time_range.start)

    out: Dict[Optional[str], dict] = {}

    def rec(p):
        return out.setdefault(p, {"ops": 0, "bytes": 0})

    if cuda:
        launches = {e.id: e for e in host if "Launch" in e.name}
        kernels = [k for k in events
                   if k.device_type != cpu and k.id in launches]
        if not kernels:
            raise RuntimeError(
                "obs.profile: the profiler recorded no CUDA kernel on a "
                "CUDA device; refusing to attribute host times as device "
                "phases")
        for k in kernels:
            rec(phase(launches[k.id]))["ops"] += 1
        for e in host:
            nbytes = max(int(e.self_device_memory_usage), 0)
            if nbytes:
                rec(phase(e))["bytes"] += nbytes
    else:
        for e in host:
            r = rec(phase(e))
            parent = e.cpu_parent
            if e.name.startswith("aten::") and not (
                    parent is not None and parent.name.startswith("aten::")):
                r["ops"] += 1
            r["bytes"] += max(int(e.self_cpu_memory_usage), 0)
    return {k: out[k] for k in (*DEVICE_PHASES, None) if k in out}


class StepProfiler:
    """Collects one profiled window of a training run.

    Life cycle: the launcher calls ``phase(name)`` around its host
    phases and ``record_step(step, step_s, exchanged)`` once per step;
    after ``window`` recorded steps the profiler is `done` and further
    calls are no-ops. `emit(sink)` writes the window as a single
    ``profile`` event. `device_phases` (spans on) and `trace_dir` run a
    `torch.profiler` capture over the window past its first step, with
    CUDA activity when `device` is a CUDA device; `device_phases` runs a
    `tracing.PhaseClock` over the same steps and counts the hand-written
    kernels' launches in them (`kernels.launch_counts`)."""

    def __init__(self, window: int = DEFAULT_WINDOW, trace_dir: str = "",
                 device_phases: bool = False, device=None):
        if window < 1:
            raise ValueError(f"profile window must be >= 1, got {window}")
        self.window = int(window)
        self.trace_dir = trace_dir
        self.device_phases = bool(device_phases)
        self.device = torch.device(device or "cpu")
        self.step_walls: List[float] = []
        self.first_step: Optional[int] = None
        self.exchange_steps = 0
        self.phase_s: Dict[str, List[float]] = {}   # name -> [total_s, n]
        self.captured_steps = 0
        self._prof = None
        self._tracing = False
        self._clock = PhaseClock(self.device) if self.device_phases else None
        self._reading = None
        self._launches = None     # launch counts at the capture's start
        self._emitted = False

    # ------------------------------------------------------------------ #
    @property
    def active(self) -> bool:
        return len(self.step_walls) < self.window and not self._emitted

    @property
    def done(self) -> bool:
        return not self.active

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def phase(self, name: str):
        """Wall-time accumulation context for a host phase (names:
        tracing.HOST_PHASES), open only while the window is."""
        if not self.active:
            return nullcontext()
        return self._timed(name)

    @contextmanager
    def _timed(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            rec = self.phase_s.setdefault(name, [0.0, 0])
            rec[0] += time.perf_counter() - t0
            rec[1] += 1

    def record_step(self, step: int, step_s: float,
                    exchanged: bool = True) -> None:
        """One synced per-step wall time. Starts the capture after the
        first recorded step (when one is asked for) and stops it when the
        window fills."""
        if not self.active:
            return
        if self._tracing:
            self.captured_steps += 1
            if self._clock is not None:
                self._clock.end_step()
        if self.first_step is None:
            self.first_step = int(step)
            if (self.device_phases or self.trace_dir) and self.window > 1:
                self._start_trace()
        self.step_walls.append(float(step_s))
        self.exchange_steps += bool(exchanged)
        if len(self.step_walls) >= self.window:
            self._stop_trace()

    def _start_trace(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=True,
                             profile_memory=True)
        self._prof.start()
        self._tracing = True
        if self._clock is not None:
            # the launcher ended the step just recorded in a synchronize
            self._clock.start()
            self._launches = launch_counts()

    def _stop_trace(self) -> None:
        if not self._tracing:
            return
        if self.cuda:
            torch.cuda.synchronize(self.device)
        if self._clock is not None:
            self._reading = self._clock.stop()
            self._launches = launches_since(self._launches)
        self._prof.stop()
        self._tracing = False
        if self.trace_dir:
            os.makedirs(self.trace_dir, exist_ok=True)
            last = self.first_step + len(self.step_walls) - 1
            self._prof.export_chrome_trace(os.path.join(
                self.trace_dir, f"repro_obs_steps_{self.first_step + 1}_"
                f"{last}.json"))

    # ------------------------------------------------------------------ #
    def device_phase_costs(self) -> Dict[str, dict]:
        """Per-phase kernels (CPU: aten operators) and allocated bytes of
        the captured steps (`phase_costs`), or {} without a capture."""
        if self._prof is None or self._tracing or not self.captured_steps:
            return {}
        return phase_costs(self._prof, self.cuda)

    def summary(self) -> Optional[dict]:
        """The window as a `profile` event payload, or None if no step
        was recorded."""
        if not self.step_walls:
            return None
        out = {
            "step0": self.first_step,
            "n_steps": len(self.step_walls),
            "exchange_steps": self.exchange_steps,
            "step_s": _stats(self.step_walls),
            "step_walls_s": [round(s, 6) for s in self.step_walls],
            "host_phases": {
                name: {"total_s": round(tot, 6), "n": n}
                for name, (tot, n) in sorted(self.phase_s.items())
            },
        }
        if self.device_phases:
            dev = self.device_phase_costs()
            phases = {k: v for k, v in dev.items() if k is not None}
            if phases:
                out["device_phases"] = phases
                out["device_phase_steps"] = self.captured_steps
                if None in dev:
                    out["device_unattributed"] = dev[None]
            r = self._reading
            if r is not None and r.n_steps:
                gap = r.host_gap_ms()
                out["phase_ms"] = r.summary()
                out["phase_steps"] = r.n_steps
                out["host_gap_ms"] = None if gap is None else round(gap, 3)
                out["kernel_launches"] = self._launches
        if self.trace_dir:
            out["trace_dir"] = self.trace_dir
        return out

    def emit(self, sink) -> Optional[dict]:
        """Close the window (stopping any live capture) and write it as
        one schema-v2 ``profile`` event. Idempotent."""
        self._stop_trace()
        if self._emitted:
            return None
        payload = self.summary()
        if payload is None:
            return None
        self._emitted = True
        return sink.emit("profile", **payload)


class NullStepProfiler:
    """The off switch: same surface, every call a no-op."""

    window = 0
    active = False
    done = True
    step_walls: List[float] = []

    def phase(self, name: str):
        return nullcontext()

    def record_step(self, step: int, step_s: float,
                    exchanged: bool = True) -> None:
        pass

    def device_phase_costs(self) -> Dict[str, dict]:
        return {}

    def summary(self) -> Optional[dict]:
        return None

    def emit(self, sink) -> Optional[dict]:
        return None


def make_profiler(enabled: bool, window: int = 0, trace_dir: str = "",
                  device_phases: bool = False, device=None):
    """Launcher factory: `StepProfiler` when profiling is on (the
    Observability.profile strategy field or an explicit --profile-steps),
    else the no-op `NullStepProfiler`."""
    if not enabled:
        return NullStepProfiler()
    return StepProfiler(window=window or DEFAULT_WINDOW, trace_dir=trace_dir,
                        device_phases=device_phases, device=device)


__all__ = [
    "DEFAULT_WINDOW",
    "DEVICE_PHASES",
    "HOST_PHASES",
    "NullStepProfiler",
    "StepProfiler",
    "make_profiler",
    "overlap_ratio",
    "phase_costs",
]
