"""Phase tracing: named spans for `torch.profiler` (counterpart of
`repro.obs.tracing`), and a clock that times them.

Two span flavors, both gated on `Observability.spans` so that the default
step and host loop stay as they are:

- `host_span` around host-side phases (``data`` / ``step`` / ``eval``);
- `device_span` around the step's phases: the four of `DEVICE_PHASES`
  (``field`` / ``compress`` / ``exchange`` / ``apply``), which
  `obs.profile.phase_costs` and the dry-run's `launch.op_analysis` charge
  work to, and the finer ones of `CLOCK_PHASES`, which they see through.

Both are `torch.profiler.record_function` ranges: a captured profile
names every operator, and every CUDA kernel launched inside one, after
the innermost range around it. (The JAX package's device spans are
`jax.named_scope`s that name the compiled step's ops; here the step runs
eagerly, so the same range does both jobs.) A disabled span is a
`nullcontext`. Span names are namespaced ``repro.obs/<phase>``, the JAX
package's names, so that a trace of either package names its phases
alike.

`PhaseClock` times the same spans without a profiler. While a clock is
active, every enabled span opened on the thread that started it also
records, at its entry and at its exit, a CUDA event on the current stream
(from a pool the clock reuses) and the host's `time.perf_counter`, with
its name, its parent span and the step it belongs to. Inside a span the
clock never synchronizes, reads a tensor or allocates device memory; its
`stop` resolves every time against the anchor that `start` took (see
`ClockReading`). With no clock active a span is the range alone.
"""
from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function

PREFIX = "repro.obs/"

# the canonical phase names
HOST_PHASES = ("data", "step", "eval")
DEVICE_PHASES = ("compress", "exchange", "apply", "field")
# the spans that only the clock reads: the lookahead, the message and its
# schedule fold, the carry (prev_grad, the step's norms and telemetry),
# the bucket packing and unpacking, and a wait on a collective
CLOCK_PHASES = ("lookahead", "message", "carry", "pack", "unpack", "wait")

_ACTIVE: Optional["PhaseClock"] = None


def host_span(name: str, enabled: bool = True):
    """A profiler range around a host-side phase (no-op when off)."""
    return _span(name, enabled)


def device_span(name: str, enabled: bool = True):
    """A profiler range around a phase of the step (no-op when off)."""
    return _span(name, enabled)


def _span(name: str, enabled: bool):
    if not enabled:
        return nullcontext()
    clock = _ACTIVE
    if clock is None or threading.get_ident() != clock._thread:
        return record_function(PREFIX + name)
    return _ClockedSpan(clock, name)


class _ClockedSpan:
    """A `record_function` range that stamps the active clock at its entry
    and exit."""

    __slots__ = ("_clock", "_name", "_range", "_index")

    def __init__(self, clock: "PhaseClock", name: str):
        self._clock, self._name = clock, name
        self._range = record_function(PREFIX + name)

    def __enter__(self):
        self._range.__enter__()
        self._index = self._clock._enter(self._name)
        return self

    def __exit__(self, *exc):
        self._clock._exit(self._index)
        return self._range.__exit__(*exc)


# --------------------------------------------------------------------------- #
# the clock
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Span:
    """One timed span: milliseconds since the clock's anchor, on the
    device (None without CUDA) and on the host. `parent` indexes the
    enclosing span in the same list, or is None at the top level."""
    name: str
    parent: Optional[int]
    step: int
    device_in: Optional[float]
    device_out: Optional[float]
    host_in: float
    host_out: float

    @property
    def device_ms(self) -> Optional[float]:
        if self.device_in is None:
            return None
        return self.device_out - self.device_in

    @property
    def host_ms(self) -> float:
        return self.host_out - self.host_in


def union(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint intervals in
    order."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _length(intervals) -> float:
    return sum(b - a for a, b in intervals)


@dataclass
class ClockReading:
    """What a stopped `PhaseClock` measured (all times in ms).

    `phases`: {name: {"count", "device_ms", "device_self_ms", "host_ms"}},
    totals over the window. A span's device time is its interval on the
    device's timeline, from its entry event to its exit event: the work
    it enqueued and any idle between; its self time is that interval less
    the union of its children's. The device entries are None without
    CUDA.

    `steps`: one record a step, {"step", "busy_ms", "gaps"}: the length of
    the union of the step's top-level spans' device intervals (the spans
    inside no span but the host phases, which are seen through), and each
    gap on the device between consecutive top-level spans as {"after",
    "before", "device_ms", "host_ms"}: the spans before and after it, the
    device's idle between them, and the host's time from the first one's
    exit to the second one's entry (what the host did while the device
    waited).

    `n_steps`: the steps the caller closed (`PhaseClock.end_step`);
    `wall_ms`: the host's time from `start` to `stop`."""
    spans: List[Span]
    n_steps: int
    wall_ms: float
    phases: Dict[str, dict]
    steps: List[dict]

    def per_step(self, name: str, key: str = "device_ms") -> Optional[float]:
        """`phases[name][key]` a closed step, or None where the window
        has no such span, no closed step or no device times."""
        rec = self.phases.get(name)
        if rec is None or rec[key] is None or not self.n_steps:
            return None
        return rec[key] / self.n_steps

    def busy_ms_per_step(self) -> Optional[float]:
        """The mean over the closed steps of the union of their top-level
        spans' device intervals."""
        busy = [s["busy_ms"] for s in self.steps if s["step"] < self.n_steps]
        if not busy or any(b is None for b in busy):
            return None
        return sum(busy) / self.n_steps

    def host_gap_ms(self, wall_ms: Optional[float] = None,
                    n_steps: Optional[int] = None) -> Optional[float]:
        """The wall time a step under no top-level span on the device: the
        window's wall over its steps (by default the clock's own) less
        `busy_ms_per_step`."""
        busy = self.busy_ms_per_step()
        wall_ms = self.wall_ms if wall_ms is None else wall_ms
        n_steps = self.n_steps if n_steps is None else n_steps
        if busy is None or not n_steps:
            return None
        return wall_ms / n_steps - busy

    def summary(self) -> dict:
        """`phases` with each entry a step (the ``profile`` event's
        ``phase_ms``), rounded to the microsecond."""
        n = max(self.n_steps, 1)
        return {name: {"count": rec["count"],
                       **{k: (None if rec[k] is None
                              else round(rec[k] / n, 3))
                          for k in ("device_ms", "device_self_ms",
                                    "host_ms")}}
                for name, rec in self.phases.items()}


def _top_level(spans: List[Span], i: int) -> bool:
    """A step's phase at the top level: not a host phase, and inside no
    span but host phases (the launcher's ``step`` span holds the step's
    device spans)."""
    if spans[i].name in HOST_PHASES:
        return False
    p = spans[i].parent
    while p is not None:
        if spans[p].name not in HOST_PHASES:
            return False
        p = spans[p].parent
    return True


def resolve(spans: List[Span], n_steps: int, wall_ms: float) -> ClockReading:
    """The `ClockReading` of a window's spans (the clock's arithmetic,
    apart from the events that gave it the times)."""
    children: Dict[int, List[int]] = {}
    for i, s in enumerate(spans):
        if s.parent is not None:
            children.setdefault(s.parent, []).append(i)
    device = all(s.device_in is not None for s in spans)
    phases: Dict[str, dict] = {}
    for i, s in enumerate(spans):
        rec = phases.setdefault(s.name, {
            "count": 0, "device_ms": 0.0 if device else None,
            "device_self_ms": 0.0 if device else None, "host_ms": 0.0})
        rec["count"] += 1
        rec["host_ms"] += s.host_ms
        if device:
            inner = union((max(spans[c].device_in, s.device_in),
                           min(spans[c].device_out, s.device_out))
                          for c in children.get(i, ())
                          if spans[c].device_out > s.device_in
                          and spans[c].device_in < s.device_out)
            rec["device_ms"] += s.device_ms
            rec["device_self_ms"] += s.device_ms - _length(inner)
    steps: Dict[int, List[Span]] = {}
    for i, s in enumerate(spans):
        if _top_level(spans, i):
            steps.setdefault(s.step, []).append(s)
    out = []
    for step in sorted(steps):
        top = steps[step]
        if not device:
            out.append({"step": step, "busy_ms": None, "gaps": []})
            continue
        gaps, last = [], None
        for s in sorted(top, key=lambda s: (s.device_in, s.device_out)):
            if last is not None and s.device_in > last.device_out:
                gaps.append({"after": last.name, "before": s.name,
                             "device_ms": s.device_in - last.device_out,
                             "host_ms": s.host_in - last.host_out})
            if last is None or s.device_out > last.device_out:
                last = s
        out.append({"step": step,
                    "busy_ms": _length(union((s.device_in, s.device_out)
                                             for s in top)),
                    "gaps": gaps})
    return ClockReading(spans=list(spans), n_steps=n_steps, wall_ms=wall_ms,
                        phases=phases, steps=out)


class PhaseClock:
    """Times the enabled spans of a window on the device and the host, on
    one timeline.

    The caller synchronizes the device, calls `start` (one anchor: a CUDA
    event on the current stream and `time.perf_counter`), calls `end_step`
    after each step, synchronizes again and calls `stop`, which returns
    the `ClockReading`. One clock is active at a time. On a device other
    than CUDA the clock keeps host times only. The event pool outlives a
    window, so a clock started again reuses its events."""

    def __init__(self, device=None):
        self.device = torch.device(device if device is not None else "cpu")
        self.cuda = self.device.type == "cuda"
        self._pool: List = []
        self._used = 0
        self._recs: List[list] = []      # [name, parent, step, ev, t, ev, t]
        self._stack: List[int] = []
        self._step = 0
        self._anchor = None
        self._t0 = 0.0
        self._thread = None

    @property
    def active(self) -> bool:
        return _ACTIVE is self

    def start(self) -> "PhaseClock":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("obs.tracing: a PhaseClock is already active")
        self._used, self._recs, self._stack, self._step = 0, [], [], 0
        self._thread = threading.get_ident()
        self._anchor = self._event()
        self._t0 = time.perf_counter()
        _ACTIVE = self
        return self

    def end_step(self) -> None:
        """Closes the current step: spans opened from here on belong to
        the next one."""
        self._step += 1

    def _event(self):
        if not self.cuda:
            return None
        if self._used == len(self._pool):
            self._pool.append(torch.cuda.Event(enable_timing=True))
        ev = self._pool[self._used]
        self._used += 1
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def _enter(self, name: str) -> int:
        ev = self._event()
        t = time.perf_counter()
        i = len(self._recs)
        self._recs.append([name, self._stack[-1] if self._stack else None,
                           self._step, ev, t, None, None])
        self._stack.append(i)
        return i

    def _exit(self, i: int) -> None:
        ev = self._event()
        t = time.perf_counter()
        rec = self._recs[i]
        rec[5], rec[6] = ev, t
        if self._stack and self._stack[-1] == i:
            self._stack.pop()

    def stop(self) -> ClockReading:
        """Deactivates the clock and resolves its window. The caller has
        synchronized the device since the last span closed."""
        global _ACTIVE
        t_end = time.perf_counter()
        if _ACTIVE is not self:
            raise RuntimeError("obs.tracing: this PhaseClock is not active")
        _ACTIVE = None
        if self._stack:
            raise RuntimeError(f"obs.tracing: PhaseClock stopped inside "
                               f"span {self._recs[self._stack[-1]][0]!r}")

        def ms(t):
            return (t - self._t0) * 1e3

        def dev(ev):
            return None if ev is None else self._anchor.elapsed_time(ev)

        spans = [Span(name, parent, step, dev(e_in), dev(e_out), ms(t_in),
                      ms(t_out))
                 for name, parent, step, e_in, t_in, e_out, t_out
                 in self._recs]
        self._recs = []
        return resolve(spans, self._step, ms(t_end))
