"""A `torch.profiler` capture reduced to device seconds by phase.

The attribution is the rule of the program's `obs/profile.py::phase_costs`,
frozen here: a device event belongs to the phase of the host call that
launched it (the runtime call with its correlation id), and a host event
to the innermost ``repro.obs/<phase>`` range around it on its own thread,
or, where it has none (autograd runs the backward on a thread of its
own), to the innermost such range of any thread open at its start. Bytes
are each host operator's own device allocations net of its own frees,
where positive. Unlike `phase_costs`, which counts kernels and bytes,
this sums the device events' durations, and takes copies and fills as
well as kernels.

`Capture` holds plain records, so that the arithmetic can be checked on a
synthetic trace; `from_profiler` makes one from a finished profiler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

PREFIX = "repro.obs/"
PHASES = ("compress", "exchange", "apply", "field")
RUNTIME = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset", "cuMemcpy",
           "cuMemset", "cudaGraphLaunch")


@dataclass
class Capture:
    # name, start, end (us), phase, the host operator that launched it
    device: List[Tuple[str, float, float, Optional[str], str]]
    alloc: Dict[Optional[str], int] = field(default_factory=dict)
    unmatched: int = 0     # device events whose launch the capture lacks


def phase_of(event) -> Optional[str]:
    """The phase of the innermost ``repro.obs/<phase>`` range around a
    profiler event (the event itself included), or None."""
    e = event
    while e is not None:
        if e.name.startswith(PREFIX) and e.name[len(PREFIX):] in PHASES:
            return e.name[len(PREFIX):]
        e = e.cpu_parent
    return None


def _phase_by_time(ranges, t) -> Optional[str]:
    phase = None
    for start, end, name in ranges:
        if start > t:
            break
        if t < end:
            phase = name
    return phase


def _annotation(e) -> bool:
    """A host range mirrored on the device's timeline, not device work."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(
        PREFIX)


def from_events(events, is_device) -> Capture:
    """A `Capture` of profiler events (objects with name, time_range,
    cpu_parent, id, linked_correlation_id and self_device_memory_usage);
    `is_device(e)` tells device events."""
    host = [e for e in events if not is_device(e)]
    dev = [e for e in events if is_device(e) and not _annotation(e)]
    ranges = sorted((e.time_range.start, e.time_range.end,
                     e.name[len(PREFIX):]) for e in host
                    if e.name.startswith(PREFIX)
                    and e.name[len(PREFIX):] in PHASES)

    def phase(e):
        p = phase_of(e)
        return p if p is not None else _phase_by_time(ranges,
                                                      e.time_range.start)

    runtime = {e.id: e for e in host if e.name.startswith(RUNTIME)}
    front = {e.id: e for e in host}
    cap = Capture(device=[])
    for k in dev:
        launch = runtime.get(k.id)
        if launch is None:
            launch = front.get(getattr(k, "linked_correlation_id", 0) or -1)
        if launch is None:
            cap.unmatched += 1
            cap.device.append((k.name, k.time_range.start, k.time_range.end,
                               None, "?"))
            continue
        op = launch
        if op.name.startswith(RUNTIME) and op.cpu_parent is not None:
            op = op.cpu_parent
        cap.device.append((k.name, k.time_range.start, k.time_range.end,
                           phase(launch), op.name))
    for e in host:
        nbytes = max(int(getattr(e, "self_device_memory_usage", 0) or 0), 0)
        if nbytes:
            p = phase(e)
            cap.alloc[p] = cap.alloc.get(p, 0) + nbytes
    return cap


def from_profiler(prof) -> Capture:
    import torch
    cpu = torch.autograd.DeviceType.CPU
    return from_events(prof.events(), lambda e: e.device_type != cpu)



# --------------------------------------------------------------------------- #
# reductions
# --------------------------------------------------------------------------- #
def phase_seconds(cap: Capture) -> Dict[Optional[str], float]:
    """Device seconds by phase (None: outside every phase)."""
    out: Dict[Optional[str], float] = {}
    for _, a, b, p, _ in cap.device:
        out[p] = out.get(p, 0.0) + (b - a) * 1e-6
    return out


def busy_intervals(cap: Capture) -> List[Tuple[float, float]]:
    """The union of the device events' intervals (us), in order."""
    out: List[List[float]] = []
    for _, a, b, _, _ in sorted(cap.device, key=lambda d: d[1]):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_seconds(cap: Capture) -> float:
    return sum(b - a for a, b in busy_intervals(cap)) * 1e-6


def top_device_ops(cap: Capture, n=10) -> List[list]:
    """[[name, seconds]] of the n device operations that took most time,
    summed over the capture."""
    tot: Dict[str, float] = {}
    for name, a, b, _, _ in cap.device:
        tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(cap: Capture, n=10) -> List[list]:
    """[[what the host was doing, seconds]] of the n longest gaps between
    busy intervals: the host operator that launched the device work that
    ends the gap, and its phase ("-" outside every phase)."""
    busy = busy_intervals(cap)
    gaps = sorted(((b2 - a1, b2) for (_, a1), (b2, _)
                   in zip(busy, busy[1:])), reverse=True)[:n]
    first = {}
    for name, a, b, p, op in cap.device:
        if a not in first:
            first[a] = f"{op} in {p or '-'}"
    return [[first.get(t, "?"), length * 1e-6] for length, t in gaps]


def kernel_seconds(cap: Capture, needle: str) -> List[float]:
    """The durations of the device events whose name holds `needle`."""
    return [(b - a) * 1e-6 for name, a, b, _, _ in cap.device
            if needle in name]
