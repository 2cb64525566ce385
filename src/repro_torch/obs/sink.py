"""Structured run sinks: a versioned JSONL event schema (a copy of
`repro.obs.sink`: the two packages write and read the same files).

Every event is one JSON object::

    {"v": 2, "kind": "...", "strategy": "<short_hash>", ...payload}

``v`` is the schema version (bump on any incompatible field change;
readers must ignore unknown fields so additive changes don't bump it),
``kind`` names the event type, ``strategy`` is `Strategy.short_hash()` —
the structural identity every event is keyed by, so a report can join a
sink file against regression baselines and checkpoints.

Version history: v1 is the first schema (run_meta / train_log / timing /
obs_metrics / comm_summary / bench_row). v2 adds the measured-vs-modeled
kinds — ``profile`` (step-profiler windows, DESIGN.md §12.1) and
``calibration`` (fitted LinkModel constants + drift, §12.3). Writers
stamp v2; readers accept BOTH versions (a v1 file validates unchanged),
but refuse a v2-only kind claiming ``v: 1`` — that is a mislabeled
writer, not an old file.

Backends: `StdoutSink` renders events in the pre-obs stdout format
(train_log rows as bare JSON lines, everything else as ``# obs[...]``
comment rows) so default output is unchanged; `JsonlFileSink` writes the
full event stream; `NullSink` drops it; `TeeSink` fans out. `make_sink`
maps the ``--obs-sink`` CLI spelling to a backend.
"""
from __future__ import annotations

import json
from typing import Any, Dict, IO, Optional, Sequence

SCHEMA_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)

# kind -> required payload fields (beyond the envelope). Readers must
# tolerate extra fields; writers must provide at least these.
EVENT_KINDS: Dict[str, tuple] = {
    "run_meta": ("steps",),          # run header: arch, strategy json, ...
    "train_log": ("step", "loss"),   # the per-log-step training row
    "timing": ("step", "step_s", "interval_s"),  # synced wall-times
    "obs_metrics": ("step",),        # on-device telemetry (repro.obs)
    "comm_summary": (),              # CommLedger.summary() payload
    "bench_row": ("name", "us"),     # one benchmarks.run CSV row
    # ---- v2: the measured side (DESIGN.md §12) ---- #
    "profile": ("step0", "n_steps", "step_s"),   # one profiled window
    "calibration": ("bandwidth_Bps", "latency_s"),  # fitted constants
}

# kinds that did not exist in schema v1 — a v1 event may not carry them
V2_KINDS = ("profile", "calibration")


class SchemaError(ValueError):
    """An event that does not conform to the sink schema."""


def validate_event(ev: Any) -> None:
    """Raise `SchemaError` unless `ev` is a valid schema event (any
    supported version — v1 files stay readable after the v2 bump)."""
    if not isinstance(ev, dict):
        raise SchemaError(f"event: expected an object, got "
                          f"{type(ev).__name__}")
    v = ev.get("v")
    if v not in SUPPORTED_VERSIONS:
        raise SchemaError(f"event: schema version {v!r} not in supported "
                          f"{SUPPORTED_VERSIONS}")
    kind = ev.get("kind")
    if kind not in EVENT_KINDS:
        raise SchemaError(f"event: unknown kind {kind!r}; have "
                          f"{sorted(EVENT_KINDS)}")
    if v < 2 and kind in V2_KINDS:
        raise SchemaError(f"event: kind {kind!r} requires schema v2, "
                          f"got v={v}")
    missing = [f for f in EVENT_KINDS[kind] if f not in ev]
    if missing:
        raise SchemaError(f"event kind={kind!r}: missing field(s) "
                          f"{missing}")


def _jsonable(x):
    """Best-effort conversion of torch tensors and numpy scalars and
    arrays (a tensor on a device is copied to the host)."""
    if hasattr(x, "tolist"):
        return x.tolist()
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, float):
        return x
    return x


class Sink:
    """Base sink. `emit(kind, **payload)` stamps the envelope
    (schema version + strategy hash), validates, and hands the event to
    the backend's `write`."""

    def __init__(self, strategy_hash: Optional[str] = None):
        self.strategy_hash = strategy_hash

    def emit(self, kind: str, **payload) -> dict:
        ev = {"v": SCHEMA_VERSION, "kind": kind}
        if self.strategy_hash is not None:
            ev["strategy"] = self.strategy_hash
        ev.update({k: _jsonable(v) for k, v in payload.items()})
        validate_event(ev)
        self.write(ev)
        return ev

    def write(self, ev: dict) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NullSink(Sink):
    def write(self, ev: dict) -> None:
        pass


class StdoutSink(Sink):
    """Renders the event stream in the pre-obs stdout format: train_log
    rows print as bare JSON (byte-compatible with the old ad-hoc
    ``print(json.dumps(rec))`` rows — the envelope fields are stripped).
    Other kinds render as ``# obs[kind]: {...}`` comment rows only when
    ``verbose`` (the explicit ``--obs-sink stdout`` spelling); the quiet
    default drops them, keeping default stdout byte-identical to the
    pre-obs launcher."""

    def __init__(self, strategy_hash: Optional[str] = None,
                 verbose: bool = False):
        super().__init__(strategy_hash)
        self.verbose = verbose

    def write(self, ev: dict) -> None:
        body = {k: v for k, v in ev.items()
                if k not in ("v", "kind", "strategy")}
        if ev["kind"] == "train_log":
            print(json.dumps(body), flush=True)
        elif self.verbose:
            print(f"# obs[{ev['kind']}]: "
                  f"{json.dumps(body, sort_keys=True)}", flush=True)


class JsonlFileSink(Sink):
    def __init__(self, path: str, strategy_hash: Optional[str] = None):
        super().__init__(strategy_hash)
        self.path = path
        self._fh: Optional[IO[str]] = open(path, "w")

    def write(self, ev: dict) -> None:
        assert self._fh is not None, "sink already closed"
        self._fh.write(json.dumps(ev) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class TeeSink(Sink):
    def __init__(self, sinks: Sequence[Sink],
                 strategy_hash: Optional[str] = None):
        super().__init__(strategy_hash)
        self.sinks = list(sinks)
        for s in self.sinks:
            s.strategy_hash = strategy_hash

    def write(self, ev: dict) -> None:
        for s in self.sinks:
            s.write(ev)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def make_sink(spec: str, strategy_hash: Optional[str] = None,
              tee_stdout: bool = False) -> Sink:
    """``--obs-sink`` spelling → backend: "" → quiet StdoutSink (the
    pre-obs default rendering), "stdout" → verbose StdoutSink,
    "null" → NullSink, anything else is a JSONL file path (tee'd with
    quiet stdout when `tee_stdout`, so log rows stay visible)."""
    if spec == "":
        return StdoutSink(strategy_hash, verbose=False)
    if spec == "stdout":
        return StdoutSink(strategy_hash, verbose=True)
    if spec == "null":
        return NullSink(strategy_hash)
    file_sink = JsonlFileSink(spec, strategy_hash)
    if tee_stdout:
        return TeeSink([StdoutSink(), file_sink], strategy_hash)
    return file_sink


def read_events(path: str, validate: bool = True):
    """Parse a sink file back into events (report CLI + tests)."""
    out = []
    with open(path) as fh:
        for i, line in enumerate(fh):
            line = line.strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError as e:
                raise SchemaError(f"{path}:{i + 1}: invalid JSON ({e})")
            if validate:
                validate_event(ev)
            out.append(ev)
    return out
