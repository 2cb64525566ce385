"""repro_torch.obs — telemetry collected in the step, structured run
sinks, phase spans, the step profiler and structural checks over profiled
steps (counterpart of `repro.obs`).

- `metrics` — the `MetricSpec` lattice ("off" ⊂ "wire" ⊂ "full"):
  per-bucket message moments, empirical δ (from the EF residual the step
  already holds), EF norms and the staleness histogram, summed on the
  step's device. ``off`` launches nothing.
- `sink` — the versioned JSONL event schema keyed by
  `Strategy.short_hash()`, with stdout / file / null backends
  (``--obs-sink`` on `launch.train`): the JAX package's, file for file.
- `report`, `calibrate` — ``python -m repro_torch.obs {report,calibrate}``,
  copies of the JAX package's CLIs over the port's `strategy` and
  `sched`.
- `tracing` — ``repro.obs/<phase>`` ranges for `torch.profiler`, and the
  `PhaseClock` that times them on the device (CUDA events) and the host
  on one timeline, without a profiler: each span's device and host
  milliseconds, and the device's gaps between the step's phases.
- `profile` — the `StepProfiler`: synced step walls, host phases and,
  with spans on, kernels and allocated bytes per phase from a
  `torch.profiler` capture and the phase clock's readings over the same
  steps (``--profile-steps``).
- `trace` — the counterpart of `repro.obs.hlo`: collectives of a profiled
  step against the `CommLedger`, and schedule-shaped checks.
"""
from .metrics import (  # noqa: F401
    METRIC_SPECS,
    Collector,
    MetricSpec,
    NullCollector,
    ef_norms_sq,
    finalize,
    metric_keys,
    staleness_hist,
)
from .sink import (  # noqa: F401
    EVENT_KINDS,
    SCHEMA_VERSION,
    JsonlFileSink,
    NullSink,
    SchemaError,
    Sink,
    StdoutSink,
    TeeSink,
    make_sink,
    read_events,
    validate_event,
)
from .profile import (  # noqa: F401
    DEFAULT_WINDOW,
    NullStepProfiler,
    StepProfiler,
    make_profiler,
)
from .tracing import PhaseClock, device_span, host_span  # noqa: F401
