"""One reader a metric, `bench/metrics/<name>.py`, found by the metric's
name in `BENCHMARK.json`: `read(ctx) -> float | None`, None where the run
gave it nothing to read (the harness then leaves the metric out of its
line). `ctx` carries the run's window, its peak memory and set-up time,
and with `--trace 1` the profiler capture (`bench.trace.Capture`)."""
from __future__ import annotations

import importlib


def read(name: str, ctx):
    return importlib.import_module(f"{__name__}.{name}").read(ctx)
