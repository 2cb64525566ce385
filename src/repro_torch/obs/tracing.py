"""Phase tracing: named spans for `torch.profiler` (counterpart of
`repro.obs.tracing`).

Two span flavors, both gated on `Observability.spans` so that the default
step and host loop stay as they are:

- `host_span` around host-side phases (``data`` / ``step`` / ``eval``);
- `device_span` around the step's phases (``field`` / ``compress`` /
  ``exchange`` / ``apply``).

Both are `torch.profiler.record_function` ranges: a captured profile
names every operator, and every CUDA kernel launched inside one, after
the innermost range around it. (The JAX package's device spans are
`jax.named_scope`s that name the compiled step's ops; here the step runs
eagerly, so the same range does both jobs.) A disabled span is a
`nullcontext`. Span names are namespaced ``repro.obs/<phase>``, the JAX
package's names, so that a trace of either package names its phases
alike.
"""
from __future__ import annotations

from contextlib import nullcontext

from torch.profiler import record_function

PREFIX = "repro.obs/"

# the canonical phase names
HOST_PHASES = ("data", "step", "eval")
DEVICE_PHASES = ("compress", "exchange", "apply", "field")


def host_span(name: str, enabled: bool = True):
    """A profiler range around a host-side phase (no-op when off)."""
    if not enabled:
        return nullcontext()
    return record_function(PREFIX + name)


def device_span(name: str, enabled: bool = True):
    """A profiler range around a phase of the step (no-op when off)."""
    if not enabled:
        return nullcontext()
    return record_function(PREFIX + name)
