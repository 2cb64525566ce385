"""Partition rules of the port (counterpart of `repro.parallel`). The JAX
package's `parallel.compat` has no counterpart: it adapts JAX's SPMD API
across JAX versions, and the port calls no such API."""
from .sharding import (  # noqa: F401
    batch_axes,
    batch_spec,
    cache_specs,
    local_shape,
    param_specs,
)
