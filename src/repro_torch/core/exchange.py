"""Gradient-exchange plans (counterpart of `repro.core.exchange`), static
part only: which strategy each tensor or bucket takes, its EF state, the
split-phase handle and the analytic wire model. With one worker every
strategy degenerates to (EF-)compression, which `core.dqgan` does itself;
the collectives (exact/sim/allgather/two_phase across workers) arrive
with the multi-worker slice (ROADMAP §A, slice 2).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree as T

STRATEGIES = ("exact", "sim", "allgather", "two_phase")


# --------------------------------------------------------------------------- #
# static planning
# --------------------------------------------------------------------------- #
def pick_chunk_axis(shape, spec: Optional[tuple], n_workers: int
                    ) -> Optional[int]:
    """Largest axis divisible by n_workers whose spec entry is None."""
    best = None
    for ax, size in enumerate(shape):
        sharded = spec is not None and ax < len(spec) and spec[ax] is not None
        if sharded or size % n_workers:
            continue
        if best is None or size > shape[best]:
            best = ax
    return best


def plan_leaf(strategy: str, shape, spec, n_workers: int) -> dict:
    """Resolve the effective strategy + chunk axis for one tensor."""
    if strategy == "two_phase":
        ax = pick_chunk_axis(shape, spec, n_workers)
        if ax is None:
            return {"strategy": "sim", "chunk_axis": None, "fallback": True}
        return {"strategy": "two_phase", "chunk_axis": ax, "fallback": False}
    return {"strategy": strategy, "chunk_axis": None, "fallback": False}


def plan_bucket(strategy: str, size: int, n_workers: int) -> dict:
    """Plan for a flat comm bucket (padded to a multiple of n_workers, so
    two_phase always chunks on axis 0)."""
    if strategy == "two_phase":
        if size % max(n_workers, 1):
            raise ValueError(f"bucket of {size} not divisible by "
                             f"{n_workers} workers")
        return {"strategy": "two_phase", "chunk_axis": 0, "fallback": False}
    return {"strategy": strategy, "chunk_axis": None, "fallback": False}


def plan_has_owner_ef(plan: dict) -> bool:
    """True when `plan` carries owner-side (e2) error feedback: two_phase."""
    return plan["strategy"] == "two_phase"


def plan_for_tree(strategy, shapes_tree, specs_tree, n_workers):
    """plan_leaf over a nested dict of shape tuples (specs_tree None: no
    leaf is sharded)."""
    paths, shapes = T.flatten(shapes_tree)
    specs = ([None] * len(shapes) if specs_tree is None
             else T.flatten_up_to(paths, specs_tree))
    return T.unflatten(paths, [plan_leaf(strategy, sh, sp, n_workers)
                               for sh, sp in zip(shapes, specs)])


# --------------------------------------------------------------------------- #
# EF state
# --------------------------------------------------------------------------- #
def ef_state_zeros(plan: dict, shape, dtype, n_workers: int, use_ef: bool,
                   device=None):
    """Per-leaf EF state. e1 = worker-side error (full shape); e2 = chunk-
    owner error for two_phase (1/W of the tensor)."""
    state = {}
    if use_ef:
        state["e1"] = torch.zeros(shape, dtype=dtype, device=device)
    if plan["strategy"] == "two_phase":
        chunk_shape = list(shape)
        chunk_shape[plan["chunk_axis"]] //= n_workers
        state["e2"] = torch.zeros(tuple(chunk_shape), dtype=dtype,
                                  device=device)
    return state


# --------------------------------------------------------------------------- #
# split-phase handle
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class ExchangeHandle:
    """An exchange that has been started; `finish_exchange` returns its
    (q̂, new_ef_state)."""
    strategy: str
    _finish: Callable[[], Tuple[Any, dict]]

    def finish(self):
        return self._finish()


def finish_exchange(handle: ExchangeHandle):
    return handle.finish()


# --------------------------------------------------------------------------- #
# analytic wire model
# --------------------------------------------------------------------------- #
def transport_factor(n_workers: int) -> float:
    """Ring-transport multiplier 2·(W−1)/W."""
    return 2 * (n_workers - 1) / max(n_workers, 1)


def modeled_wire_bytes(strategy, compressor, shape, n_workers):
    """Per-worker bytes moved for one tensor, by strategy (send+receive)."""
    d = math.prod(shape)
    full = 4 * d
    cb = compressor.wire_bytes(shape, n_workers)
    if strategy == "exact" or strategy == "sim":
        return transport_factor(n_workers) * full
    if strategy == "allgather":
        return cb + (n_workers - 1) * cb
    if strategy == "two_phase":
        return transport_factor(n_workers) * cb
    raise ValueError(strategy)


def modeled_fsdp_wire_bytes(kind, compressor, moment_compressor, shape,
                            n_workers):
    """Per-worker bytes of one fsdp round for one bucket: gradient
    reduce-scatter plus moments/param all-gather, (W−1)/W each."""
    d = math.prod(shape)
    W = max(n_workers, 1)
    f = (W - 1) / W
    rs = 4 * d if kind == "exact" else compressor.wire_bytes(shape, W)
    ag = moment_compressor.wire_bytes(shape, W)
    return f * (rs + ag)
