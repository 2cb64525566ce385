"""Gradient-exchange strategies (counterpart of `repro.core.exchange`):
the parameter server's average of Algorithm 2 over W workers.

    exact      q̂ = mean_w p_w                        (no compression)
    sim        q̂ = mean_w Q(p_w)                     (float on the wire)
    allgather  int8 codes + scales all-gathered, decompressed, averaged
    two_phase  quantize → all-to-all (int8) → each chunk owner averages
               its chunk → re-quantize with owner EF (e2) → all-gather

The JAX package runs one worker per device inside `shard_map`; here the
workers are a leading axis of size W on one device (`StackedWorkers`),
and every per-worker tensor — message, EF residuals, payloads, draws —
carries it. A strategy calls only the backend's `mean`, `all_gather` and
`all_to_all`, so a `torch.distributed` backend (one worker per card) can
go beside it without touching the strategies. With one worker every
strategy degenerates to (EF-)compression, which `core.dqgan` does itself.

Split phase: `start_exchange` returns an `ExchangeHandle` whose `finish`
yields (q̂, new EF state); q̂ is replicated (one copy), the EF state
stays per worker. Also here: the static plans, EF state shapes and the
analytic wire model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import tree as T

from .error_feedback import compress_with_ef_stacked

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


def _resolved(strategy, q, new_state) -> ExchangeHandle:
    return ExchangeHandle(strategy, lambda: (q, new_state))


# --------------------------------------------------------------------------- #
# the workers and their collectives
# --------------------------------------------------------------------------- #
class StackedWorkers:
    """W workers as the leading axis of every per-worker tensor, on one
    device: the port's counterpart of the JAX package's `data` mesh axis.
    Each collective is a tensor operation over that axis:

        mean        pmean       (W, ...) -> (...), what every worker gets
        all_gather  all_gather  (W, ...) -> (W, ...), the stack itself
        all_to_all  all_to_all  (W_src, W_chunk, ...) -> (W_dst, W_src, ...)
    """

    def __init__(self, n: int):
        self.n = n

    def mean(self, x):
        return x.mean(dim=0)

    def all_gather(self, x):
        return x

    def all_to_all(self, x):
        return x.transpose(0, 1)


def _each(payloads):
    """A list of payload dicts stacked along a new leading axis."""
    return {k: torch.stack([p[k] for p in payloads]) for k in payloads[0]}


def _row(payload, i):
    return {k: v[i] for k, v in payload.items()}


def start_exchange(compressor, plan: dict, p, ef_state: dict, rand,
                   workers: StackedWorkers, use_ef: bool, generator=None
                   ) -> ExchangeHandle:
    """Start the exchange of one tensor or bucket across the workers.

    p: (W, *shape), each worker's message; ef_state: {"e1": (W, *shape),
    "e2": (W, *chunk)}. `rand` holds the stochastic compressors' draws
    (None: drawn from `generator`): a (W, ...) stack for sim/allgather,
    {"phase1": (W, W, ...), "phase2": (W, ...)} for two_phase (phase 1:
    worker w's draw for chunk j; phase 2: owner w's). Split points
    (start | finish), as in the JAX package:

      exact     : mean(p)                          | identity
      sim       : compress+EF, mean(p̂)             | identity
      allgather : compress+EF, all_gather(codes)   | decompress+mean
      two_phase : phases 1+2 through all_gather    | decompress+unchunk
    """
    strategy = plan["strategy"]
    new_state = dict(ef_state)
    if strategy == "exact":
        return _resolved(strategy, workers.mean(p), new_state)
    if strategy == "two_phase":
        return _start_two_phase(compressor, plan, p, ef_state, new_state,
                                rand, workers, use_ef, generator)
    if strategy not in ("sim", "allgather"):
        raise ValueError(f"unknown strategy {strategy!r}")
    e1 = ef_state.get("e1", torch.zeros_like(p))
    payload, p_hat, e_new = compress_with_ef_stacked(
        compressor, p, e1, rand, generator, use_ef=use_ef)
    if use_ef:
        new_state["e1"] = e_new
    if strategy == "sim":
        return _resolved(strategy, workers.mean(p_hat), new_state)
    gathered = {k: workers.all_gather(v) for k, v in payload.items()}

    def _finish_allgather():
        deq = torch.stack([
            compressor.decompress(_row(gathered, w), p.shape[1:],
                                  torch.float32)
            for w in range(workers.n)])
        return deq.mean(dim=0).to(p.dtype), new_state

    return ExchangeHandle(strategy, _finish_allgather)


def exchange_leaf(compressor, plan: dict, p, ef_state: dict, rand,
                  workers: StackedWorkers, use_ef: bool, generator=None):
    """Blocking spelling: start + immediate finish; (q̂, new EF state)."""
    return finish_exchange(start_exchange(compressor, plan, p, ef_state,
                                          rand, workers, use_ef, generator))


def _rest(shape, ax):
    return tuple(s for i, s in enumerate(shape) if i != ax)


def _start_two_phase(compressor, plan, p, ef_state, new_state, rand,
                     workers, use_ef, generator) -> ExchangeHandle:
    W = workers.n
    ax = plan["chunk_axis"]            # axis of one worker's tensor
    shape = tuple(p.shape[1:])
    rest = _rest(shape, ax)
    r1 = r2 = None
    if rand is not None:
        r1, r2 = rand["phase1"], rand["phase2"]
    # ---- phase 1: each worker compresses its W chunks, all-to-all -------- #
    e1 = ef_state.get("e1", torch.zeros_like(p))
    m = p + e1.to(p.dtype) if use_ef else p
    # (W, ..., ax, ...) -> (W, W_chunk, ax/W, *rest)
    x = torch.movedim(m, ax + 1, 1).reshape(
        (W, W, shape[ax] // W) + rest)
    flat = x.reshape((W * W,) + x.shape[2:])
    r1 = None if r1 is None else r1.reshape(W * W, -1)
    pls = [compressor.compress(flat[i], None if r1 is None else r1[i],
                               generator) for i in range(W * W)]
    x_hat = torch.stack([compressor.decompress(pl, flat.shape[1:], x.dtype)
                         for pl in pls]).reshape(x.shape)
    if use_ef:
        e_new = (x - x_hat).reshape((W, shape[ax]) + rest)
        new_state["e1"] = torch.movedim(e_new, 1, ax + 1).to(e1.dtype)
    payload = {k: v.reshape((W, W) + v.shape[1:])
               for k, v in _each(pls).items()}
    moved = {k: workers.all_to_all(v) for k, v in payload.items()}
    contrib = torch.stack([
        torch.stack([compressor.decompress(_row(_row(moved, d), s),
                                           x.shape[2:], torch.float32)
                     for s in range(W)])
        for d in range(W)])            # (W_dst, W_src, chunk)
    chunk_mean = contrib.mean(dim=1)   # owner d's chunk of q̂
    # ---- phase 2: owner compress (+ owner EF e2), all-gather ------------- #
    e2 = ef_state["e2"].reshape(chunk_mean.shape)
    payload2, _, e2_new = compress_with_ef_stacked(
        compressor, chunk_mean, e2, r2, generator, use_ef=True)
    new_state["e2"] = e2_new.reshape(ef_state["e2"].shape).to(
        ef_state["e2"].dtype)
    gathered = {k: workers.all_gather(v) for k, v in payload2.items()}

    def _finish_two_phase():
        chunks = torch.stack([
            compressor.decompress(_row(gathered, o), chunk_mean.shape[1:],
                                  torch.float32) for o in range(W)])
        q = torch.movedim(chunks.reshape((shape[ax],) + rest), 0, ax)
        return q.to(p.dtype), new_state

    return ExchangeHandle("two_phase", _finish_two_phase)


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
