"""Gradient-exchange strategies (counterpart of `repro.core.exchange`):
the parameter server's average of Algorithm 2 over W workers.

    exact      q̂ = mean_w p_w                        (no compression)
    sim        q̂ = mean_w Q(p_w)                     (float on the wire)
    allgather  int8 codes + scales all-gathered, decompressed, averaged
    two_phase  quantize → all-to-all (int8) → each chunk owner averages
               its chunk → re-quantize with owner EF (e2) → all-gather

The JAX package runs one worker per device inside `shard_map`. Here the
workers are a leading axis of every per-worker tensor — message, EF
residuals, payloads, draws: all W of them on one device
(`StackedWorkers`), or a contiguous block of L = W / data of them on
each data rank of a `torch.distributed` process mesh, the collectives
running over its data group (`ProcessGroupWorkers`; on the meta device
`MetaWorkers` traces one such rank, communicating nothing).

A leaf sharded over the mesh's model axis rides the per-tensor path with
a `error_feedback.LeafShard`: each rank exchanges its shard over its data
group, and every compression acts as on the global tensor (a scale
reduced over the model group, the draws made at the global shape).
A strategy calls only the backend's `mean`, `all_gather`, `all_to_all`
and `reduce_scatter`, each with a start form that returns a handle; it
tells the global worker count W (the chunks of two_phase) from the rows
it holds (L). With one worker every strategy degenerates to
(EF-)compression, which `core.dqgan` does itself.

Split phase: `start_exchange` returns an `ExchangeHandle` whose `finish`
yields (q̂, new EF state); q̂ is replicated (one copy), the EF state
stays per worker. fsdp splits the exchange around the shard owner's
optimizer: `start_reduce_scatter` (the gradient leg) and
`start_all_gather_shard` (the update or parameter leg). Also here: the
static plans, EF state shapes and the analytic wire model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.obs.tracing import device_span

from .error_feedback import compress_with_ef_stacked, decompress_rows

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
class _Ready:
    """A collective's handle whose result is already there."""

    def __init__(self, value):
        self._value = value

    def wait(self):
        return self._value


class _Pending:
    """A collective in flight: `wait` waits for `work` (on CUDA it makes the
    current stream wait; it does not block the host) and returns
    `post(out)`."""

    def __init__(self, work, out, post=None):
        self._work, self._out, self._post = work, out, post

    def wait(self):
        if self._work is not None:
            self._work.wait()
            self._work = None
        return self._out if self._post is None else self._post(self._out)


class _Workers:
    """The collectives a strategy calls, each in a start form that returns
    a handle (`start_mean`, `start_all_gather`, `start_all_to_all`,
    `start_reduce_scatter`; `handle.wait()` gives the result) and a
    blocking form. `n` is the global worker count W, `n_local` the rows
    this process holds (L), `offset` the global index of its first row."""

    n: int
    n_local: int
    offset: int = 0

    def _over_n(self, x):
        """x / W, dividing by a device tensor (IEEE division: PyTorch
        multiplies by the reciprocal of a Python scalar), made once a
        (device, dtype)."""
        key = (x.device, x.dtype)
        d = self._divisor.get(key)
        if d is None:
            d = self._divisor[key] = torch.full((), float(self.n),
                                                dtype=x.dtype,
                                                device=x.device)
        return x / d

    def mean(self, x):
        return self.start_mean(x).wait()

    def reduce_scatter(self, x):
        return self.start_reduce_scatter(x).wait()

    def all_gather(self, x):
        return self.start_all_gather(x).wait()

    def all_to_all(self, x):
        return self.start_all_to_all(x).wait()

    def rows(self, x):
        """This process's rows of a global (W, ...) tensor."""
        return x[self.offset:self.offset + self.n_local]


class StackedWorkers(_Workers):
    """W workers as the leading axis of every per-worker tensor, on one
    device: the port's counterpart of the JAX package's `data` mesh axis.
    Each collective is a tensor operation over that axis:

        mean            pmean         (W, ...) -> (...), what every worker
                                      gets
        all_gather      all_gather    (W, ...) -> (W, ...), the stack
        all_to_all      all_to_all    (W_src, W_chunk, ...)
                                      -> (W_dst, W_src, ...)
        reduce_scatter  psum_scatter  (W, d) -> (W, d/W): row w the mean
                        / W           over the workers of chunk w
    """

    def __init__(self, n: int):
        self.n = self.n_local = n
        self._divisor = {}

    def start_mean(self, x):
        return _Ready(x.mean(dim=0))

    def start_reduce_scatter(self, x):
        W = self.n
        s = x.reshape((W, W, x.shape[1] // W)).sum(dim=0)
        return _Ready(self._over_n(s))

    def start_all_gather(self, x):
        return _Ready(x)

    def start_all_to_all(self, x):
        return _Ready(x.transpose(0, 1))

    def mean_each(self, vectors):
        """The mean over the workers of each (W,) vector."""
        return [v.mean() for v in vectors]

    def max(self, x):
        """The largest entry of a (W,) vector."""
        return x.max()

    def sum_dict(self, sums):
        """Sums over all W workers of per-process sums: these already are."""
        return sums


class ProcessGroupWorkers(_Workers):
    """W workers spread over the data ranks of a `launch.mesh.ProcessMesh`,
    a contiguous block of L = W / data rows on each (every model rank of
    a data index holds the same rows; under the fsdp layout the workers
    are the pods, one a pod). The collectives run over the mesh's
    exchange group (the data group under dp, the whole world with model
    1; the ranks of one (data, model) index across the pods under fsdp;
    nccl on CUDA, gloo on the CPU):

        mean        local sum of the L rows, all_reduce(SUM), / W
                    (the JAX pmean; divided by a device tensor, IEEE
                    division, as `x.mean(0)` divides)
        all_gather  all_gather_into_tensor: (L, ...) -> (W, ...)
        all_to_all  all_to_all_single: (L_src, W_chunk, ...)
                    -> (L_dst, W_src, ...)
        reduce_scatter  local sum of the L rows, reduce_scatter over the
                    group (SUM), / W: (L, d) -> (L, d/W); the rank's
                    chunk of L·d/W elements is its workers' L chunks

    A start form issues its collective asynchronously; the handle's
    `wait` finishes it. Every collective goes through `_collective`."""

    def __init__(self, mesh, n: int):
        self.mesh = mesh
        self.n = n
        self.offset, self.n_local = mesh.rows(n)
        self._divisor = {}

    def _collective(self, kind: str, result, fn, *args, **kwargs):
        """`fn(*args, **kwargs)` over the exchange group, the
        `torch.distributed` call of collective `kind` that writes
        `result`: its work handle (None for a blocking call)."""
        del kind, result
        return fn(*args, group=self.mesh.exchange, **kwargs)

    def start_mean(self, x):
        s = x.sum(dim=0)
        work = self._collective("all_reduce", s, dist.all_reduce, s,
                                op=dist.ReduceOp.SUM, async_op=True)
        return _Pending(work, s, self._over_n)

    def start_all_gather(self, x):
        x = x.contiguous()
        out = x.new_empty((self.n,) + tuple(x.shape[1:]))
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        work = self._collective("all_gather", out, gather, out, x,
                                async_op=True)
        return _Pending(work, out)

    def start_reduce_scatter(self, x):
        L = self.n_local
        s = x.sum(dim=0)
        out = s.new_empty((s.shape[0] // self.mesh.n_exchange,))
        scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
        work = self._collective("reduce_scatter", out, scatter, out, s,
                                op=dist.ReduceOp.SUM, async_op=True)
        return _Pending(work, out, lambda o: self._over_n(o.reshape(L, -1)))

    def start_all_to_all(self, x):
        L, world = self.n_local, self.mesh.n_exchange
        rest = tuple(x.shape[2:])
        # (L_src, W_chunk, ...) -> (world_dst, L_dst, L_src, ...): rank d's
        # piece is the chunks it owns, from every local source row
        inp = x.reshape((L, world, L) + rest).transpose(0, 1)
        inp = inp.transpose(1, 2).contiguous()
        out = torch.empty_like(inp)
        work = self._collective("all_to_all", out, dist.all_to_all_single,
                                out, inp, async_op=True)

        def post(o):    # (world_src, L_dst, L_src, ...) -> (L_dst, W_src, ...)
            return o.transpose(0, 1).reshape((L, self.n) + rest)
        return _Pending(work, out, post)

    def mean_each(self, vectors):
        """The mean over all W workers of each (L,) vector: one all_reduce."""
        s = torch.stack([v.float().sum() for v in vectors])
        self._collective("all_reduce", s, dist.all_reduce, s,
                         op=dist.ReduceOp.SUM)
        return list(self._over_n(s).unbind())

    def max(self, x):
        m = x.max()
        self._collective("all_reduce", m, dist.all_reduce, m,
                         op=dist.ReduceOp.MAX)
        return m

    def sum_dict(self, sums):
        """A dict of per-rank float32 sums summed over the ranks: one
        all_reduce of the values packed back to back."""
        keys = list(sums)
        flat = torch.cat([sums[k].reshape(-1) for k in keys])
        self._collective("all_reduce", flat, dist.all_reduce, flat,
                         op=dist.ReduceOp.SUM)
        out, i = {}, 0
        for k in keys:
            n = sums[k].numel()
            out[k] = flat[i:i + n].reshape(sums[k].shape)
            i += n
        return out


class MetaWorkers(ProcessGroupWorkers):
    """One rank of a `launch.mesh.meta_mesh`: `ProcessGroupWorkers`' own
    operations on meta tensors, each collective's result buffer made and
    its communication left out (abstract evaluation, for
    `launch.dryrun`'s traced step). `collectives` counts the collectives
    the rank issues, by kind, with the bytes of their results (and of
    those the int8 ones), as the JAX package's dry-run counts its HLO's.
    A non-meta buffer raises."""

    def __init__(self, mesh, n: int):
        super().__init__(mesh, n)
        self.collectives = {}

    def _collective(self, kind: str, result, fn, *args, **kwargs):
        if result.device.type != "meta":
            raise ValueError(f"MetaWorkers: a {kind} buffer is on "
                             f"{result.device}; a meta mesh traces meta "
                             f"tensors only")
        rec = self.collectives.setdefault(
            kind, {"count": 0, "bytes": 0, "int8_bytes": 0})
        nbytes = result.numel() * result.element_size()
        rec["count"] += 1
        rec["bytes"] += nbytes
        if result.element_size() == 1:
            rec["int8_bytes"] += nbytes
        return None


def workers_for(mesh, n: int) -> _Workers:
    """The backend of W = `n` workers over `mesh`: `MetaWorkers` on a
    meta mesh, else `ProcessGroupWorkers`."""
    if mesh.device.type == "meta":
        return MetaWorkers(mesh, n)
    return ProcessGroupWorkers(mesh, n)


def start_exchange(compressor, plan: dict, p, ef_state: dict, rand,
                   workers: _Workers, use_ef: bool, generator=None,
                   spans: bool = False, shard=None,
                   stream=None) -> ExchangeHandle:
    """Start the exchange of one tensor or bucket across the workers.

    p: (L, *shape), the messages of this process's L workers (all W on
    one device); ef_state: {"e1": (L, *shape), "e2": (L, *chunk)}. `rand`
    holds the stochastic compressors' draws for these rows (None: drawn
    from `generator`, one, or one a worker, see
    `error_feedback.row_draws`): an (L, ...) stack for sim/allgather,
    {"phase1": (L, W, ...), "phase2": (L, ...)} for two_phase (phase 1:
    worker w's draw for chunk j; phase 2: owner w's). Split points
    (start | finish), as in the JAX package:

      exact     : mean(p)                          | identity
      sim       : compress+EF, mean(p̂)             | identity
      allgather : compress+EF, all_gather(codes)   | decompress+mean
      two_phase : phases 1+2 through all_gather    | decompress+unchunk

    A start launches its collective; the finish waits for it. `spans` puts
    each compression in a ``repro.obs/compress`` profiler range. `shard`
    (an `error_feedback.LeafShard`): p holds this rank's slices of a
    model-sharded tensor, compressed as the global one is, `rand` the
    global draws. `stream` (one seed a row, sim and allgather): a leaf's
    tile streams (`error_feedback.stream_draws`)."""
    strategy = plan["strategy"]
    new_state = dict(ef_state)
    if strategy == "exact":
        pend = workers.start_mean(p)
        return ExchangeHandle(strategy, lambda: (pend.wait(), new_state))
    if strategy == "two_phase":
        return _start_two_phase(compressor, plan, p, ef_state, new_state,
                                rand, workers, use_ef, generator, spans,
                                shard)
    if strategy not in ("sim", "allgather"):
        raise ValueError(f"unknown strategy {strategy!r}")
    e1 = ef_state.get("e1", torch.zeros_like(p))
    with device_span("compress", spans):
        payload, p_hat, e_new = compress_with_ef_stacked(
            compressor, p, e1, rand, generator, use_ef=use_ef, shard=shard,
            stream=stream, payload=strategy != "sim")
    if use_ef:
        new_state["e1"] = e_new
    if strategy == "sim":
        pend = workers.start_mean(p_hat)
        return ExchangeHandle(strategy, lambda: (pend.wait(), new_state))
    pends = {k: workers.start_all_gather(v) for k, v in payload.items()}

    def _finish_allgather():
        gathered = {k: h.wait() for k, h in pends.items()}
        deq = decompress_rows(compressor, gathered, p.shape[1:],
                              torch.float32, shard)
        return deq.mean(dim=0).to(p.dtype), new_state

    return ExchangeHandle(strategy, _finish_allgather)


def exchange_leaf(compressor, plan: dict, p, ef_state: dict, rand,
                  workers: _Workers, use_ef: bool, generator=None):
    """Blocking spelling: start + immediate finish; (q̂, new EF state)."""
    return finish_exchange(start_exchange(compressor, plan, p, ef_state,
                                          rand, workers, use_ef, generator))


def _rest(shape, ax):
    return tuple(s for i, s in enumerate(shape) if i != ax)


def _start_two_phase(compressor, plan, p, ef_state, new_state, rand,
                     workers, use_ef, generator, spans,
                     shard=None) -> ExchangeHandle:
    W = workers.n                      # chunks: one per worker, globally
    L = p.shape[0]                     # this process's rows
    ax = plan["chunk_axis"]            # axis of one worker's tensor
    shape = tuple(p.shape[1:])
    rest = _rest(shape, ax)
    # a sharded tensor's chunks (along an unsharded axis) are sharded too
    cshard = None if shard is None else shard.chunked(ax, W)
    r1 = r2 = None
    if rand is not None:
        r1, r2 = rand["phase1"], rand["phase2"]
    # ---- phase 1: each worker compresses its W chunks, all-to-all -------- #
    # one stacked compress over the L·W chunk rows, the registry
    # compressor's rounding (JAX vmaps `compressor.compress` over them)
    e1 = ef_state.get("e1", torch.zeros_like(p))

    def chunks(t):     # (L, ..., ax, ...) -> (L·W, ax/W, *rest)
        return torch.movedim(t, ax + 1, 1).reshape(
            (L * W, shape[ax] // W) + rest)

    with device_span("compress", spans):
        payload, _, e_new = compress_with_ef_stacked(
            compressor, chunks(p), chunks(e1.to(p.dtype)),
            None if r1 is None else r1.reshape(L * W, -1), generator,
            use_ef=use_ef, allow_fused=False, shard=cshard)
    if use_ef:
        e_new = e_new.reshape((L, shape[ax]) + rest)
        new_state["e1"] = torch.movedim(e_new, 1, ax + 1).to(e1.dtype)
    payload = {k: v.reshape((L, W) + v.shape[1:]) for k, v in payload.items()}
    moved = {k: workers.all_to_all(v) for k, v in payload.items()}
    chunk_shape = (shape[ax] // W,) + rest
    contrib = decompress_rows(                  # (L_dst, W_src, chunk)
        compressor, {k: v.reshape((L * W,) + v.shape[2:])
                     for k, v in moved.items()}, chunk_shape, torch.float32,
        cshard).reshape((L, W) + chunk_shape)
    chunk_mean = contrib.mean(dim=1)   # owner d's chunk of q̂
    # ---- phase 2: owner compress (+ owner EF e2), all-gather ------------- #
    e2 = ef_state["e2"].reshape(chunk_mean.shape)
    with device_span("compress", spans):
        payload2, _, e2_new = compress_with_ef_stacked(
            compressor, chunk_mean, e2, r2, generator, use_ef=True,
            shard=cshard)
    new_state["e2"] = e2_new.reshape(ef_state["e2"].shape).to(
        ef_state["e2"].dtype)
    pends = {k: workers.start_all_gather(v) for k, v in payload2.items()}

    def _finish_two_phase():
        gathered = {k: h.wait() for k, h in pends.items()}
        chunks_q = decompress_rows(compressor, gathered, chunk_shape,
                                   torch.float32, cshard)
        q = torch.movedim(chunks_q.reshape((shape[ax],) + rest), 0, ax)
        return q.to(p.dtype), new_state

    return ExchangeHandle("two_phase", _finish_two_phase)


# --------------------------------------------------------------------------- #
# fsdp split-phase primitives
# --------------------------------------------------------------------------- #
def start_reduce_scatter(compressor, kind: str, p, ef_state: dict, rand,
                         workers: _Workers, use_ef: bool, generator=None,
                         spans: bool = False) -> ExchangeHandle:
    """The fsdp gradient leg: the (compressed) reduce-scatter of one flat
    bucket, p (L, d) with d % W == 0. The handle finishes to (q_shard,
    new EF state), q_shard (L, d/W) holding each of this process's workers'
    chunk of the mean message. `rand` (None: drawn from `generator`) holds
    the draws of these rows: (L, W, ...) for two_phase, worker w's for
    chunk j; with one worker the bucket's own (1, ...). Split points
    (start | finish), as in the JAX package:

      exact     : reduce_scatter(p)                    | identity
      two_phase : compress+EF per chunk, all_to_all    | decompress+mean

    two_phase is phase 1 of the two_phase exchange (worker-side e1, the
    registry compressor's rounding, int8 on the wire) without its phase 2:
    the shard owner consumes q_shard, and what returns to the workers is
    the all-gather leg (`start_all_gather_shard`). With one worker the
    shard is the bucket, compressed as the W > 1 workers compress theirs
    (through the fused kernel where it applies)."""
    W = workers.n
    new_state = dict(ef_state)
    if W == 1:
        if kind == "exact":
            return _resolved(kind, p, new_state)
        e1 = ef_state.get("e1", torch.zeros_like(p))
        with device_span("compress", spans):
            _, p_hat, e_new = compress_with_ef_stacked(
                compressor, p, e1, rand, generator, use_ef=use_ef)
        if use_ef:
            new_state["e1"] = e_new.to(e1.dtype)
        return _resolved(kind, p_hat.to(p.dtype), new_state)
    if kind == "exact":
        pend = workers.start_reduce_scatter(p)
        return ExchangeHandle(kind, lambda: (pend.wait().to(p.dtype),
                                             new_state))
    if kind != "two_phase":
        raise ValueError(
            f"fsdp reduce-scatter: kind must be 'exact' or 'two_phase', "
            f"got {kind!r}")
    L, d = p.shape
    c = d // W
    e1 = ef_state.get("e1", torch.zeros_like(p))
    with device_span("compress", spans):
        payload, _, e_new = compress_with_ef_stacked(
            compressor, p.reshape(L * W, c), e1.to(p.dtype).reshape(L * W, c),
            None if rand is None else rand.reshape(L * W, -1), generator,
            use_ef=use_ef, allow_fused=False)
    if use_ef:
        new_state["e1"] = e_new.reshape(L, d).to(e1.dtype)
    # int8 on the wire: (L_src, W_chunk, ...) -> (L_dst, W_src, ...)
    pends = {k: workers.start_all_to_all(v.reshape((L, W) + v.shape[1:]))
             for k, v in payload.items()}

    def _finish_rs():
        moved = {k: h.wait() for k, h in pends.items()}
        contrib = decompress_rows(
            compressor, {k: v.reshape((L * W,) + v.shape[2:])
                         for k, v in moved.items()}, (c,), torch.float32)
        return contrib.reshape(L, W, c).mean(dim=1).to(p.dtype), new_state

    return ExchangeHandle(kind, _finish_rs)


def start_all_gather_shard(compressor, shard, ag_ef, rand,
                           workers: _Workers, use_ef: bool, generator=None,
                           spans: bool = False) -> ExchangeHandle:
    """The fsdp return leg: the (compressed) all-gather of each owner's
    shard, shard and ag_ef (L, c) (the quantized optimizer-state exchange
    of arXiv 2004.14180). Each owner compresses (shard + residual) and
    keeps e' = (shard + e) − Q(shard + e): one stacked compress over the L
    rows, so one fused-kernel launch over all of their L·c/1024 scale rows
    where the compressor is the kernel's. Every worker decompresses the
    same W payloads, so the gathered flat bucket (W·c,) is identical on
    all of them. Finishes to (that bucket, the owners' new residual)."""
    with device_span("compress", spans):
        payload, c_hat, e_new = compress_with_ef_stacked(
            compressor, shard, ag_ef, rand, generator, use_ef=use_ef)
    new_ef = e_new if use_ef else ag_ef
    if workers.n == 1:
        return _resolved("allgather_shard", c_hat.reshape(-1).to(shard.dtype),
                         new_ef)
    pends = {k: workers.start_all_gather(v) for k, v in payload.items()}

    def _finish_ag():
        gathered = {k: h.wait() for k, h in pends.items()}
        chunks = decompress_rows(compressor, gathered, tuple(shard.shape[1:]),
                                 torch.float32)
        return chunks.reshape(-1).to(shard.dtype), new_ef

    return ExchangeHandle("allgather_shard", _finish_ag)


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
