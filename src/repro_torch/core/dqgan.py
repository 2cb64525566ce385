"""DQGAN (paper Algorithm 2) over W workers (counterpart of
`repro.core.dqgan`).

    w_{t-1/2}^m = w_{t-1} - [η F(w_{t-3/2}^m; ξ_{t-1}^m) + e_{t-1}^m]
    g_t^m       = F(w_{t-1/2}^m; ξ_t^m)                  (each worker m)
    p_t^m       = η g_t^m + e_{t-1}^m;  p̂_t^m = Q(p_t^m);  e_t^m = p_t^m - p̂_t^m
    w_t         = w_{t-1} - (1/M) Σ_m p̂_t^m               (the server)

The JAX package maps the M workers onto its devices (a `data` mesh axis
under `shard_map`). Here they are a leading axis of every per-worker
tensor: all W on one device (`core.exchange.StackedWorkers`), or, given a
`launch.mesh.ProcessMesh`, a contiguous block of L = W / data of them on
each data rank of a `torch.distributed` mesh (`core.exchange.
ProcessGroupWorkers`), the rows a sharding of the worker axis over the
data axis gives. Per-worker state (prev_grad, ef, sched) holds this
process's L rows, the global batch splits W ways in order and each data
rank takes its L slices (every model rank of a data index the same
ones), each worker evaluates its own field at its own w_{t-1/2}, the
exchange runs the backend's collectives over the data group, and the
server update runs on the replicated state on every rank. The metrics
reduce over all W workers (mean; the staleness also by max). With one
worker the exchange is (EF-)compression, per leaf or over flat comm
buckets.

The mesh's 'model' axis (the JAX package's tensor parallelism, which
GSPMD handles there): the field is built over the rank's shards
(`models.build(cfg, mesh=...)`) and `param_specs` gives the spec of each
full leaf. Each rank holds only its shards of the parameters, their
optimizer state and their residuals. The comm layout is built from the
full shapes and specs, as the JAX package's is: the sharded leaves leave
the buckets (`layout.skipped`) and take the per-tensor exchange over the
data group, compressed as their global tensors are
(`error_feedback.LeafShard`: a scale reduced over the model group, draws
made at the global shape, each rank taking its slice); the replicated
leaves bucket as before, computed alike on every model rank. The norms
in the metrics sum the sharded leaves over the model group.

The fsdp parameter layout (the JAX package's Mode B, a
`launch.mesh.ProcessMesh` of layout "fsdp"): the parameters are cut
over the data axis as well (`param_specs` under "fsdp"), the workers are
the pods (W = pods, one a pod), a rank takes its data index's rows of
its worker's batch, and the field (`models.build(cfg, mesh)`) gathers
each period's parameters over the fsdp group and returns the gradient of
the worker's loss with respect to the rank's shards. One pod runs the
single-worker step; across pods the vmap step runs over the exchange
group (the mean of the workers' decompressed messages, exchange `sim`).
A leaf sharded over either axis skips the buckets; `loss` sums the data
ranks' shares, and the norms sum each leaf over the groups it is cut
over.

Partial participation masks the sitting workers' messages and residuals
to zero, rescales q̂ by W/n and folds their messages into their EF. An
adaptive PlanFamily selects each bucket's level count by the round's
participant count, on the device, and the bucket's `TracedQuant` runs
the fused kernel's dynamic-levels variant (B2) once per bucket over all
W workers' rows; a static `*_block1024` plan runs B1 the same way. With
one worker, where every bucket runs B1 at one level count, the step packs
its buckets back to back and makes ONE B1 launch over all of their rows
(`_exchange_packed`).

Schedules (`strategy.Schedule`, the JAX package's `_worker_body`
dataflow): under `local_k(K)` the message accumulates in
`sched["accum"]` and only a step called with `do_exchange=True` exchanges
and updates the server state (the EF residuals too: a mid-round step
leaves them as they were); under `delayed(τ)` the wire carries the head
of each worker's pending ring (its τ_m pull slot under a `tau_vector`),
the OMD lookahead also subtracts the worker's in-flight messages, and
the per-worker `versions` advance for the round's participants.

Overlap (`exchange.overlap` under `delayed`, whose wire message is the
pending ring's head, known before the round's field): the exchange
starts before the extrapolation and the field, on a second CUDA stream,
and finishes after the field, as the JAX package issues it before its
field compute. Same operations on the same operands: bit-equal to the
blocking order.

State mirrors the JAX package's `DQState`, parameters keep its layout and
leaf order. Randomness comes from `torch.Generator`s on the trainer's
device, re-seeded at the start of every step: worker m draws from its
own, seeded from (seed, step, m) alone, whatever the split over ranks,
so a run restored from a checkpoint draws what the uninterrupted run
drew; the participation mask comes from the shared stream, worker 0's
seed, alike on every rank (with one worker the one generator is seeded
from (seed, step) as before). Or from `draws` handed to `step` (the
tests replay the JAX package's draws that way).

Observability (`repro_torch.obs`, the JAX package's record sites): at
`metrics` wire or full the step hands an `obs.Collector` to the exchange,
which records each bucket (or leaf) as it finishes: the message, the
compression operand m = message + e_prev and the fresh residual e' (B1's
or B2's own), masked as they went on the wire under partial
participation; the step adds the post-exchange EF norms and the
staleness histogram, sums over the ranks and finalizes into
`metrics["obs"]`. Off hands it a `obs.NullCollector`, which launches
nothing. The collector only reads: parameters and EF are bit-equal
across off, wire and full. With `spans` on, `repro.obs/<phase>` profiler
ranges mark the field, compress, exchange and apply.

Compressed-gradient FSDP (`exchange.parallelism='fsdp'`, ZeRO stages 2
and 3, the JAX package's `_start_fsdp`): the optimizer state shards over
the workers, each owning a contiguous (size/W,) chunk of every flat
bucket (`DQState.fsdp`, rows like every per-worker field). A round packs
the message, runs each bucket's (compressed) reduce-scatter with the
workers' e1 residuals, applies the optimizer on each owner's chunk of the
mean (`_shard_update`), then the (compressed) all-gather of the update
shard (zero-2) or of the updated parameter shard (zero-3, whose `w` slot
is authoritative) under `strategy.moments`' compressor with the owners'
residual `age`, and unpacks the gathered buckets into the parameters,
identical on every worker. Under `overlap` only the reduce-scatter starts
before the field. Worker m draws, after its field's latents, its
reduce-scatter chunks of every bucket, then its all-gather shard of every
bucket, overlapped or not.

`spmd='vmap'` (the JAX package's `_step_vmap`): the stacked step with
each leaf compressed by the registry compressor (`allow_fused=False`, so
no kernel), the mean over the worker axis, and JAX's vmap metrics: the
global norms over all workers' gradients and residuals, not the mean of
per-worker norms. It runs on stacked workers, or over the pods of an
fsdp-layout mesh (one worker a pod, the mean over the exchange group).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import obs as OBS
from repro_torch import tree as T
from repro_torch.comm import CommLedger
from repro_torch.comm import buckets as B
from repro_torch.configs.base import DQConfig
from repro_torch.parallel import fsdp as FS
from repro_torch.parallel import sharding as shd
from repro_torch.parallel import tensor as TP
from repro_torch.sched.participation import round_count
from repro_torch.strategy import Strategy

from . import compressors as C
from . import exchange as X
from .error_feedback import (LeafShard, compress_with_ef_stacked,
                             fused_quantize_ef, leaf_stream, packed_levels)


class DQState(NamedTuple):
    """Optimizer state; the fields of `repro.core.dqgan.DQState`. Trees are
    nested dicts in the parameters' structure; per-worker trees (prev_grad,
    ef) have a leading worker axis of size W. `step` is a Python int."""
    step: int
    params: Any
    prev_grad: Any       # F(w_{t-3/2}; ξ_{t-1}) per worker (omd, local) | None
    prev_update: Any     # q̂_{t-1} (omd, global) or Adam prev direction | None
    ef: Any              # exchange EF state dicts | None
    m: Any               # Adam first moment | None
    v: Any               # Adam second moment | None
    sched: Any = None    # schedule buffers: None for every_step
    # fsdp shard state, {str(bid): {slot: (L, size/W) float32}}: "age" the
    # owners' all-gather residual, "m"/"v" Adam moments, "dir" oadam's
    # previous direction, "w" the authoritative parameter shard (zero-3).
    # None outside fsdp, where m/v/prev_update hold the replicated state.
    fsdp: Any = None


class StepOutput(NamedTuple):
    state: DQState
    metrics: Any
    # the round's (W,) participation mask as this rank drew and applied
    # it (None at full participation)
    mask: Optional[torch.Tensor] = None


def _firsts(message):
    """Each (L, ...) message's first row (None for a spent one): the
    templates `comm.buckets.unpack_into` reads the bucketed leaves'
    dtypes from."""
    return [None if m is None else m[0] for m in message]


def _cut_key(shard):
    """(cut over 'model', cut over 'data') of a leaf's `LeafShard`."""
    if shard is None:
        return (False, False)
    return (shard.axis is not None and shard.size > 1,
            shard.data_axis is not None and shard.data_size > 1)


class _CutGroups:
    """The groups a sharded leaf is cut over, as one group: `all_reduce`
    over each in turn, `size` their product (what `obs.Collector.leaf`
    takes)."""

    def __init__(self, shard):
        self.shard = shard
        self.size = math.prod(n for _, _, n, _ in shard.cuts)

    def all_reduce(self, x, op=None):
        return self.shard.reduce(x, op)


def _record_stream(tree, stream):
    """Tell the caching allocator that `stream` uses every CUDA tensor of
    `tree` (made on another stream), so that it is not reused early."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            tree.record_stream(stream)
    elif isinstance(tree, dict):
        for v in tree.values():
            _record_stream(v, stream)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _record_stream(v, stream)


def _ef_tensors(ef):
    """Every residual tensor of an EF tree (leaf dicts and bucket dicts,
    or a list of such trees)."""
    if isinstance(ef, list):
        return [t for sub in ef for t in _ef_tensors(sub)]
    out = []
    for leaf in T.leaves(ef) if isinstance(ef, dict) else []:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _obs_op_err(p, e, ne):
    """(compression operand, fresh residual) for obs collection: the
    operand is message + e_prev (what the compressor saw, float32), the
    residual the new e1. Streams that never compress keep their residual
    (or none: zeros), as in the JAX package."""
    e1 = e.get("e1") if e else None
    op = p if e1 is None else p + e1.float()
    err = ne.get("e1") if ne else None
    return op, (torch.zeros_like(p) if err is None else err)


def _bcast(mask, x):
    """A (W,) mask shaped to broadcast over a (W, ...) stack."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


@dataclasses.dataclass
class DQGAN:
    """DQGAN trainer over `workers` workers. Build once per (field,
    strategy, device, workers, mesh); then `init(params)` and
    `step(state, batch)`.

    `field_fn(params, batch, z=None, generator=None) -> (grads, metrics)`;
    a field that draws from the generator exposes the draw as
    `field_fn.draw_z(batch, generator)`, which the step calls ahead of the
    exchange (an overlapped step refuses a field that draws without it).
    `dq` carries the optimizer knobs and the strategy (or pass `strategy`
    alone, like the JAX package). `workers`
    (W) > 1 stands for the JAX package's device count and needs
    `strategy.exchange.worker_axes`. `mesh` (a `launch.mesh.ProcessMesh`)
    spreads the W workers over its data ranks (a `launch.mesh.meta_mesh`:
    one rank traced on the meta device); None stacks them on `device`.
    A mesh with a model axis above 1 needs `param_specs`, the spec tree
    of the full parameters (`parallel.sharding.param_specs` over the
    mesh, what `models.param_specs(cfg, mesh)` gives); the parameters
    handed to `init` are then the rank's shards.
    `device` is where the generators draw: the parameters' device (the
    mesh's, given one; the CPU for the meta device). On CUDA, constructing
    the trainer turns TF32 off for matmuls and convolutions (process-wide
    PyTorch flags)."""

    field_fn: Callable
    dq: Optional[DQConfig] = None
    strategy: Optional[Strategy] = None
    device: Any = "cuda"
    seed: int = 0
    workers: int = 1
    mesh: Any = None
    param_specs: Any = None
    generator: torch.Generator = dataclasses.field(init=False, repr=False)
    _comm_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    def __post_init__(self):
        if self.dq is None:
            self.dq = DQConfig.from_strategy(self.strategy or Strategy())
        elif self.strategy is not None and self.strategy != self.dq.strategy:
            raise ValueError(
                "DQGAN: dq and strategy disagree:\n  "
                + "\n  ".join(self.dq.strategy.diff(self.strategy)))
        self.strategy = self.dq.strategy
        fsdp_mesh = getattr(self.mesh, "fsdp", False)
        if (self.strategy.exchange.spmd == "vmap" and self.mesh is not None
                and not fsdp_mesh):
            raise ValueError(
                "DQGAN: spmd='vmap' runs on stacked workers only, because "
                "the JAX package's vmap step calls no collective of its "
                "own (its worker axis is sharded by the compiler), so "
                "there is nothing to run over a process group; use "
                "spmd='shard_map' with a mesh")
        if self.workers < 1:
            raise ValueError(f"DQGAN: workers must be >= 1, got "
                             f"{self.workers}")
        if self.workers > 1 and not self.strategy.exchange.worker_axes:
            raise ValueError(
                "DQGAN: workers > 1 needs strategy.exchange.worker_axes "
                "(the JAX package runs one worker without them)")
        self.model = self.mesh.model if self.mesh is not None else 1
        # under the fsdp layout the parameters are also cut over 'data'
        self.data_cut = self.mesh.data if fsdp_mesh else 1
        if (self.model > 1 or fsdp_mesh) and self.param_specs is None:
            raise ValueError(
                "DQGAN: a mesh with a model axis of "
                f"{self.model} (or the fsdp layout) needs param_specs (the "
                "spec tree of the full parameters, "
                "parallel.sharding.param_specs)")
        if (self.model > 1 or fsdp_mesh) and self.fsdp:
            raise ValueError(
                "DQGAN: exchange.parallelism='fsdp' keeps a pure data mesh "
                "(its flat shard buckets need every leaf replicated), as "
                "the JAX launcher does; use a model axis of 1 and the dp "
                "layout")
        self._mg = TP.model_group_for(self.mesh)
        self._fg = FS.fsdp_group_for(self.mesh)
        if self.mesh is not None:
            self.device = self.mesh.device
        self.device = torch.device(self.device)
        if self.device.type == "cuda":
            # the reference computes in float32; cuDNN convolutions would
            # otherwise run in TF32 (about three decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self._workers = (X.StackedWorkers(self.workers) if self.mesh is None
                         else X.workers_for(self.mesh, self.workers))
        # the shared stream (worker 0's seed) and one generator a local
        # worker; the rank holding worker 0 draws its draws from the shared
        # one, after the mask. The meta device has no generator
        # (launch.dryrun's traced step draws from CPU ones)
        gen_dev = "cpu" if self.device.type == "meta" else self.device
        self.generator = torch.Generator(device=gen_dev)
        self.generator.manual_seed(self.seed)
        self._gens = [self.generator if self.offset + i == 0
                      else torch.Generator(device=gen_dev)
                      for i in range(self.n_local)]
        self._side = None

    # ------------------------------------------------------------------ #
    @property
    def n_workers(self) -> int:
        return self.workers

    @property
    def n_local(self) -> int:
        """The workers this process holds (L; W without a mesh)."""
        return self._workers.n_local

    @property
    def offset(self) -> int:
        """The global index of this process's first worker."""
        return self._workers.offset

    @property
    def worker_backend(self):
        """The `core.exchange` backend the collectives run on."""
        return self._workers

    @property
    def compressor(self) -> C.Compressor:
        return self.strategy.compression.get()

    @property
    def uses_adam(self) -> bool:
        return self.dq.optimizer in ("adam", "oadam")

    @property
    def bucketed(self) -> bool:
        return self.strategy.compression.bucketing

    @property
    def adaptive(self) -> bool:
        return self.strategy.compression.adaptive

    @property
    def fsdp(self) -> bool:
        """True under exchange.parallelism='fsdp': the optimizer state
        shards over the workers, the gradients ride a (compressed)
        reduce-scatter and the updates or parameters an all-gather."""
        return self.strategy.exchange.fsdp

    @property
    def vmap(self) -> bool:
        """True when the JAX package would run the vmap step: spmd='vmap'
        over more than one worker."""
        return self.strategy.exchange.spmd == "vmap" and self.n_workers > 1

    @property
    def ef_dtype(self) -> torch.dtype:
        return getattr(torch, self.strategy.compression.ef_dtype)

    def _comm_full(self, params):
        """(BucketLayout, CommPlan, PlanFamily | None, device levels table
        | None), derived from leaf shapes, memoized. An adaptive
        strategy's CommPlan is its family's full-participation member."""
        shapes = self._shapes(params)
        key = tuple(zip(*T.flatten(shapes)))
        hit = self._comm_cache.get(key)
        if hit is None:
            comp = self.strategy.compression
            table = None
            if self.adaptive:
                layout, family = comp.build_family(shapes, self.param_specs,
                                                   self.n_workers)
                plan = family.full
                if family.n_distinct > 1:
                    # (M, n_buckets) level counts, on the device once
                    table = torch.tensor(family.levels_table(),
                                         dtype=torch.float32,
                                         device=self.device)
            else:
                layout, plan = comp.build(
                    shapes, self.param_specs, self.n_workers,
                    axis_sizes=(None if self.mesh is None
                                else self.mesh.shape))
                family = None
            hit = (layout, plan, family, table)
            self._comm_cache[key] = hit
        return hit

    # ------------------------------------------------------------------ #
    # repro_torch.obs wiring
    # ------------------------------------------------------------------ #
    @property
    def obs_spec(self):
        """The resolved `repro_torch.obs.MetricSpec` of this trainer."""
        return self.strategy.observability.spec()

    @property
    def _obs_spans(self) -> bool:
        return self.strategy.observability.spans

    def _obs_bins(self) -> int:
        """Staleness-histogram bins: 0..τ plus one overflow bin (partial
        participation lets a sitting worker's staleness exceed τ)."""
        return self.strategy.schedule.staleness + 2

    def _obs_collector(self, tree):
        """A live `Collector` when metrics are on, else the `NullCollector`
        (whose record calls do nothing)."""
        spec = self.obs_spec
        if not spec.on:
            return OBS.NullCollector()
        n_buckets = len(self._comm(tree)[0].buckets) if self.bucketed else 0
        return OBS.Collector(spec, n_buckets, self.device)

    def _obs_finalize(self, col, new_ef, st_now, params_tree):
        """`metrics["obs"]`: the collector's sums, the post-exchange EF
        norms (model-sharded residuals summed over the model group) and
        the staleness histogram, summed over the data ranks."""
        spec = self.obs_spec
        sums = col.sums()
        if spec.ef_norms:
            ef_rep, ef_sh = self._ef_split(params_tree, new_ef)
            e1, e2 = OBS.ef_norms_sq(ef_rep, self.device)
            for key in sorted({_cut_key(sh) for _, sh in ef_sh}):
                s12 = torch.stack(OBS.ef_norms_sq(
                    [d for d, sh in ef_sh if _cut_key(sh) == key],
                    self.device))
                s12 = self._reduce_cut(s12, key)
                e1, e2 = e1 + s12[0], e2 + s12[1]
            sums["e1_sq"], sums["e2_sq"] = e1, e2
        if spec.staleness:
            # staleness-free schedules: every worker at staleness 0
            st = st_now if st_now.dim() else st_now.expand(self.n_local)
            sums["staleness_hist"] = OBS.staleness_hist(st, self._obs_bins())
        sums = self._workers.sum_dict(sums)
        return OBS.finalize(spec, sums, col.counts(), self.n_workers,
                            col.n_buckets)

    def _shapes(self, params):
        """The shape tree of the full parameters (each leaf's rank-local
        shape, its sharded dimensions times the model axis and, under the
        fsdp layout, the data axis)."""
        if self.param_specs is None:
            return T.tree_map(lambda x: tuple(x.shape), params)
        paths, leaves = T.flatten(params)
        specs = T.flatten_up_to(paths, self.param_specs)
        return T.unflatten(paths, [
            shd.global_shape(tuple(x.shape), sp, self.model, self.data_cut)
            for x, sp in zip(leaves, specs)])

    def _leaf_shards(self, params):
        """Per leaf (flatten order): the `LeafShard` of a leaf sharded
        over the model axis (or, under the fsdp layout, the data axis),
        else None."""
        paths, leaves = T.flatten(params)
        mg, fg = self._mg, self._fg
        if mg is None and fg is None:
            return [None] * len(paths)
        key = ("shards",) + tuple(tuple(x.shape) for x in leaves)
        hit = self._comm_cache.get(key)
        if hit is None:
            shapes = T.flatten_up_to(paths, self._shapes(params))
            specs = T.flatten_up_to(paths, self.param_specs)
            hit = []
            for sh, sp in zip(shapes, specs):
                ma = None if mg is None else shd.model_axis(sp)
                da = None if fg is None else shd.data_axis(sp)
                hit.append(None if ma is None and da is None else LeafShard(
                    sh, ma, 0 if mg is None else mg.index,
                    1 if mg is None else mg.size, mg, da,
                    0 if fg is None else fg.index,
                    1 if fg is None else fg.size, fg))
            self._comm_cache[key] = hit
        return hit

    def state_shards(self, state):
        """The model-sharded leaves of `state` for `checkpoint` (a
        `checkpoint.ModelShards`: how each is cut; the parameters' shards
        and everything laid out like them, and the per-tensor two_phase
        residuals e2, stored as reshapes of their chunks), or None
        without a model axis."""
        if self._mg is None and self._fg is None:
            return None
        from repro_torch import checkpoint as CK
        paths, leaves = T.flatten(state.params)
        plans = self._plans(state.params)
        sharded = {"/".join(map(str, p)): (sh, pl)
                   for p, sh, pl in zip(paths, self._leaf_shards(
                       state.params), plans) if sh is not None}
        out = {}
        for name, leaf in CK._paths(state):
            rest = name.partition("/")[2]
            for pre in ("leaf/", "accum/", "pending/"):
                if rest.startswith(pre):
                    rest = rest[len(pre):]
            e2 = rest.endswith("/e2")
            for suf in ("/e1", "/e2"):
                if rest.endswith(suf):
                    rest = rest[:-len(suf)]
            if rest not in sharded or not hasattr(leaf, "dim"):
                continue
            sh, plan = sharded[rest]
            local, full = sh.local_shape, sh.shape
            view, cut = local, sh
            if e2:      # the chunk of chunk_axis ax, (c_ax, *rest)
                ax, W = plan["chunk_axis"], self.n_workers
                cut = sh.chunked(ax, W)
                local = tuple(d // W if i == ax else d
                              for i, d in enumerate(local))
                full = tuple(d // W if i == ax else d
                             for i, d in enumerate(full))
                view = cut.local_shape
            out[name] = CK.ShardedLeaf(
                local, full, view,
                cut.axis if cut.size > 1 else None,
                cut.data_axis if cut.data_size > 1 else None)
        return CK.ModelShards(out, self._mg, self._fg)

    def _comm(self, params):
        """(BucketLayout, CommPlan): the static (full-participation) view."""
        return self._comm_full(params)[:2]

    def _family(self, params):
        """The PlanFamily, or None for a non-adaptive strategy."""
        return self._comm_full(params)[2]

    def comm_ledger(self, params) -> CommLedger:
        """Per-step wire cost of this trainer (launch.train's log fields)."""
        strat = self.strategy
        shapes = self._shapes(params)
        if self.bucketed:
            layout, cplan, family, _ = self._comm_full(params)
            budget = (int(strat.compression.budget_mb * (1 << 20))
                      if strat.compression.plan == "delta_budget" else 0)
            plans = self._plans(params)
            return CommLedger.from_plan(
                layout, cplan, strat.exchange.kind, self.n_workers,
                strat.compression.compressor,
                leaf_plans=[plans[s.index] for s in layout.skipped],
                family=family, budget_bytes=budget,
                moment_compressor=(strat.moments.compressor
                                   if self.fsdp else None))
        return CommLedger.from_tree(strat.exchange.kind,
                                    strat.compression.compressor, shapes,
                                    self.param_specs, self.n_workers)

    def _plans(self, params):
        """Flat list of per-leaf exchange plans (flatten order)."""
        shapes = self._shapes(params)
        plans = T.flatten_up_to(T.flatten(shapes)[0],
                                self.strategy.exchange.leaf_plans(
                                    shapes, self.param_specs,
                                    self.n_workers))
        if not self.bucketed:
            return plans
        layout, _ = self._comm(params)
        in_bucket = {s.index for b in layout.buckets for s in b.slots}
        return [{"strategy": "bucketed", "chunk_axis": None,
                 "fallback": False} if i in in_bucket else p
                for i, p in enumerate(plans)]

    def _validate_lr_mults(self, params):
        if not self.dq.lr_mults:
            return
        unknown = sorted(k for k, _ in self.dq.lr_mults if k not in params)
        if unknown:
            raise ValueError(
                f"lr_mults group(s) {unknown} not found in the top-level "
                f"param groups {sorted(params)}")

    def _scale_groups(self, paths, leaves):
        """Apply DQConfig.lr_mults by top-level key (TTUR)."""
        if not self.dq.lr_mults:
            return leaves
        mults = dict(self.dq.lr_mults)
        return [l * mults.get(p[0], 1.0) for p, l in zip(paths, leaves)]

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #
    def init(self, params) -> DQState:
        """Zero state around `params` (a nested dict of tensors)."""
        dq = self.dq
        W, L = self.n_workers, self.n_local
        sched_c = self.strategy.schedule
        self._validate_lr_mults(params)
        tv = sched_c.tau_vector
        if tv and len(tv) != W:
            raise ValueError(
                f"schedule.tau_vector has {len(tv)} entries but this trainer "
                f"runs {W} workers — one τ_m per worker")
        paths, leaves = T.flatten(params)
        plans = self._plans(params)
        ef_dtype = self.ef_dtype

        def zeros(x, lead=(), dtype=None):
            return torch.zeros(lead + tuple(x.shape), dtype=dtype or x.dtype,
                               device=x.device)

        def tree(fn):
            return T.unflatten(paths, [fn(x) for x in leaves])

        prev_grad = prev_update = m = v = None
        if dq.optimizer == "omd" and dq.extrapolation == "local":
            prev_grad = tree(lambda x: zeros(x, (L,)))
        # fsdp: the moments and oadam's previous direction live sharded in
        # the fsdp slots; omd 'global' is refused below
        if (dq.optimizer == "omd" and dq.extrapolation == "global"
                or dq.optimizer == "oadam") and not self.fsdp:
            prev_update = tree(zeros)
        if self.uses_adam and not self.fsdp:
            m, v = tree(zeros), tree(zeros)

        def ef_leaf(x, plan):
            st = {}
            if dq.error_feedback:
                st["e1"] = zeros(x, (L,), ef_dtype)
            if X.plan_has_owner_ef(plan):
                cs = list(x.shape)
                cs[plan["chunk_axis"]] //= W
                st["e2"] = torch.zeros((L, *cs), dtype=ef_dtype,
                                       device=x.device)
            return st or None

        ef = T.unflatten(paths, [ef_leaf(x, p) for x, p in zip(leaves, plans)])
        if self.bucketed:
            layout, _ = self._comm(params)
            bucket_ef = {}
            # fsdp has no phase-2 owner requantization: the return leg's
            # owner residual is the per-bucket "age" slot instead of e2
            if self.strategy.exchange.owner_ef and not self.fsdp:
                for b in layout.buckets:
                    bucket_ef[str(b.bid)] = {"e2": torch.zeros(
                        (L, b.size // W), dtype=ef_dtype,
                        device=leaves[0].device)}
            ef = {"leaf": ef, "bucket": bucket_ef}
        # the schedule's buffers carry the float32 message, one per worker;
        # delayed starts every version at −τ, so the staleness reads τ
        # from the first exchange on
        sched = sched_c.init_slots(
            params,
            worker_like=lambda x: zeros(x, (L,), torch.float32),
            ring_like=lambda x: zeros(x, (L, sched_c.tau), torch.float32),
            versions_like=lambda: torch.full((L,), -sched_c.tau,
                                             dtype=torch.int32,
                                             device=leaves[0].device))
        fsdp = self._init_fsdp(params) if self.fsdp else None
        return DQState(step=0, params=params, prev_grad=prev_grad,
                       prev_update=prev_update, ef=ef, m=m, v=v, sched=sched,
                       fsdp=fsdp)

    def _init_fsdp(self, params):
        """The fsdp shard slots, each (L, size/W) float32: "age" always,
        "m"/"v" under adam/oadam, "dir" under oadam, and under zero-3 "w",
        this process's rows of the packed initial parameters (so round 0's
        all-gather reconstructs w_0 under an exact compressor)."""
        dq = self.dq
        W, L = self.n_workers, self.n_local
        layout, _ = self._comm(params)
        if layout.skipped:
            skipped_ix = sorted(s.index for s in layout.skipped)
            raise ValueError(
                "exchange.parallelism='fsdp' needs every leaf in a "
                "flat bucket, but the comm planner skipped leaf "
                f"index(es) {skipped_ix} (sharded over axes outside "
                "the fsdp worker axes). Shard those leaves over the "
                "fsdp axis (shard-aware bucketing, DESIGN.md §15.1), "
                "unshard them, or use parallelism='replicated'.")
        if dq.lr_mults:
            raise ValueError(
                "lr_mults groups params by top-level key, which is "
                "undefined on fsdp's flat shard buckets — drop "
                "lr_mults or use parallelism='replicated'")
        if dq.optimizer == "omd" and dq.extrapolation == "global":
            raise ValueError(
                "extrapolation='global' needs the full applied-update "
                "tree, which fsdp never materializes at a single "
                "worker — use extrapolation='local' or "
                "parallelism='replicated'")
        _, leaves = T.flatten(params)
        device = leaves[0].device
        w_rows = None
        if self.strategy.exchange.zero_stage == 3:
            w_rows = [self._workers.rows(f.reshape(W, -1)).clone()
                      for f in B.pack(layout, [x.float() for x in leaves])]
        slots = ["age"] + (["m", "v"] if self.uses_adam else []) + (
            ["dir"] if dq.optimizer == "oadam" else [])
        fsdp = {}
        for b in layout.buckets:
            ent = {k: torch.zeros((L, b.size // W), dtype=torch.float32,
                                  device=device) for k in slots}
            if w_rows is not None:
                ent["w"] = w_rows[b.bid]
            fsdp[str(b.bid)] = ent
        return fsdp

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _split_batch(self, batch):
        """This process's L slices of the global batch split W ways in
        order (the JAX package's batch_spec P(('data',))); under the fsdp
        layout the rank's rows of its worker's slice, split over the data
        ranks in order (the JAX package's batch over ('pod', 'data'))."""
        W, D = self.n_workers, self.data_cut

        def split(x):
            if x.shape[0] % (W * D):
                raise ValueError(f"batch of {x.shape[0]} does not split "
                                 f"over {W} workers" + (
                                     f" of {D} data ranks" if D > 1 else ""))
            x = self._workers.rows(
                x.reshape((W, x.shape[0] // W) + tuple(x.shape[1:])))
            if D == 1:
                return x
            n = x.shape[1] // D
            return x.narrow(1, self.mesh.data_index * n, n)

        stacked = {k: split(x) for k, x in batch.items()}
        return [{k: x[i] for k, x in stacked.items()}
                for i in range(self.n_local)]

    def _step_seed(self, step: int, worker: int = 0) -> int:
        """Worker `worker`'s seed for step `step`: a function of (seed,
        step, worker) alone, as the JAX package folds the worker index and
        the step into its key. Worker 0's is the shared stream's."""
        return (self.seed * (1 << 32) + step
                + worker * 0x9E3779B97F4A7C15) % (1 << 64)

    def _local_rand(self, r):
        """This process's rows of an injected (W, ...) draw (a dict of
        them for two_phase), or None."""
        if r is None:
            return None
        if isinstance(r, dict):
            return {k: self._workers.rows(v) for k, v in r.items()}
        return self._workers.rows(r)

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    @torch.no_grad()
    def step(self, state: DQState, batch,
             draws: Optional[Dict[str, Any]] = None,
             do_exchange: bool = True) -> StepOutput:
        """One Algorithm-2 iteration over the W workers (this process's L
        of them, under a mesh; every rank calls it with the same global
        batch).

        `do_exchange` is read by the `local_k` schedule only, and must be
        a Python bool: the caller decides the cadence with
        `sched.ExchangeSchedule.is_exchange_step(step)`. `every_step` and
        `delayed` exchange at every call.

        `draws` (optional) replaces the generators. Each draw holds the W
        workers' draws in worker order, split W ways like the batch: a
        (W, ...) stack, or with one worker the worker's draw itself; each
        rank takes its own rows.
          "z":    (W, B/W, latent) or (B, latent), the latent draws;
          "rand": {stream: draw}, a stream being the leaf index on the
                  per-leaf path and the bucket id on the bucketed path,
                  as the JAX package folds them into its key (a leaf the
                  bucketed path skips: "leaf/<index>"; a model-sharded
                  leaf's draws are its global tensor's); for
                  two_phase with W > 1 {"phase1": (W, W, ...), "phase2":
                  (W, ...)} (see core.exchange); under fsdp
                  {"reduce_scatter": (W, W, ...) (one worker: (1, ...)),
                  "all_gather": (W, ...)}, from the JAX package's
                  split(fold_in(kq, 100_000 + bid), W) and
                  fold_in(fold_in(kq, 100_000 + bid), 1);
          "mask": (W,) float32 participation mask of the round (partial
                  participation only)."""
        dq = self.dq
        eta = dq.lr
        W, L, off = self.n_workers, self.n_local, self.offset
        wk = self._workers
        sched_c = self.strategy.schedule
        spans = self._obs_spans
        if sched_c.kind == "local_k":
            if not isinstance(do_exchange, bool):
                raise TypeError(
                    "schedule='local_k' needs a Python bool do_exchange; "
                    f"got {type(do_exchange).__name__}")
        else:
            do_exchange = True
        self.generator.manual_seed(self._step_seed(state.step))
        for i, g in enumerate(self._gens):
            if g is not self.generator:
                g.manual_seed(self._step_seed(state.step, off + i))
        draws = draws or {}
        rand = draws.get("rand", {})
        paths, params = T.flatten(state.params)
        plans = self._plans(state.params)
        prev_grad = (T.flatten_up_to(paths, state.prev_grad)
                     if state.prev_grad is not None else None)
        ef = state.ef
        ef_leaf_tree = ef["leaf"] if self.bucketed else ef
        ef_leaves = [dict(e) if e else {}
                     for e in T.flatten_up_to(paths, ef_leaf_tree)]
        col = self._obs_collector(state.params)
        part = self.strategy.participation.round_setup(
            W, self.generator, draws.get("mask"))
        mask_rows = wk.rows(part[0]) if part is not None else None
        # pending_buf: the delayed schedule's raw ring; pending: the (L,
        # ...) message on the wire THIS step (each worker's pull slot)
        pending_buf, pending = sched_c.wire_head(state.sched, off)
        batches = self._split_batch(batch)
        # the field's draws come first, ahead of any exchange, so that
        # every generator draws in one order whether or not it overlaps
        z = draws.get("z")
        draw_z = getattr(self.field_fn, "draw_z", None)
        if z is not None:
            zs = list(wk.rows(z.reshape((W, -1, z.shape[-1]))))
        elif draw_z is not None:
            zs = [draw_z(b, g) for b, g in zip(batches, self._gens)]
        else:
            zs = [None] * L

        # ---------- overlapped exchange start (delayed × overlap) ------- #
        # the wire head is carried state, so its exchange starts here,
        # before the field
        finish = None
        if (self.strategy.exchange.overlap and sched_c.overlappable
                and pending is not None):
            with OBS.device_span("exchange", spans):
                # fsdp: only the reduce-scatter starts here; the optimizer,
                # the all-gather and the unpack wait for its shard
                if self.fsdp:
                    finish = self._start_overlapped(
                        self._start_fsdp, state.params, paths,
                        T.flatten_up_to(paths, pending), ef_leaves,
                        state.fsdp, state.step, rand, col)
                else:
                    finish = self._start_overlapped(
                        self._start_exchange, state.params, paths,
                        T.flatten_up_to(paths, pending), ef, ef_leaves,
                        plans, rand, part, col, state.step)
        # a field without `draw_z` must then draw nothing: its draws would
        # follow the exchange's, not precede them as they do blocking
        gen_states = ([g.get_state() for g in self._gens]
                      if finish is not None and draw_z is None else None)

        # ---------- extrapolation to w_{t-1/2}, per worker ------------- #
        # delayed: w_{t-1} is τ applied updates stale, so the lookahead
        # also subtracts the sum of the worker's in-flight messages
        with OBS.device_span("lookahead", spans):
            stale = sched_c.staleness_correction(pending_buf, dq.message, eta,
                                                 off)
            stale = (T.flatten_up_to(paths, stale) if stale is not None
                     else [None] * len(params))
            if dq.optimizer == "omd" and dq.extrapolation == "local":
                w_half = []
                for w, g, e, s in zip(params, prev_grad, ef_leaves, stale):
                    upd = eta * g
                    if dq.error_feedback and "e1" in e:
                        upd = upd + e["e1"].to(w.dtype)
                    if s is not None:
                        upd = upd + s.to(w.dtype)
                    w_half.append(w - upd.to(w.dtype))      # (L, ...)
                worker_params = [T.unflatten(paths, [x[i] for x in w_half])
                                 for i in range(L)]
            elif dq.optimizer == "omd":     # global: the last applied update
                upd = T.flatten_up_to(paths, state.prev_update)
                w_half = [w - (u if s is None
                               else u + s.to(u.dtype)).to(w.dtype)
                          for w, u, s in zip(params, upd, stale)]
                if pending_buf is None:
                    worker_params = [T.unflatten(paths, w_half)] * L
                else:   # (L, ...): each worker's own in-flight messages
                    worker_params = [
                        T.unflatten(paths, [x[i] for x in w_half])
                        for i in range(L)]
            else:   # adam/oadam/sgd evaluate at the current params
                worker_params = [T.unflatten(paths, params)] * L

        # ---------- each worker's stochastic field --------------------- #
        grads_w, losses = [], []
        with OBS.device_span("field", spans):
            for i, b in enumerate(batches):
                g, met = self.field_fn(worker_params[i], b, z=zs[i],
                                       generator=self._gens[i])
                grads_w.append(T.flatten_up_to(paths, g))
                losses.append(met.get("loss", torch.zeros(())))
        if gen_states is not None and not all(
                torch.equal(a, g.get_state())
                for a, g in zip(gen_states, self._gens)):
            raise RuntimeError(
                "exchange.overlap: the field drew from its generator but "
                "has no draw_z, so the overlapped step would not draw what "
                "the blocking step draws; expose field_fn.draw_z")
        with OBS.device_span("message", spans):
            grads = [gs[0][None] if L == 1 else torch.stack(gs)
                     for gs in zip(*grads_w)]               # (L, ...)
            # the lookahead and the unstacked gradients are done with: free
            # them before the exchange's buffers come
            grads_w = worker_params = w_half = upd = None
            if dq.message == "update" and dq.optimizer == "omd":
                message = [(eta * g).float() for g in grads]
            else:
                message = [g.float() for g in grads]

            # ---------- schedule dataflow -------------------------------- #
            # accumulate (local_k), ring-shift and advance the versions
            # (delayed), or pass the fresh message through (every_step)
            exch_msg, new_sched = sched_c.fold(
                state.sched, T.unflatten(paths, message), pending,
                do_exchange, state.step, mask_rows,
                lambda tree: T.tree_map(torch.zeros_like, tree), off)

        # ---------- exchange + server update ---------------------------- #
        new_fsdp = state.fsdp
        if exch_msg is None:    # mid-round: params, moments and EF stay
            new_params, new_m, new_v, new_prev_update = (
                state.params, state.m, state.v, state.prev_update)
            new_ef = ef
        elif self.fsdp:
            # exchange and apply fused: reduce-scatter, the owners'
            # optimizer, all-gather, one pass a bucket
            with OBS.device_span("exchange", spans):
                if finish is None:
                    finish = self._start_fsdp(
                        state.params, paths, T.flatten_up_to(paths, exch_msg),
                        ef_leaves, state.fsdp, state.step, rand, col)
            with OBS.device_span("apply", spans):
                new_params, new_ef, new_fsdp = finish()
            new_m, new_v, new_prev_update = state.m, state.v, state.prev_update
        else:
            with OBS.device_span("exchange", spans):
                if finish is None:
                    # the exchange owns the message list: a leaf's message
                    # can go once its compression has started
                    msgs = T.flatten_up_to(paths, exch_msg)
                    message = exch_msg = None
                    finish = self._start_exchange(
                        state.params, paths, msgs, ef, ef_leaves, plans,
                        rand, part, col, state.step)
                    msgs = None
                qhat, new_ef = finish()
                message = exch_msg = finish = None
            with OBS.device_span("apply", spans):
                new_params, new_m, new_v, new_prev_update = (
                    self._server_update(state, paths, qhat))

        # the wire's buffers are done with before the metrics' temporaries
        message = exch_msg = qhat = finish = None
        with OBS.device_span("carry", spans):
            new_prev_grad = None
            if prev_grad is not None:
                new_prev_grad = T.unflatten(
                    paths, [g.to(o.dtype) for o, g in zip(prev_grad, grads)])

            if self.vmap:
                loss, gn, en, st_max, st_mean, st_now = self._vmap_metrics(
                    losses, grads, new_ef, state.step, new_sched,
                    state.params)
            else:
                loss, gn, en, st_max, st_mean, st_now = self._metrics(
                    losses, grads, new_ef, state.step, new_sched,
                    state.params)
            new_state = DQState(step=state.step + 1, params=new_params,
                                prev_grad=new_prev_grad,
                                prev_update=new_prev_update, ef=new_ef,
                                m=new_m, v=new_v, sched=new_sched,
                                fsdp=new_fsdp)
            out_metrics = {"loss": loss, "grad_norm": gn,
                           "error_norm": en, "staleness_max": st_max,
                           "staleness_mean": st_mean}
            if col.enabled:
                out_metrics["obs"] = self._obs_finalize(col, new_ef, st_now,
                                                        state.params)
        return StepOutput(state=new_state, metrics=out_metrics,
                          mask=None if part is None else part[0])

    def _ef_split(self, params_tree, new_ef):
        """(EF dicts of the replicated leaves and the buckets, [(EF dict,
        `LeafShard`)] of the sharded leaves)."""
        shards = self._leaf_shards(params_tree)
        if new_ef is None or not any(s is not None for s in shards):
            return [new_ef], []
        paths, _ = T.flatten(params_tree)
        leaf_tree = new_ef["leaf"] if self.bucketed else new_ef
        dicts = T.flatten_up_to(paths, leaf_tree)
        rep = [d for d, s in zip(dicts, shards) if s is None]
        if self.bucketed:
            rep.append(new_ef["bucket"])
        return rep, [(d, s) for d, s in zip(dicts, shards)
                     if s is not None and d is not None]

    def _reduce_cut(self, x, key):
        """x summed over the groups a leaf of cut `key` (`_cut_key`) is
        cut over."""
        if key[0]:
            x = self._mg.all_reduce(x)
        if key[1]:
            x = self._fg.all_reduce(x)
        return x

    def _global_sq(self, tensors, shards, L):
        """(L,) each worker's sum of squares of the global tensors whose
        rank-local parts (L, ...) are `tensors`, cut as `shards` says: the
        sums of the sharded ones reduced over their groups, one
        collective a group."""
        cats = {}
        for t, sh in zip(tensors, shards):
            if t is None:
                continue
            k = _cut_key(sh)
            v = torch.square(t.float()).reshape(L, -1).sum(dim=1)
            cats[k] = v if k not in cats else cats[k] + v.to(cats[k].device)
        dev = (next(iter(cats.values())).device if cats
               else torch.device(self.device))
        zero = torch.zeros((L,), device=dev)
        get = {k: cats.get(k, zero).to(dev) for k in
               ((False, False), (True, False), (False, True), (True, True))}
        if self._mg is not None and any(k[0] for k in cats):
            m = self._mg.all_reduce(torch.stack([get[(True, False)],
                                                 get[(True, True)]]))
            get[(True, False)], get[(True, True)] = m[0], m[1]
        if self._fg is not None and any(k[1] for k in cats):
            d = self._fg.all_reduce(torch.stack([get[(False, True)],
                                                 get[(True, True)]]))
            get[(False, True)], get[(True, True)] = d[0], d[1]
        return sum(get.values())

    def _ef_sq(self, params_tree, new_ef, L):
        """(L,) each worker's sum of squares of its global residuals."""
        ef_rep, ef_sh = self._ef_split(params_tree, new_ef)
        tensors = _ef_tensors(ef_rep)
        shards = [None] * len(tensors)
        for d, sh in ef_sh:
            ts = _ef_tensors(d)
            tensors += ts
            shards += [sh] * len(ts)
        return self._global_sq(tensors, shards, L)

    def _losses(self, losses):
        """This process's (L,) worker losses: under the fsdp layout the
        data group's sum of the ranks' shares."""
        ls = torch.stack(losses)
        return ls if self._fg is None else self._fg.all_reduce(ls.float())

    def _metrics(self, losses, grads, new_ef, step, new_sched, params_tree):
        """(loss, grad_norm, error_norm, staleness max, mean, the (L,)
        staleness or 0): the mean over all W workers of each worker's
        value (the JAX package's pmean), the staleness also by max
        (pmax). The norms are the global tensors' (sharded leaves summed
        over the groups they are cut over)."""
        L, wk = self.n_local, self._workers
        shards = self._leaf_shards(params_tree)
        gn_w = torch.sqrt(self._global_sq(grads, shards, L))
        en_w = torch.sqrt(self._ef_sq(params_tree, new_ef, L)).to(
            gn_w.device)
        st_now = self.strategy.schedule.staleness_now(step, new_sched,
                                                      gn_w.device)
        per_worker = [self._losses(losses), gn_w, en_w]
        if st_now.dim():
            per_worker.append(st_now)
        means = wk.mean_each(per_worker)
        loss, gn, en = means[:3]
        st_max, st_mean = ((wk.max(st_now), means[3]) if st_now.dim()
                           else (st_now, st_now))
        return loss, gn, en, st_max, st_mean, st_now

    def _vmap_metrics(self, losses, grads, new_ef, step, new_sched,
                      params_tree):
        """`_metrics` as the JAX package's vmap step defines them: the loss
        is the workers' mean, grad_norm and error_norm the global norms of
        all workers' stacked gradients and residuals (not a mean of
        per-worker norms), the staleness max and mean over the workers
        under delayed, else 0. Over a mesh (the fsdp layout's pods) the
        sums run over the exchange group and the groups a leaf is cut
        over."""
        if self.mesh is not None:
            L, wk = self.n_local, self._workers
            shards = self._leaf_shards(params_tree)
            sq = wk.sum_dict({
                "g": self._global_sq(grads, shards, L).sum(),
                "e": self._ef_sq(params_tree, new_ef, L).sum().to(
                    self.device)})
            st_now = self.strategy.schedule.staleness_now(step, new_sched,
                                                          self.device)
            st_max, st_mean = ((wk.max(st_now), wk.mean_each([st_now])[0])
                               if st_now.dim() else (st_now, st_now))
            return (wk.mean_each([self._losses(losses)])[0],
                    torch.sqrt(sq["g"]), torch.sqrt(sq["e"]), st_max,
                    st_mean, st_now)
        def global_norm(tensors):
            return torch.sqrt(sum((torch.square(t.float()).sum()
                                   for t in tensors),
                                  torch.zeros((), device=self.device)))
        st_now = self.strategy.schedule.staleness_now(step, new_sched,
                                                      self.device)
        st_max, st_mean = ((st_now.max(), st_now.float().mean())
                           if st_now.dim() else (st_now, st_now))
        return (torch.stack(losses).mean(), global_norm(grads),
                global_norm(_ef_tensors(new_ef)), st_max, st_mean, st_now)

    # ------------------------------------------------------------------ #
    # exchange: each `_start_*` issues its work and returns the finish,
    # a callable that waits for the collectives and returns (q̂, new EF)
    # (fsdp: the new parameters, EF and shard state)
    # ------------------------------------------------------------------ #
    def _start_overlapped(self, start, *args):
        """`start(*args)` (`_start_exchange` or `_start_fsdp`) on a side
        CUDA stream, after the work queued so far; the finish makes the
        current stream wait for it, and marks what the side stream made as
        used by the current one. On the CPU the start runs in line."""
        if self.device.type != "cuda":
            return start(*args)
        cur = torch.cuda.current_stream(self.device)
        side = self._side_stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fin = start(*args)

        def finish():
            cur.wait_stream(side)
            out = fin()
            _record_stream(out, cur)
            return out
        return finish

    def _start_exchange(self, params_tree, paths, message, ef, ef_leaves,
                        plans, rand, part, col, step):
        """`col` records each bucket or leaf at its finish (the
        `obs.Collector`, or the `NullCollector`); `step` seeds the leaves'
        tile streams."""
        if part is not None:
            return self._start_with_participation(
                params_tree, paths, message, ef, ef_leaves, plans, rand, part,
                col, step)
        return self._start_plain(params_tree, paths, message, ef, ef_leaves,
                                 plans, rand, col, step)

    def _leaf_streams(self, step: int, leaf: int):
        """The tile-stream seeds of leaf `leaf`'s rows at `step`, one a
        local worker (`error_feedback.leaf_stream`)."""
        return [leaf_stream(self._step_seed(step, self.offset + i), leaf)
                for i in range(self.n_local)]

    def _start_one(self, comp, plan, p, e, rand, shard=None, stream=None):
        """The finish of the exchange of one stacked (L, ...) tensor or
        bucket. One worker: (EF-)compression, whatever the strategy. The
        vmap step: each worker's registry compression, then the mean over
        the worker axis (over the exchange group, the fsdp layout's
        pods, on a mesh). `shard` (a `LeafShard`): p holds the rank's
        slices of a sharded tensor. `stream` (`_leaf_streams`): p is a
        leaf's message, whose draws above one tile come from its tile
        streams."""
        if self.vmap:
            e1 = e.get("e1", torch.zeros_like(p))
            with OBS.device_span("compress", self._obs_spans):
                _, p_hat, e_new = compress_with_ef_stacked(
                    comp, p, e1, self._local_rand(rand), self._gens,
                    use_ef=self.dq.error_feedback, allow_fused=False,
                    shard=shard, stream=stream, payload=False)
            ne = dict(e)
            if self.dq.error_feedback:
                ne["e1"] = e_new
            q = (p_hat.mean(dim=0) if self.mesh is None
                 else self._workers.mean(p_hat, self._obs_spans))
            return lambda: (q, ne)
        if self.n_workers > 1:
            exch = self.strategy.exchange
            handle = exch.start(comp, plan, p, e, self._local_rand(rand),
                                self._workers, self.dq.error_feedback,
                                self._gens, spans=self._obs_spans,
                                shard=shard, stream=stream)
            return lambda: exch.finish(handle)
        if plan["strategy"] == "exact" or comp.name == "identity":
            out = (p[0], dict(e))
            return lambda: out
        e1 = e.get("e1", torch.zeros_like(p))
        with OBS.device_span("compress", self._obs_spans):
            _, p_hat, e_new = compress_with_ef_stacked(
                comp, p, e1, rand, self.generator,
                use_ef=self.dq.error_feedback, shard=shard, stream=stream,
                payload=False)
        ne = dict(e)
        if self.dq.error_feedback:
            ne["e1"] = e_new
        return lambda: (p_hat[0], ne)

    def _start_plain(self, params_tree, paths, message, ef, ef_leaves, plans,
                     rand, col, step, plan_sel=None):
        if self.bucketed:
            return self._start_bucketed(params_tree, paths, message, ef,
                                        ef_leaves, rand, col, step, plan_sel)
        comp = self.compressor
        shards = self._leaf_shards(params_tree)
        fins = []
        for i, (plan, e, sh) in enumerate(zip(plans, ef_leaves, shards)):
            fins.append(self._start_one(comp, plan, message[i], e,
                                        rand.get(i), sh,
                                        self._leaf_streams(step, i)))
            if not col.enabled:     # the leaf's message is spent
                message[i] = None

        def finish():
            qhat, new_ef = [], []
            for f, p, e, sh in zip(fins, message, ef_leaves, shards):
                q, ne = f()
                if col.enabled:
                    self._record_leaf(col, p, e, ne, sh)
                qhat.append(q)
                new_ef.append(ne or None)
            return qhat, T.unflatten(paths, new_ef)
        return finish

    def _start_with_participation(self, params_tree, paths, message, ef,
                                  ef_leaves, plans, rand, part, col, step):
        """Partial participation: the sitting workers' messages and
        residuals are masked to zero before the exchange (every compressor
        maps 0 to a zero payload), q̂ is rescaled from 1/W to 1/n, and the
        sitting workers fold their message into their residual. Under an
        adaptive family the round's participant count selects the plan,
        on the device. The mask covers all W workers; this process masks
        its own rows. `col` records the masked stream and the residual
        before the merge, what went on the wire."""
        mask, n_part = part
        W = self.n_workers
        rows = self._workers.rows(mask)
        msg_in = [m * _bcast(rows, m) for m in message]
        ef_in = [{**e, "e1": e["e1"] * _bcast(rows, e["e1"])}
                 if "e1" in e else e for e in ef_leaves]
        plan_sel = round_count(mask) - 1 if self.adaptive else None
        inner = self._start_plain(params_tree, paths, msg_in, ef, ef_in,
                                  plans, rand, col, step, plan_sel)

        def finish():
            qhat, new_ef = inner()
            scale = W / n_part
            qhat = [(q * scale).to(q.dtype) for q in qhat]
            if not self.dq.error_feedback:
                return qhat, new_ef
            # EF merge: participants keep the exchange's residual, the
            # rest accumulate the unsent message on top of their old one
            new_leaf = new_ef["leaf"] if self.bucketed else new_ef
            news = [dict(n) if n else n
                    for n in T.flatten_up_to(paths, new_leaf)]
            for m, o, n in zip(message, ef_leaves, news):
                if "e1" in o:
                    keep = o["e1"].float() + m
                    mk = _bcast(rows, keep)
                    n["e1"] = (mk * n["e1"].float()
                               + (1.0 - mk) * keep).to(o["e1"].dtype)
            merged = T.unflatten(paths, news)
            if self.bucketed:
                return qhat, {"leaf": merged, "bucket": new_ef["bucket"]}
            return qhat, merged
        return finish

    def _start_bucketed(self, params_tree, paths, message, ef, ef_leaves,
                        rand, col, step, plan_sel=None):
        """Pack the message (and e1) into the flat buckets, (L, size) each,
        start each one's exchange with its planned compressor; the finish
        unpacks q̂ and e1 back into leaves. `plan_sel` (a device tensor:
        participants − 1) selects the adaptive family's level counts: each
        bucket's compressor becomes a `TracedQuant` over one element of the
        device table, so no value crosses to the host."""
        dq = self.dq
        ef_dtype = self.ef_dtype
        W = self.n_workers
        exch = self.strategy.exchange
        layout, cplan, family, table = self._comm_full(params_tree)
        levels = None
        if plan_sel is not None and table is not None:
            levels = table.index_select(0, plan_sel.reshape(1))[0]
            block = C.get(family.base_compressor).per_block
        bucket_ef = ef["bucket"]
        e1_leaves = None
        if dq.error_feedback:
            e1_leaves = [e.get("e1", torch.zeros(l.shape, dtype=ef_dtype,
                                                 device=l.device))
                         for l, e in zip(message, ef_leaves)]
        if levels is None:
            L = self._packed_levels(layout, cplan)
            if L is not None:
                out = self._exchange_packed(paths, layout, message,
                                            e1_leaves, bucket_ef, rand, L,
                                            col)
                skipped = self._start_skipped(params_tree, layout, message,
                                              ef_leaves, rand, col, step)
                return lambda: self._finish_skipped(paths, skipped, *out,
                                                    col)
        with OBS.device_span("pack", self._obs_spans):
            flats = B.pack(layout, message)
            e1_flats = (B.pack(layout, e1_leaves) if dq.error_feedback
                        else None)

        fins = []
        for b, assign in zip(layout.buckets, cplan.assignments):
            if levels is not None:
                comp = C.TracedQuant(levels[b.bid:b.bid + 1],
                                     per_block=block)
            else:
                comp = C.get(assign.compressor)
            plan_b = exch.bucket_plan(b.size, W)
            est = {}
            if dq.error_feedback:
                est["e1"] = e1_flats[b.bid]
            if X.plan_has_owner_ef(plan_b):
                est["e2"] = bucket_ef[str(b.bid)]["e2"]
            fins.append((b, plan_b, est,
                         self._start_one(comp, plan_b, flats[b.bid], est,
                                         rand.get(b.bid))))
        # the skipped (model-sharded) leaves after the buckets, as the JAX
        # package orders them
        skipped = self._start_skipped(params_tree, layout, message,
                                      ef_leaves, rand, col, step)

        def finish():
            out_flats, new_e1_flats, new_bucket_ef = [], [], {}
            for b, plan_b, est, fin in fins:
                q, ne = fin()
                if col.enabled:
                    col.bucket(b.bid, flats[b.bid],
                               *_obs_op_err(flats[b.bid], est, ne))
                out_flats.append(q)
                if dq.error_feedback:
                    new_e1_flats.append(ne.get("e1", est.get("e1")))
                if X.plan_has_owner_ef(plan_b):
                    new_bucket_ef[str(b.bid)] = {"e2": ne["e2"].to(ef_dtype)}
            with OBS.device_span("unpack", self._obs_spans):
                qhat = B.unpack_into(layout, out_flats, _firsts(message))
                new_leaf_ef = [None] * len(message)
                if dq.error_feedback:
                    new_e1 = B.unpack_into(layout, new_e1_flats, e1_leaves)
                    new_leaf_ef = [{"e1": x} for x in new_e1]
            return self._finish_skipped(
                paths, skipped, qhat, {"leaf": T.unflatten(paths, new_leaf_ef),
                                       "bucket": new_bucket_ef}, col)
        return finish

    def _record_leaf(self, col, p, e, ne, shard):
        """`col` records a leaf outside the buckets; a sharded one's sums
        are taken over the groups it is cut over."""
        if shard is None or not shard.cuts:
            col.leaf(p, *_obs_op_err(p, e, ne))
        else:
            col.leaf(p, *_obs_op_err(p, e, ne), group=_CutGroups(shard))

    def _start_skipped(self, params_tree, layout, message, ef_leaves, rand,
                       col, step):
        """Start the per-tensor exchange of each leaf the layout skipped
        (a sharded leaf, `rand` keyed by its leaf index, as the JAX
        package folds it): [(index, message, EF, finish, shard)]. Where
        `col` records nothing, a leaf's message leaves `message` once its
        exchange has started (the message None in the tuple too)."""
        if not layout.skipped:
            return []
        plans = self._plans(params_tree)
        shards = self._leaf_shards(params_tree)
        comp = self.compressor
        out = []
        for s in layout.skipped:
            i = s.index
            fin = self._start_one(comp, plans[i], message[i], ef_leaves[i],
                                  rand.get(f"leaf/{i}"), shards[i],
                                  self._leaf_streams(step, i))
            out.append((i, message[i] if col.enabled else None,
                        ef_leaves[i], fin, shards[i]))
            if not col.enabled:
                message[i] = None
        return out

    def _finish_skipped(self, paths, skipped, qhat, new_ef, col):
        """The bucketed exchange's (q̂, new EF) with the skipped leaves'
        results put in their places (their EF dicts whole, e2 included)."""
        if not skipped:
            return qhat, new_ef
        leaf_ef = T.flatten_up_to(paths, new_ef["leaf"])
        for i, p, e, fin, shard in skipped:
            q, ne = fin()
            if col.enabled:
                self._record_leaf(col, p, e, ne, shard)
            qhat[i] = q
            leaf_ef[i] = ne or None
        return qhat, {"leaf": T.unflatten(paths, leaf_ef),
                      "bucket": new_ef["bucket"]}

    def _packed_levels(self, layout, cplan):
        """The level count at which `_exchange_packed` realizes this
        step's exchange, or None: it needs one worker, error feedback, a
        compressing exchange, and every bucket's compressor B1 at one
        static level count (`error_feedback.packed_levels`)."""
        if (self.n_workers != 1 or not self.dq.error_feedback
                or self.strategy.exchange.kind == "exact"):
            return None
        return packed_levels([C.get(a.compressor)
                              for a in cplan.assignments],
                             [b.size for b in layout.buckets])

    def _exchange_packed(self, paths, layout, message, e1_leaves, bucket_ef,
                         rand, levels, col):
        """One worker, every bucket B1 at `levels`: the message and e1
        packed into one buffer each, the buckets back to back; ONE B1
        launch over all of their rows and one dequantization; q̂ and e1
        unpack from views of the results. Bit-equal to `_start_one`
        bucket by bucket (rows are independent and share L). Injected
        draws (`rand[bucket id]`) land on their own bucket's rows; with
        none, one draw covers the whole buffer. One worker leaves the
        owner EF (e2, two_phase) as it was. `col` records each bucket over
        views of the packed buffers: the operand is one float32 add over
        the packed buffer, the kernel's own m = g + e bit for bit, the
        residual B1's e'."""
        with OBS.device_span("pack", self._obs_spans):
            msg = B.pack_concat(layout, message)        # (Σ size,)
            e1 = B.pack_concat(layout, e1_leaves)
        r = None
        if any(b.bid in rand for b in layout.buckets):
            r = torch.cat([
                rand[b.bid].reshape(-1) if b.bid in rand else torch.rand(
                    (b.size,), generator=self.generator, device=msg.device)
                for b in layout.buckets])
        with OBS.device_span("compress", self._obs_spans):
            _, m_hat, e_new = fused_quantize_ef(msg, e1, r, self.generator,
                                                levels=levels)
        if col.enabled:
            views = [B.split_concat(layout, x, (1,))
                     for x in (msg, msg + e1, e_new)]
            for b, raw, op, err in zip(layout.buckets, *views):
                col.bucket(b.bid, raw, op, err)
        with OBS.device_span("unpack", self._obs_spans):
            qhat = B.unpack_into(layout, B.split_concat(layout, m_hat),
                                 _firsts(message))
            new_e1 = B.unpack_into(layout,
                                   B.split_concat(layout, e_new, (1,)),
                                   e1_leaves)
        return qhat, {"leaf": T.unflatten(paths, [{"e1": x}
                                                  for x in new_e1]),
                      "bucket": dict(bucket_ef)}

    def _server_update(self, state, paths, qhat):
        """Apply q̂ to the parameters (and Adam moments)."""
        dq = self.dq
        eta = dq.lr
        params = T.flatten_up_to(paths, state.params)
        new_m, new_v, new_prev_update = state.m, state.v, state.prev_update
        if dq.optimizer == "omd":
            update = qhat if dq.message == "update" else [eta * q
                                                         for q in qhat]
            new_params = [w - u.to(w.dtype) for w, u in zip(params, update)]
            if dq.extrapolation == "global":
                new_prev_update = T.unflatten(paths, update)
        elif dq.optimizer in ("adam", "oadam"):
            b1, b2 = dq.beta1, dq.beta2
            m = [b1 * m + (1 - b1) * g
                 for m, g in zip(T.flatten_up_to(paths, state.m), qhat)]
            v = [b2 * v + (1 - b2) * torch.square(g)
                 for v, g in zip(T.flatten_up_to(paths, state.v), qhat)]
            bc1, bc2 = self._bias_corrections(state.step, qhat[0].device)
            direction = self._scale_groups(
                paths, [(mm / bc1) / (torch.sqrt(vv / bc2) + dq.eps)
                        for mm, vv in zip(m, v)])
            if dq.optimizer == "oadam":
                # optimistic Adam: w ← w − η (2 d_t − d_{t−1})
                prev = T.flatten_up_to(paths, state.prev_update)
                new_params = [w - (eta * (2.0 * d - dp)).to(w.dtype)
                              for w, d, dp in zip(params, direction, prev)]
                new_prev_update = T.unflatten(paths, direction)
            else:
                new_params = [w - (eta * d).to(w.dtype)
                              for w, d in zip(params, direction)]
            new_m, new_v = T.unflatten(paths, m), T.unflatten(paths, v)
        elif dq.optimizer == "sgd":
            new_params = [w - (eta * q).to(w.dtype)
                          for w, q in zip(params, qhat)]
        else:
            raise ValueError(dq.optimizer)
        return T.unflatten(paths, new_params), new_m, new_v, new_prev_update

    def _bias_corrections(self, step: int, device):
        """Adam's (1 − β1^t, 1 − β2^t) on `device`, float32: the bias
        correction counts applied updates (one a round)."""
        t = torch.tensor(float((step + 1) // self.strategy.schedule.period))
        b1, b2 = self.dq.beta1, self.dq.beta2
        return ((1.0 - torch.tensor(b1) ** t).to(device),
                (1.0 - torch.tensor(b2) ** t).to(device))

    # ------------------------------------------------------------------ #
    # compressed-gradient FSDP
    # ------------------------------------------------------------------ #
    def _start_fsdp(self, params_tree, paths, message, ef_leaves, fb, step,
                    rand, col):
        """One fsdp round over the flat buckets: pack the (L, ...) message
        and e1, start each bucket's (compressed) reduce-scatter with its
        planned compressor. The returned finish waits for each bucket's
        shard of the mean, applies the optimizer on it (`_shard_update`),
        runs the all-gather of the update (zero-2) or the updated
        parameter shard (zero-3) under `strategy.moments` with the owners'
        residual `age`, and unpacks; it returns (new params, new EF
        {"leaf": e1 leaves, "bucket": {}}, new shard state). `col` records
        each bucket's reduce-scatter operand and residual."""
        dq = self.dq
        exch = self.strategy.exchange
        mom = self.strategy.moments
        mom_comp = mom.get()
        spans = self._obs_spans
        layout, cplan = self._comm(params_tree)
        e1_leaves = e1_flats = None
        if dq.error_feedback:
            e1_leaves = [e.get("e1", torch.zeros(l.shape, dtype=self.ef_dtype,
                                                 device=l.device))
                         for l, e in zip(message, ef_leaves)]
        with OBS.device_span("pack", spans):
            if dq.error_feedback:
                e1_flats = B.pack(layout, e1_leaves)
            flats = B.pack(layout, message)
        started = []
        for b, assign in zip(layout.buckets, cplan.assignments):
            est = {"e1": e1_flats[b.bid]} if dq.error_feedback else {}
            r = self._local_rand(rand.get(b.bid)) or {}
            h = exch.start_reduce_scatter(
                C.get(assign.compressor), flats[b.bid], est,
                r.get("reduce_scatter"), self._workers, dq.error_feedback,
                self._gens, spans)
            started.append((b, est, h, r.get("all_gather")))

        def finish():
            params = T.flatten_up_to(paths, params_tree)
            w_flats = None
            if exch.zero_stage != 3:
                with OBS.device_span("pack", spans):
                    w_flats = B.pack(layout, [p.float() for p in params])
            bc = (self._bias_corrections(step, self.device)
                  if self.uses_adam else None)
            new_w, new_e1_flats, new_fb = [], [], {}
            for b, est, h, r_ag in started:
                q_shard, ne = exch.finish(h)
                if col.enabled:
                    col.bucket(b.bid, flats[b.bid],
                               *_obs_op_err(flats[b.bid], est, ne))
                if dq.error_feedback:
                    new_e1_flats.append(ne.get("e1", est.get("e1")))
                fb_b = fb[str(b.bid)]
                ent, ag_in = self._shard_update(q_shard.float(), fb_b, bc)
                h_ag = exch.start_all_gather_shard(
                    mom_comp, ag_in, fb_b["age"], r_ag, self._workers,
                    mom.error_feedback, self._gens, spans)
                full, ent["age"] = exch.finish(h_ag)
                new_fb[str(b.bid)] = ent
                new_w.append(full if w_flats is None
                             else w_flats[b.bid] - full)
            with OBS.device_span("unpack", spans):
                new_params = T.unflatten(paths, B.unpack_into(layout, new_w,
                                                              params))
                new_leaf_ef = [None] * len(message)
                if dq.error_feedback:
                    new_leaf_ef = [{"e1": x} for x in B.unpack_into(
                        layout, new_e1_flats, e1_leaves)]
            return (new_params, {"leaf": T.unflatten(paths, new_leaf_ef),
                                 "bucket": {}}, new_fb)
        return finish

    def _shard_update(self, q_shard, fb_b, bc):
        """The optimizer on the owners' (L, c) chunk of the mean message:
        `_server_update`'s elementwise arithmetic, applied by each shard
        owner (bucket padding stays zero: zero message, zero moments, zero
        update). `bc` holds Adam's bias corrections. Returns (the new
        shard slots, the all-gather operand: the update shard under
        zero-2, the updated parameter shard under zero-3)."""
        dq = self.dq
        eta = dq.lr
        ent = {}
        if dq.optimizer == "omd":
            update = q_shard if dq.message == "update" else eta * q_shard
        elif dq.optimizer in ("adam", "oadam"):
            b1, b2 = dq.beta1, dq.beta2
            m = b1 * fb_b["m"] + (1 - b1) * q_shard
            v = b2 * fb_b["v"] + (1 - b2) * torch.square(q_shard)
            direction = (m / bc[0]) / (torch.sqrt(v / bc[1]) + dq.eps)
            ent["m"], ent["v"] = m, v
            if dq.optimizer == "oadam":
                update = eta * (2.0 * direction - fb_b["dir"])
                ent["dir"] = direction
            else:
                update = eta * direction
        elif dq.optimizer == "sgd":
            update = eta * q_shard
        else:
            raise ValueError(dq.optimizer)
        if self.strategy.exchange.zero_stage == 3:
            ent["w"] = fb_b["w"] - update
            return ent, ent["w"]
        return ent, update
