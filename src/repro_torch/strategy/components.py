"""Typed, frozen distribution-strategy components (counterpart of
`repro.strategy.components`, DESIGN.md §9). The schema is the JAX
package's field for field, so `Strategy.to_json()`/`short_hash()` agree.

Each component owns one axis of the paper's composition — *what* goes on
the wire (`Compression`), *how* workers move it (`ExchangePlan`), *when*
they talk (`Schedule`) and *who* talks (`Participation`) — and validates
its own fields at construction so a bad spelling is a one-line
`StrategyError` naming the field, not a stack trace inside the step. The
components are plain frozen dataclasses: hashable,
comparable, and serializable field-by-field (strategy.py holds the JSON
round-trip and the cross-field validation of the composed `Strategy`).

`Compression.build` produces the bucket layout + per-bucket compressor
plan (`build_family` the round-adaptive PlanFamily),
`ExchangePlan.leaf_plans` plans the per-tensor exchange and
`start`/`finish` run it across the workers, and
`Participation.round_setup` draws the round's participation mask, and
`Schedule`'s in-step methods carry the schedule dataflow of the stacked
step (`core.dqgan`), and `Observability.spec` resolves the
`repro_torch.obs` metric level the step collects.

Every field that is a CLI knob carries ``metadata`` with its legacy flag
spelling — `strategy.cli` generates the `launch.train` argparse surface
from these schemas, so the flag set, the dataclass and the JSON schema
cannot drift apart.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import torch

from repro_torch import tree as T


class StrategyError(ValueError):
    """A mis-composed distribution strategy, raised at construction time.

    Subclasses ValueError so legacy call sites (and tests) that guarded
    the old step-time `ValueError`s keep working."""


def _cli(legacy: str, help_: str, choices: Optional[Callable] = None) -> dict:
    """Field metadata for the auto-generated CLI: ``legacy`` is the
    DQConfig field / argparse dest name (the flag is ``--legacy-name``;
    booleans additionally get a generated ``--no-`` negation), ``choices``
    is a thunk evaluated at parser-build time (registries may grow after
    import)."""
    return {"legacy": legacy, "help": help_, "choices": choices,
            "flag": "--" + legacy.replace("_", "-")}


def _compressor_names():
    from repro_torch.core import compressors as C
    return tuple(sorted(C.REGISTRY))


def _plan_policies():
    from repro_torch.comm.planner import ALL_POLICIES
    return ALL_POLICIES


def _exchange_kinds():
    from repro_torch.core.exchange import STRATEGIES
    return STRATEGIES


def _schedule_kinds():
    from repro_torch.sched.schedule import SCHEDULES
    return SCHEDULES


def _straggler_profiles():
    from repro_torch.sched.straggler import PROFILES
    return tuple(sorted(PROFILES))


SPMD_STYLES = ("shard_map", "vmap")

PARALLELISM_MODES = ("replicated", "fsdp")

ZERO_STAGES = (2, 3)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Compression:
    """WHAT goes on the wire: the δ-approximate compressor, error
    feedback, and the repro.comm bucket/planner pipeline."""

    compressor: str = field(default="qsgd8_linf", metadata=_cli(
        "compressor", "key into core.compressors.REGISTRY",
        _compressor_names))
    error_feedback: bool = field(default=True, metadata=_cli(
        "error_feedback", "carry the compression residual (paper EF)"))
    ef_dtype: str = field(default="float32", metadata=_cli(
        "ef_dtype", "dtype of the EF residuals (bf16 halves EF memory)"))
    plan: str = field(default="none", metadata=_cli(
        "comm_plan", "repro.comm bucketing + layer-wise planner policy",
        _plan_policies))
    bucket_mb: float = field(default=4.0, metadata=_cli(
        "bucket_mb", "f32 MiB per gradient bucket"))
    budget_mb: float = field(default=0.0, metadata=_cli(
        "comm_budget_mb", "delta_budget policy: payload MiB/step target"))
    adaptive: bool = field(default=False, metadata=_cli(
        "comm_adaptive", "round-adaptive PlanFamily: re-run the "
        "delta_budget descent per participation count n against the "
        "effective budget B*M/n (DESIGN.md §10)"))

    def __post_init__(self):
        from repro_torch.core import compressors as C
        if self.compressor not in C.REGISTRY:
            raise StrategyError(
                f"compression.compressor: unknown compressor "
                f"{self.compressor!r}; have {sorted(C.REGISTRY)}")
        dt = getattr(torch, str(self.ef_dtype), None)
        if not isinstance(dt, torch.dtype):
            raise StrategyError(
                f"compression.ef_dtype: {self.ef_dtype!r} is not a dtype")
        if not dt.is_floating_point:
            raise StrategyError(
                f"compression.ef_dtype: residuals need a floating dtype, "
                f"got {self.ef_dtype!r}")
        if self.plan not in _plan_policies():
            raise StrategyError(
                f"compression.plan: unknown comm plan {self.plan!r}; "
                f"have {_plan_policies()}")
        if self.bucket_mb <= 0:
            raise StrategyError(
                f"compression.bucket_mb: must be > 0, got {self.bucket_mb}")
        if self.budget_mb < 0:
            raise StrategyError(
                f"compression.budget_mb: must be >= 0, got {self.budget_mb}")
        if self.plan == "delta_budget" and self.budget_mb <= 0:
            raise StrategyError(
                "compression.budget_mb: plan='delta_budget' needs a "
                "positive per-step byte budget (set budget_mb / "
                "--comm-budget-mb)")
        if self.plan != "delta_budget" and self.budget_mb > 0:
            raise StrategyError(
                f"compression.budget_mb: a byte budget only applies to "
                f"plan='delta_budget', not plan={self.plan!r}")
        if self.adaptive:
            if self.plan != "delta_budget":
                raise StrategyError(
                    f"compression.adaptive: a round-adaptive PlanFamily "
                    f"re-runs the delta_budget descent per participation "
                    f"count; it needs plan='delta_budget', not "
                    f"plan={self.plan!r}")
            from repro_torch.comm.planner import quant_ladder
            try:
                quant_ladder(self.compressor)
            except ValueError as e:
                raise StrategyError(
                    f"compression.compressor: {e}") from None

    # ------------------------------------------------------------------ #
    def get(self):
        """The base Compressor instance."""
        from repro_torch.core import compressors as C
        return C.get(self.compressor)

    @property
    def bucketing(self) -> bool:
        """True when the flat-bucket exchange path is active (Strategy
        construction refuses a plan with spmd='vmap', whose per-tensor
        semantics cannot bucket)."""
        return self.plan != "none"

    def build(self, shapes_tree, param_specs, n_workers: int,
              shard_axes: Tuple[str, ...] = (), axis_sizes=None):
        """(BucketLayout, CommPlan): the planner+compressor pipeline,
        statically derived from leaf shapes (DESIGN.md §3). With
        ``shard_axes`` the layout is shard-aware: leaves sharded only
        over those axes bucket at their local shard shape (DESIGN.md
        §15.1) instead of bypassing buckets."""
        from repro_torch import comm as RC
        layout = RC.build_layout(
            shapes_tree, param_specs, max(n_workers, 1),
            bucket_bytes=int(self.bucket_mb * (1 << 20)),
            shard_axes=shard_axes, axis_sizes=axis_sizes)
        plan = RC.plan_comm(
            layout, self.compressor, self.plan,
            budget_bytes=int(self.budget_mb * (1 << 20)))
        return layout, plan

    def build_family(self, shapes_tree, param_specs, n_workers: int):
        """(BucketLayout, PlanFamily): one delta_budget plan per
        participation count n ∈ {1..n_workers}, each cut against the
        effective budget B·M/n. Only valid when ``adaptive`` is set."""
        if not self.adaptive:
            raise ValueError("build_family needs compression.adaptive")
        from repro_torch import comm as RC
        layout = RC.build_layout(
            shapes_tree, param_specs, max(n_workers, 1),
            bucket_bytes=int(self.bucket_mb * (1 << 20)))
        fam = RC.plan_family(layout, self.compressor,
                             int(self.budget_mb * (1 << 20)),
                             max(n_workers, 1))
        return layout, fam

# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class ExchangePlan:
    """HOW the message moves: the collective strategy, the SPMD style
    implementing it, the mesh axes acting as the paper's M workers, and
    whether `delayed(τ)` lowers onto *overlapped* (split-phase)
    collectives — started before the round's field compute, finished at
    consumption (DESIGN.md §13)."""

    kind: str = field(default="sim", metadata=_cli(
        "exchange", "collective strategy", _exchange_kinds))
    spmd: str = field(default="shard_map", metadata=_cli(
        "spmd", "worker SPMD style (DESIGN.md §2)", lambda: SPMD_STYLES))
    worker_axes: Tuple[str, ...] = ("data",)
    overlap: bool = field(default=False, metadata=_cli(
        "overlap", "start delayed(τ) collectives before the round's "
                   "compute (split-phase lowering, DESIGN.md §13)"))
    parallelism: str = field(default="replicated", metadata=_cli(
        "parallelism", "parameter/optimizer-state layout: every worker "
                       "replicates (DDP) or shards ZeRO-style (fsdp, "
                       "DESIGN.md §15)", lambda: PARALLELISM_MODES))
    fsdp_axis: str = field(default="data", metadata=_cli(
        "fsdp_axis", "mesh axis that owns the parameter/moment shards "
                     "under parallelism='fsdp' (must be a worker axis)"))
    zero_stage: int = field(default=3, metadata=_cli(
        "zero_stage", "fsdp sharding stage: 2 shards moments (all-gather "
                      "moves the update), 3 also keeps the authoritative "
                      "params on the shard owner (all-gather moves the "
                      "updated params)"))

    def __post_init__(self):
        if self.kind not in _exchange_kinds():
            raise StrategyError(
                f"exchange.kind: unknown exchange {self.kind!r}; "
                f"have {_exchange_kinds()}")
        if self.spmd not in SPMD_STYLES:
            raise StrategyError(
                f"exchange.spmd: unknown SPMD style {self.spmd!r}; "
                f"have {SPMD_STYLES}")
        axes = self.worker_axes
        if isinstance(axes, list):
            axes = tuple(axes)
            object.__setattr__(self, "worker_axes", axes)
        if not isinstance(axes, tuple) or not all(
                isinstance(a, str) and a for a in axes):
            raise StrategyError(
                f"exchange.worker_axes: need a tuple of mesh-axis names, "
                f"got {self.worker_axes!r}")
        if not isinstance(self.overlap, bool):
            raise StrategyError(
                f"exchange.overlap: must be a bool, got {self.overlap!r}")
        if self.overlap and self.spmd == "vmap":
            raise StrategyError(
                "exchange.overlap: overlap=True needs real per-device "
                "collectives; spmd='vmap' simulates workers on one "
                "device and has nothing to overlap — use "
                "spmd='shard_map'")
        if self.overlap and self.kind == "exact":
            raise StrategyError(
                "exchange.overlap: overlap=True with exchange='exact' "
                "would hide an *uncompressed* pmean, defeating the "
                "measured-overlap comparison the flag exists for — use "
                "kind='sim'/'allgather'/'two_phase'")
        if self.parallelism not in PARALLELISM_MODES:
            raise StrategyError(
                f"exchange.parallelism: unknown mode "
                f"{self.parallelism!r}; have {PARALLELISM_MODES}")
        if not isinstance(self.zero_stage, int) or \
                self.zero_stage not in ZERO_STAGES:
            raise StrategyError(
                f"exchange.zero_stage: must be one of {ZERO_STAGES}, "
                f"got {self.zero_stage!r}")
        if not isinstance(self.fsdp_axis, str) or not self.fsdp_axis:
            raise StrategyError(
                f"exchange.fsdp_axis: need a mesh-axis name, got "
                f"{self.fsdp_axis!r}")
        if self.fsdp:
            if self.spmd == "vmap":
                raise StrategyError(
                    "exchange.parallelism: fsdp shards optimizer state "
                    "across devices; spmd='vmap' simulates every worker "
                    "on one device and has nothing to shard — use "
                    "spmd='shard_map'")
            if self.kind not in ("exact", "two_phase"):
                raise StrategyError(
                    f"exchange.kind: parallelism='fsdp' lowers the "
                    f"gradient exchange onto a (compressed) "
                    f"reduce-scatter, which only 'exact' and 'two_phase' "
                    f"define — got {self.kind!r}")
            if self.worker_axes and self.fsdp_axis not in self.worker_axes:
                raise StrategyError(
                    f"exchange.fsdp_axis: {self.fsdp_axis!r} is not one "
                    f"of the worker axes {self.worker_axes!r}; the shard "
                    f"owners are laid out along the worker axes")

    # ------------------------------------------------------------------ #
    def start(self, compressor, plan: dict, p, ef_state: dict, rand,
              workers, use_ef: bool, generator=None, spans: bool = False,
              shard=None, stream=None):
        """Start the exchange of one stacked (L, ...) tensor across
        `workers` (`core.exchange.StackedWorkers`, all W rows on one
        device, or `ProcessGroupWorkers`, a rank's L rows): issues the
        collectives and returns a `core.exchange.ExchangeHandle`, whose
        `finish` waits for them. `spans` marks each compression with a
        ``repro.obs/compress`` profiler range; `shard` (an
        `error_feedback.LeafShard`) marks a model-sharded tensor; `stream`
        (one seed a row) a leaf's tile streams."""
        from repro_torch.core import exchange as X
        return X.start_exchange(compressor, plan, p, ef_state, rand,
                                workers, use_ef, generator, spans, shard,
                                stream)

    def finish(self, handle):
        """(q̂, new_ef_state) from a handle returned by `start`."""
        from repro_torch.core import exchange as X
        return X.finish_exchange(handle)

    def leaf_plans(self, shapes_tree, specs_tree, n_workers: int):
        """Per-tensor collective plans (core.exchange.plan_leaf over the
        tree)."""
        from repro_torch.core import exchange as X
        return X.plan_for_tree(self.kind, shapes_tree, specs_tree,
                               n_workers)

    def bucket_plan(self, size: int, n_workers: int) -> dict:
        from repro_torch.core import exchange as X
        return X.plan_bucket(self.kind, size, max(n_workers, 1))

    # ---- fsdp surface (DESIGN.md §15) --------------------------------- #
    @property
    def fsdp(self) -> bool:
        """True when params/moments shard across the worker axes (the
        typed replacement for string-matching on ``parallelism``)."""
        return self.parallelism == "fsdp"

    def start_reduce_scatter(self, compressor, p, ef_state: dict, rand,
                             workers, use_ef: bool, generator=None,
                             spans: bool = False):
        """Start the (compressed) reduce-scatter of one stacked (L, d)
        flat bucket across `workers`; the handle finishes to each local
        worker's (d/W,) shard of the mean message and the new EF state
        (core.exchange.start_reduce_scatter, DESIGN.md §15.2)."""
        from repro_torch.core import exchange as X
        return X.start_reduce_scatter(compressor, self.kind, p, ef_state,
                                      rand, workers, use_ef, generator,
                                      spans)

    def start_all_gather_shard(self, compressor, shard, ag_ef, rand,
                               workers, use_ef: bool, generator=None,
                               spans: bool = False):
        """Start the (compressed) all-gather of the owners' (L, c) shards;
        the handle finishes to (the full flat bucket, the owners' new
        residual) (core.exchange.start_all_gather_shard)."""
        from repro_torch.core import exchange as X
        return X.start_all_gather_shard(compressor, shard, ag_ef, rand,
                                        workers, use_ef, generator, spans)

    @property
    def owner_ef(self) -> bool:
        """True when the strategy carries owner-side (e2) error feedback —
        i.e. the EF tree has a second, chunk-sharded residual. The typed
        replacement for string-matching on ``kind == 'two_phase'``."""
        from repro_torch.core import exchange as X
        return X.plan_has_owner_ef({"strategy": self.kind})

    def transport_factor(self, n_workers: int) -> float:
        """Ring-transport multiplier 2·(W−1)/W (core.exchange)."""
        from repro_torch.core import exchange as X
        return X.transport_factor(n_workers)

    def modeled_wire_bytes(self, compressor: str, n_elems: int,
                           n_workers: int) -> int:
        """Analytic per-worker bytes of one exchange of `n_elems` floats."""
        from repro_torch.core import compressors as C
        from repro_torch.core import exchange as X
        return X.modeled_wire_bytes(self.kind, C.get(compressor),
                                    (n_elems,), n_workers)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MomentCompression:
    """WHAT the fsdp all-gather moves: the compressor applied to the
    optimizer-state exchange — the update shard (zero-2) or the updated
    parameter shard (zero-3) each owner broadcasts after applying Adam on
    its shard. *Quantized Adam with Error Feedback* (arXiv 2004.14180)
    shows this leg tolerates the same δ-approximate compressor + error
    feedback stack as the gradient; the residual lives with the shard
    owner (one flat EF slot per bucket shard). Only consumed under
    ``exchange.parallelism='fsdp'`` — Strategy construction refuses a
    non-default moments slot on a replicated plan."""

    compressor: str = field(default="identity", metadata=_cli(
        "moment_compressor", "compressor for the fsdp optimizer-state / "
        "parameter all-gather (arXiv 2004.14180)", _compressor_names))
    error_feedback: bool = field(default=True, metadata=_cli(
        "moment_ef", "owner-side error feedback on the quantized "
        "all-gather shard"))

    def __post_init__(self):
        if self.compressor not in _compressor_names():
            raise StrategyError(
                f"moments.compressor: unknown compressor "
                f"{self.compressor!r}; have {_compressor_names()}")
        if not isinstance(self.error_feedback, bool):
            raise StrategyError(
                f"moments.error_feedback: must be a bool, got "
                f"{self.error_feedback!r}")

    @property
    def lossless(self) -> bool:
        return self.compressor == "identity"

    def get(self):
        """The core.compressors instance."""
        from repro_torch.core import compressors as C
        return C.get(self.compressor)


@functools.lru_cache(maxsize=32)
def _const(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    """A small constant tensor on `device`, made once: a host-to-device
    copy in every step would also wait for the device."""
    return torch.tensor(values, dtype=dtype, device=device)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Schedule:
    """WHEN workers talk: exchange cadence (k) × staleness (tau). Use the
    constructors — `Schedule.every_step()`, `Schedule.local_k(K)`,
    `Schedule.delayed(tau)` — rather than spelling kind/k/tau by hand."""

    kind: str = field(default="every_step", metadata=_cli(
        "schedule", "repro.sched exchange schedule", _schedule_kinds))
    k: int = field(default=1, metadata=_cli(
        "local_k", "local_k schedule: exchange every K steps"))
    tau: int = field(default=1, metadata=_cli(
        "staleness_tau", "delayed schedule: bounded-staleness pipeline "
                         "depth τ"))
    # heterogeneous per-worker staleness: worker m applies the message it
    # produced τ_m steps ago (ring depth stays max τ_m = tau). Empty =
    # homogeneous (every worker at τ). No CLI flag — like worker_axes,
    # the launcher/benchmarks set it programmatically (length must match
    # the worker count, validated at DQGAN init).
    tau_vector: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.kind not in _schedule_kinds():
            raise StrategyError(
                f"schedule.kind: unknown schedule {self.kind!r}; "
                f"have {_schedule_kinds()}")
        if self.k < 1:
            raise StrategyError(f"schedule.k: must be >= 1, got {self.k}")
        if self.kind != "local_k" and self.k != 1:
            raise StrategyError(
                f"schedule.k: k={self.k} only meaningful with "
                f"kind='local_k', not {self.kind!r}")
        if self.tau < 1:
            raise StrategyError(
                f"schedule.tau: must be >= 1, got {self.tau}")
        if self.kind != "delayed" and self.tau != 1:
            raise StrategyError(
                f"schedule.tau: tau={self.tau} only meaningful with "
                f"kind='delayed', not {self.kind!r}")
        tv = self.tau_vector
        if isinstance(tv, list):
            tv = tuple(tv)
            object.__setattr__(self, "tau_vector", tv)
        if tv:
            if self.kind != "delayed":
                raise StrategyError(
                    f"schedule.tau_vector: per-worker staleness only "
                    f"applies to kind='delayed', not {self.kind!r}")
            if not all(isinstance(t, int) and t >= 1 for t in tv):
                raise StrategyError(
                    f"schedule.tau_vector: entries must be ints >= 1, "
                    f"got {tv!r}")
            if max(tv) != self.tau:
                raise StrategyError(
                    f"schedule.tau_vector: the ring depth is max(τ_m) — "
                    f"tau={self.tau} must equal max(tau_vector)="
                    f"{max(tv)}")

    # ---- constructors ------------------------------------------------- #
    @classmethod
    def every_step(cls) -> "Schedule":
        """Seed semantics: one lockstep exchange per step."""
        return cls("every_step")

    @classmethod
    def local_k(cls, K: int) -> "Schedule":  # noqa: N802 (K is the paper's)
        """Exchange every K steps; the message accumulates in between."""
        return cls("local_k", k=K)

    @classmethod
    def delayed(cls, tau: int = 1,
                tau_vector: Tuple[int, ...] = ()) -> "Schedule":
        """Bounded-staleness exchange overlapping compute: step t applies
        the message produced at step t−τ (DESIGN.md §8). A non-empty
        ``tau_vector`` gives worker m its own τ_m ≤ τ pull cadence over
        the shared depth-τ ring (heterogeneous staleness)."""
        return cls("delayed", tau=tau, tau_vector=tuple(tau_vector))

    @classmethod
    def delayed_hetero(cls, tau_vector) -> "Schedule":
        """Heterogeneous bounded staleness from an explicit per-worker
        τ_m tuple; the ring depth is max(τ_m). For a seeded draw use
        `repro.sched.seeded_tau_vector`."""
        tv = tuple(int(t) for t in tau_vector)
        return cls("delayed", tau=max(tv), tau_vector=tv)

    @property
    def period(self) -> int:
        return self.k if self.kind == "local_k" else 1

    @property
    def staleness(self) -> int:
        return self.tau if self.kind == "delayed" else 0

    @property
    def overlappable(self) -> bool:
        """True when the wire message is already known at round start
        (pure carried state — the delayed(τ) pending ring), so
        `exchange.overlap` can issue the collectives before the field
        compute. every_step/local_k messages depend on the round's own
        gradients, so they stay start+immediate-finish."""
        return self.kind == "delayed"

    def runtime(self):
        """The repro_torch.sched.ExchangeSchedule engine for this point."""
        from repro_torch import sched as S
        return S.get(self.kind, self.k, self.tau)

    def describe(self) -> str:
        return self.runtime().describe()

    # ---- in-step dataflow of the stacked step (core.dqgan) ------------ #
    # Every per-worker tensor carries a leading worker axis: all W workers
    # on one device, or a rank's block of L of them (the JAX package's
    # shard_map gives each worker its own slice instead). Where the JAX
    # methods take a worker index these act on the L rows at once, worker
    # `offset + i` in row i: a τ-vector's pull slots and versions are
    # indexed by the global worker index.
    def init_slots(self, params, worker_like, ring_like, versions_like):
        """The DQState.sched buffers for this schedule, or None.

        `worker_like(leaf)` makes a per-worker (L, *shape) f32 slot,
        `ring_like(leaf)` a (L, τ, *shape) ring, `versions_like()` the
        (L,) int32 version vector — the caller owns shape and device."""
        if self.kind == "every_step":
            return None
        if self.kind == "local_k":
            return {"accum": T.tree_map(worker_like, params)}
        pending = T.tree_map(
            worker_like if self.tau == 1 else ring_like, params)
        return {"pending": pending, "versions": versions_like()}

    def _tau_of(self):
        """τ_m of every worker: an int when they share it (homogeneous,
        one worker, or a constant vector), else the tuple of the W."""
        tv = self.tau_vector
        if not tv:
            return self.tau
        if len(set(tv)) == 1:
            return tv[0]
        return tuple(tv)

    def _pull_pos(self):
        """Ring slot each worker exchanges: slot p holds the message
        produced (τ − p) steps ago, so worker m pulls p_m = τ − τ_m (an
        int, or a tuple over the workers). Messages keep shifting toward
        slot 0 after their exchange and fall off the end — each passes
        slot p_m exactly once."""
        tau_m = self._tau_of()
        if isinstance(tau_m, int):
            return self.tau - tau_m
        return tuple(self.tau - t for t in tau_m)

    def wire_head(self, sched_state, offset: int = 0):
        """(pending_buf, head): the raw delayed-schedule ring buffer and
        the (L, ...) message on the wire THIS step — each worker's oldest
        slot, or worker m's pull slot τ−τ_m under a tau_vector — or (None,
        None) for the other schedules."""
        if self.kind != "delayed":
            return None, None
        buf = sched_state["pending"]
        if self.tau == 1:
            return buf, buf
        p = self._pull_pos()
        if isinstance(p, int):
            return buf, T.tree_map(lambda r: r[:, p], buf)
        return buf, T.tree_map(
            lambda r: torch.stack([r[i, p[offset + i]]
                                   for i in range(r.shape[0])]),
            buf)

    def staleness_correction(self, pending_buf, message: str, lr: float,
                             offset: int = 0):
        """Each delayed worker's in-flight messages in update units — the
        staleness-correction proxy added to the OMD lookahead. For τ>1
        this sums the not-yet-applied slots: all of them (the τ-step
        recursion), or the τ_m slots from the worker's pull position on
        under a tau_vector."""
        if pending_buf is None:
            return None
        if self.tau > 1:
            p = self._pull_pos()
            if isinstance(p, int):
                tot = T.tree_map(lambda r: r[:, p:].sum(dim=1), pending_buf)
            else:
                # (W, τ) 0/1 weights: slot s counts for worker m if s ≥ p_m
                wts = tuple(tuple(float(s >= pw) for s in range(self.tau))
                            for pw in p)

                def masked(r):
                    w = _const(wts[offset:offset + r.shape[0]],
                               torch.float32, str(r.device))
                    w = w.reshape(w.shape + (1,) * (r.dim() - 2))
                    return (w * r.float()).sum(dim=1).to(r.dtype)
                tot = T.tree_map(masked, pending_buf)
        else:
            tot = pending_buf
        if message == "update":
            return tot
        return T.tree_map(lambda x: lr * x, tot)

    def shift(self, pending_buf, new_message):
        """Next pending buffer: overwrite the single slot (τ=1) or shift
        each worker's ring and append (τ>1)."""
        if self.tau == 1:
            return T.tree_map(lambda p, m: m.to(p.dtype), pending_buf,
                              new_message)
        return T.tree_map(
            lambda r, m: torch.cat([r[:, 1:], m[:, None].to(r.dtype)],
                                   dim=1),
            pending_buf, new_message)

    def advance_version(self, old_version, step: int, mask=None,
                        offset: int = 0):
        """(L,) push/pull versions after an exchange: a participating
        worker's applied message was produced τ (or τ_m) steps ago; a
        worker sitting the round out (mask 0) keeps its old version — its
        staleness keeps growing while the folded message rides the EF
        residual."""
        tau_m = self._tau_of()
        v_new = torch.full_like(old_version, step)
        v_new = v_new - (tau_m if isinstance(tau_m, int) else _const(
            tau_m[offset:offset + old_version.shape[0]], torch.int32,
            str(old_version.device)))
        if mask is None:
            return v_new
        return torch.where(mask > 0, v_new, old_version)

    def fold(self, sched_state, message, head, do_exchange: bool, step: int,
             mask, zeros: Callable, offset: int = 0):
        """One step of schedule dataflow: (exchange_message | None,
        new_sched_state | None). `message` is this step's fresh (L, ...)
        message tree, `head` the delayed ring head from `wire_head`,
        `mask` the round's (L,) participation rows or None, `zeros(tree)`
        the caller's zero-like."""
        if self.kind == "every_step":
            return message, None
        if self.kind == "local_k":
            if self.k == 1 and do_exchange:
                # length-1 rounds: the accumulator is identically zero at
                # every exchange; the message goes out unchanged
                # (bit-identical to every_step)
                return message, {"accum": zeros(sched_state["accum"])}
            accum = T.tree_map(lambda a, m: (a + m).to(a.dtype),
                               sched_state["accum"], message)
            if do_exchange:
                return accum, {"accum": zeros(accum)}
            return None, {"accum": accum}  # mid-round: nothing on the wire
        # delayed: exchange the step-(t−τ) message (ring head)
        return head, {
            "pending": self.shift(sched_state["pending"], message),
            "versions": self.advance_version(sched_state["versions"], step,
                                             mask, offset),
        }

    def staleness_now(self, step: int, new_sched, device=None):
        """(L,) per-worker staleness (step − version) after this step's
        exchange, or a scalar 0 on `device` for staleness-free
        schedules."""
        if self.kind != "delayed":
            return torch.zeros((), device=device)
        return (step - new_sched["versions"]).to(torch.float32)


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class Participation:
    """WHO talks each round: the sampled worker fraction, plus the
    heterogeneity profile consumed by the host-side wall-clock model
    (never by the training step)."""

    fraction: float = field(default=1.0, metadata=_cli(
        "participation", "fraction of workers sampled per exchange round"))
    straggler_profile: str = field(default="none", metadata=_cli(
        "straggler_profile", "heterogeneity profile for the wall-clock "
                             "model", _straggler_profiles))

    def __post_init__(self):
        if not 0.0 < self.fraction <= 1.0:
            raise StrategyError(
                f"participation.fraction: must be in (0, 1], got "
                f"{self.fraction}")
        if self.straggler_profile not in _straggler_profiles():
            raise StrategyError(
                f"participation.straggler_profile: unknown profile "
                f"{self.straggler_profile!r}; have {_straggler_profiles()}")

    # ------------------------------------------------------------------ #
    @property
    def partial(self) -> bool:
        return self.fraction < 1.0

    def profile(self):
        from repro_torch.sched import straggler as strag
        return strag.get_profile(self.straggler_profile)

    def round_setup(self, n_workers: int, generator=None, mask=None):
        """(mask (W,) float32, n_participants) for this round, or None for
        full participation or a single worker. The mask covers all W
        workers and is drawn from `generator` on its device — the shared
        stream, seeded alike on every rank, so every rank sees the same
        mask and selects the same PlanFamily row — or is the given
        (injected) `mask`. Each rank applies its own rows of it."""
        if not self.partial or n_workers <= 1:
            return None
        from repro_torch.sched import participation as SP
        n_part = SP.n_participants(self.fraction, n_workers)
        if n_part >= n_workers:
            return None
        if mask is None:
            mask = SP.round_mask(generator, n_workers, n_part)
        return mask, n_part

# --------------------------------------------------------------------------- #
METRIC_LEVELS = ("off", "wire", "full")


def _metric_levels():
    return METRIC_LEVELS


@dataclass(frozen=True)
class Observability:
    """WHAT we measure while training: the telemetry level
    consumed by `repro.obs` (DESIGN.md §11).

    Levels form a lattice: ``off`` ⊂ ``wire`` (empirical δ + EF residual
    norms, read off the already-materialized compressed messages) ⊂
    ``full`` (adds per-bucket gradient moments and the staleness
    histogram). ``off`` is contractually bit-identical to a build without
    the obs subsystem — enforced by HLO comparison in tests — which is
    why observability is excluded from `Strategy.short_hash()`: it can
    never change the trajectory, so it is not structural identity."""

    metrics: str = field(default="off", metadata=_cli(
        "obs_metrics", "on-device telemetry level (repro.obs)",
        _metric_levels))
    spans: bool = field(default=False, metadata=_cli(
        "obs_spans", "named phase spans: repro.obs/<phase> ranges for "
                     "torch.profiler, timed by the phase clock "
                     "(repro_torch.obs.tracing) in a profiled window"))
    # Host-side step profiler (repro.obs.profile, DESIGN.md §12.1):
    # block_until_ready-bracketed step walls over a --profile-steps
    # window, per-phase attribution keyed off the repro.obs/ span names.
    # Purely host-side, so it cannot perturb the compiled step — and like
    # metrics/spans it is excluded from short_hash() (structural identity
    # never includes observability).
    profile: bool = field(default=False, metadata=_cli(
        "obs_profile", "step profiler: emit `profile` events over the "
                       "--profile-steps window (repro.obs.profile)"))

    def __post_init__(self):
        if self.metrics not in METRIC_LEVELS:
            raise StrategyError(
                f"observability.metrics: unknown level "
                f"{self.metrics!r}; have {METRIC_LEVELS}")
        for name in ("spans", "profile"):
            if not isinstance(getattr(self, name), bool):
                raise StrategyError(
                    f"observability.{name}: expected a bool, got "
                    f"{getattr(self, name)!r}")

    # ------------------------------------------------------------------ #
    @property
    def on(self) -> bool:
        return self.metrics != "off"

    def spec(self):
        """The resolved `repro_torch.obs.MetricSpec` for this level."""
        from repro_torch.obs import METRIC_SPECS
        return METRIC_SPECS[self.metrics]
