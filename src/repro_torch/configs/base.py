"""Run configuration: `DQConfig`, the DQGAN optimizer knobs plus the flat
strategy fields (counterpart of `repro.configs.base`; the LM `ModelConfig`s
arrive with the LM slice, ROADMAP §A slice 6)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class DQConfig:
    """DQGAN training settings (counterpart of `repro.configs.base.DQConfig`):
    the optimizer/field knobs plus the flat mirror of a
    `repro_torch.strategy.Strategy`.

    The distribution axes (compressor, exchange, schedule, participation,
    comm plan, ...) are owned by the typed `Strategy` API (DESIGN.md §9);
    the flat fields below mirror it for backward compatibility and are
    a legacy input surface — construct a `Strategy` and use
    ``DQConfig.from_strategy(strategy, optimizer=..., lr=...)``. Every
    DQConfig carries a validated `.strategy` (built at construction, so
    a bad combination raises `StrategyError` here).
    """
    compressor: str = "qsgd8_linf"   # key into core.compressors.REGISTRY
    exchange: str = "sim"            # exact | sim | allgather | two_phase
    error_feedback: bool = True      # False -> CPOAdam-GQ style baseline
    message: str = "update"          # "update" (eta*g + e, paper) | "grad"
    extrapolation: str = "local"     # "local" (paper) | "global" (FSDP-safe)
    optimizer: str = "omd"           # omd | oadam | adam | sgd
    lr: float = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    ef_dtype: str = "float32"        # bf16 halves EF memory at 100B scale
    # mesh axes acting as DQGAN "workers" (the paper's M machines).
    worker_axes: Tuple[str, ...] = ("data",)
    # per-top-level-group learning-rate multipliers, e.g. (("disc", 5.0),)
    # — the TTUR/n_critic analogue, applied after Adam preconditioning
    # (which would otherwise normalize a gradient-level boost away).
    lr_mults: Tuple[Tuple[str, float], ...] = ()
    # SPMD style: "shard_map" (manual worker collectives; int8 on the wire)
    # or "vmap" (workers as a vmapped leading axis, pure auto-sharding —
    # sidesteps an XLA partitioner CHECK with manual-pod + FSDP-auto inside;
    # paper semantics exact, wire format compiler-chosen). See DESIGN.md §2.
    spmd: str = "shard_map"
    # split-phase exchange: start delayed(τ) collectives before the
    # round's field compute so XLA can overlap wire time with compute
    # (DESIGN.md §13). Requires spmd="shard_map" and exchange != "exact".
    overlap: bool = False
    # ---- repro.comm: bucketing + layer-wise planning (DESIGN.md §3) ------ #
    # "none" keeps the seed per-tensor exchange; any planner policy
    # ("uniform" | "size_tiered" | "delta_budget") routes unsharded leaves
    # through flat, worker-divisible, lane-aligned buckets instead.
    comm_plan: str = "none"
    bucket_mb: float = 4.0           # f32 MiB per bucket before closing it
    comm_budget_mb: float = 0.0      # delta_budget: payload MiB/step target
    # round-adaptive PlanFamily: re-run the delta_budget descent per
    # participation count n against the effective budget B·M/n, selected
    # in-step by a branch-free gather on the round's participant count
    # (DESIGN.md §10).
    comm_adaptive: bool = False
    # ---- repro.sched: execution schedule (DESIGN.md §5, §8) -------------- #
    # "every_step" (seed semantics) | "local_k" (exchange every K steps,
    # message accumulates in DQState.sched["accum"]) | "delayed" (bounded-
    # staleness exchange overlapping compute; pending message(s) in
    # DQState.sched["pending"], staleness correction in the OMD lookahead).
    schedule: str = "every_step"
    local_k: int = 1                 # K for schedule="local_k"
    # pipeline depth τ for schedule="delayed": the message exchanged at
    # step t was produced at step t−τ. τ=1 keeps PR 2's single-slot
    # layout bit-exactly; τ>1 carries a (τ, ...) ring buffer plus the
    # per-worker version vector DQState.sched["versions"] (DESIGN.md §8).
    staleness_tau: int = 1
    # heterogeneous per-worker staleness for schedule="delayed": worker m
    # pulls the message it produced τ_m steps ago from the shared
    # depth-max(τ_m) ring (empty = homogeneous; length must match the
    # worker count).
    tau_vector: Tuple[int, ...] = ()
    # fraction of workers sampled per exchange round (count-exact); the
    # workers sitting out fold their message into the EF residual.
    participation: float = 1.0
    # straggler profile name (sched.straggler) — consumed only by the
    # host-side wall-clock model, never by the training step.
    straggler_profile: str = "none"
    # ---- parameter/optimizer-state layout (DESIGN.md §15) ---------------- #
    # "replicated" (every worker holds params + moments, DDP) or "fsdp"
    # (moments — and, at zero_stage=3, the authoritative params — shard
    # across the worker axes; gradient exchange lowers onto a compressed
    # reduce-scatter and the update returns via a compressed all-gather).
    parallelism: str = "replicated"
    fsdp_axis: str = "data"          # mesh axis owning the shards
    zero_stage: int = 3              # 2 = moments sharded, 3 = params too
    # compressor + owner-side EF for the fsdp all-gather leg (the
    # optimizer-state exchange of arXiv 2004.14180); "identity" keeps the
    # gather exact.
    moment_compressor: str = "identity"
    moment_ef: bool = True
    # repro.obs telemetry level ("off" | "wire" | "full") and phase-span
    # toggle — contractually trajectory-invariant (excluded
    # from Strategy.short_hash(); DESIGN.md §11).
    obs_metrics: str = "off"
    obs_spans: bool = False
    # host-side step profiler (repro.obs.profile, DESIGN.md §12.1) —
    # never read by the training step, so profiling off/on is bit-exact.
    obs_profile: bool = False

    # ------------------------------------------------------------------ #
    # the strategy shim (repro.strategy, DESIGN.md §9)
    # ------------------------------------------------------------------ #
    def __post_init__(self):
        from repro_torch.strategy import LEGACY_FIELDS, Strategy

        legacy = {k: getattr(self, k) for k in LEGACY_FIELDS}
        # a bad combination is a StrategyError (a ValueError) here
        object.__setattr__(self, "_strategy", Strategy.from_legacy(**legacy))

    @property
    def strategy(self):
        """The validated `repro.strategy.Strategy` this config denotes."""
        return self._strategy

    @classmethod
    def from_strategy(cls, strategy, **optim_fields) -> "DQConfig":
        """The blessed constructor: a typed `Strategy` for the
        distribution axes plus optimizer-side keywords (optimizer, lr,
        message, extrapolation, lr_mults, betas, eps)."""
        from repro_torch.strategy import LEGACY_FIELDS

        overlap = sorted(set(optim_fields) & set(LEGACY_FIELDS))
        if overlap:
            raise ValueError(
                f"from_strategy: {overlap} are strategy fields — set them "
                f"on the Strategy (e.g. strategy.evolve(...)), not as "
                f"keywords")
        return cls(**strategy.legacy_fields(), **optim_fields)
