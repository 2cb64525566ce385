"""Named strategy presets (counterpart of `repro.strategy.presets`, the
same twelve strategies) — the registry behind ``--preset``.

Each preset is a full `Strategy` (constructed, hence validated, at import
time) covering one regime the repo's experiments exercise. Presets are
mesh-agnostic: `worker_axes` stays at the default ``("data",)`` and is
overridden by the launcher from the actual mesh.
"""
from __future__ import annotations

from typing import Dict

from .components import (
    Compression,
    ExchangePlan,
    MomentCompression,
    Participation,
    Schedule,
    StrategyError,
)
from .strategy import Strategy

PRESETS: Dict[str, Strategy] = {
    # The paper's Algorithm 2: 8-bit stochastic quantization + error
    # feedback, lockstep exchange every step.
    "paper_dqgan": Strategy(),
    # Full-precision exact averaging (the CPOAdam baseline's wire).
    "exact_baseline": Strategy(
        compression=Compression(compressor="identity",
                                error_feedback=False),
        exchange=ExchangePlan(kind="exact")),
    # Quantized-but-no-EF ablation (CPOAdam-GQ).
    "quantized_no_ef": Strategy(
        compression=Compression(error_feedback=False)),
    # Constrained uplink: two-phase int8 collectives over size-tiered
    # buckets, exchanging only every 4th step.
    "low_bandwidth": Strategy(
        compression=Compression(plan="size_tiered"),
        exchange=ExchangePlan(kind="two_phase"),
        schedule=Schedule.local_k(4)),
    # Hard byte budget: greedy per-bucket bit-width descent to 1 MiB/step.
    "byte_budget": Strategy(
        compression=Compression(plan="delta_budget", budget_mb=1.0),
        exchange=ExchangePlan(kind="two_phase")),
    # Round-adaptive byte budget (DESIGN.md §10): a PlanFamily re-runs
    # the descent per participation count, so when only half the workers
    # report each round their effective budget doubles and the reporting
    # workers quantize finer — same fleet-average bytes as byte_budget.
    "adaptive_budget": Strategy(
        compression=Compression(plan="delta_budget", budget_mb=1.0,
                                adaptive=True),
        exchange=ExchangePlan(kind="two_phase"),
        participation=Participation(fraction=0.5)),
    # One-step-stale exchange overlapping compute (PR 2's delayed),
    # lowered split-phase: the round's collective starts before the
    # field evaluation and finishes at the τ-stale consume (DESIGN.md
    # §13), so XLA's async scheduler can hide the wire time.
    "overlap": Strategy(
        exchange=ExchangePlan(overlap=True),
        schedule=Schedule.delayed(1)),
    # Bounded-staleness parameter server: τ=4 push/pull pipeline under a
    # mild straggler profile (DESIGN.md §8), split-phase overlapped.
    "ssp_server": Strategy(
        exchange=ExchangePlan(kind="two_phase", overlap=True),
        schedule=Schedule.delayed(4),
        participation=Participation(straggler_profile="mild")),
    # Half the workers report per round; the rest fold into EF.
    "partial_participation": Strategy(
        participation=Participation(fraction=0.5)),
    # 100B-scale FSDP layout: workers as a vmapped axis (DESIGN.md §2).
    "fsdp_vmap": Strategy(
        exchange=ExchangePlan(kind="sim", spmd="vmap",
                              worker_axes=("pod",))),
    # ZeRO-2: Adam moments shard across the workers; gradients ride a
    # compressed reduce-scatter, the *update* shard rides a quantized
    # all-gather with owner-side EF (arXiv 2004.14180; DESIGN.md §15).
    "fsdp_zero2": Strategy(
        compression=Compression(plan="uniform"),
        exchange=ExchangePlan(kind="two_phase", parallelism="fsdp",
                              zero_stage=2),
        moments=MomentCompression(compressor="qsgd8_linf")),
    # ZeRO-3: the shard owner also keeps the authoritative params; the
    # all-gather moves the *updated parameter* shard instead.
    "fsdp_zero3": Strategy(
        compression=Compression(plan="uniform"),
        exchange=ExchangePlan(kind="two_phase", parallelism="fsdp",
                              zero_stage=3),
        moments=MomentCompression(compressor="qsgd8_linf")),
}


# one-line docs, rendered by `python -m repro.strategy --list-presets`
PRESET_DOCS: Dict[str, str] = {
    "paper_dqgan": "the paper's Algorithm 2: qsgd8 + EF, lockstep",
    "exact_baseline": "full-precision exact averaging (CPOAdam wire)",
    "quantized_no_ef": "quantized but no error feedback (CPOAdam-GQ)",
    "low_bandwidth": "two_phase int8 over size-tiered buckets, local_k=4",
    "byte_budget": "static per-bucket bit-width descent to 1 MiB/step",
    "adaptive_budget": "round-adaptive PlanFamily: absent workers' byte "
                       "budget re-spent on finer bits (participation 0.5)",
    "overlap": "one-step-stale split-phase exchange overlapping compute",
    "ssp_server": "bounded-staleness τ=4 server under mild stragglers, "
                  "split-phase overlapped",
    "partial_participation": "half the workers report per round",
    "fsdp_vmap": "100B-scale FSDP layout, workers as a vmapped axis",
    "fsdp_zero2": "ZeRO-2: sharded moments, compressed reduce-scatter + "
                  "quantized update all-gather (2004.14180)",
    "fsdp_zero3": "ZeRO-3: sharded moments + params, quantized updated-"
                  "param all-gather with owner EF",
}


def get_preset(name: str) -> Strategy:
    try:
        return PRESETS[name]
    except KeyError:
        raise StrategyError(
            f"strategy: unknown preset {name!r}; have "
            f"{sorted(PRESETS)}") from None


def register_preset(name: str, strategy: Strategy, doc: str = "") -> None:
    """Add a preset (experiment configs may register their own)."""
    if not isinstance(strategy, Strategy):
        raise StrategyError(
            f"strategy: preset {name!r} must be a Strategy, got "
            f"{type(strategy).__name__}")
    PRESETS[name] = strategy
    if doc:
        PRESET_DOCS[name] = doc
