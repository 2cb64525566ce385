"""`Strategy` — the composed, validated, serializable distribution strategy
(counterpart of `repro.strategy.strategy`; `to_json()`/`short_hash()` are
byte-identical to the JAX package's for the same strategy).

One `Strategy` names a point in the full composition space of the paper's
method: (Compression × ExchangePlan × Schedule × Participation). The
components validate their own fields; this module validates the
*cross-field* lattice (every known-bad combination is a one-line
`StrategyError` at construction), serializes the whole object to
canonical JSON (`to_json`/`from_json`, exact round-trip — used by
checkpoints, `experiments/*.json` and the CI regression gate, which keys
baselines by `short_hash()`), and bridges the legacy flat `DQConfig`
flag-bag spellings (`from_legacy`/`legacy_fields`/`evolve`).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

from .components import (
    Compression,
    ExchangePlan,
    MomentCompression,
    Observability,
    Participation,
    Schedule,
    StrategyError,
)

_COMPONENTS: Tuple[Tuple[str, type], ...] = (
    ("compression", Compression),
    ("exchange", ExchangePlan),
    ("schedule", Schedule),
    ("participation", Participation),
    ("moments", MomentCompression),
    ("observability", Observability),
)

# Components that define the strategy's *structural identity* — what
# `short_hash()` digests. Observability is excluded: it is contractually
# trajectory-invariant (metrics="off" is bit-identical, and every level
# must be too — see the bit-exactness tests), so regression baselines
# and checkpoint resume guards keyed by the hash stay valid across
# telemetry settings.
_IDENTITY_COMPONENTS: Tuple[str, ...] = tuple(
    name for name, _ in _COMPONENTS if name != "observability")

# legacy DQConfig field -> (component attribute, component field)
LEGACY_FIELDS: Dict[str, Tuple[str, str]] = {
    "compressor": ("compression", "compressor"),
    "error_feedback": ("compression", "error_feedback"),
    "ef_dtype": ("compression", "ef_dtype"),
    "comm_plan": ("compression", "plan"),
    "bucket_mb": ("compression", "bucket_mb"),
    "comm_budget_mb": ("compression", "budget_mb"),
    "comm_adaptive": ("compression", "adaptive"),
    "exchange": ("exchange", "kind"),
    "spmd": ("exchange", "spmd"),
    "worker_axes": ("exchange", "worker_axes"),
    "overlap": ("exchange", "overlap"),
    "schedule": ("schedule", "kind"),
    "local_k": ("schedule", "k"),
    "staleness_tau": ("schedule", "tau"),
    "tau_vector": ("schedule", "tau_vector"),
    "participation": ("participation", "fraction"),
    "straggler_profile": ("participation", "straggler_profile"),
    "parallelism": ("exchange", "parallelism"),
    "fsdp_axis": ("exchange", "fsdp_axis"),
    "zero_stage": ("exchange", "zero_stage"),
    "moment_compressor": ("moments", "compressor"),
    "moment_ef": ("moments", "error_feedback"),
    "obs_metrics": ("observability", "metrics"),
    "obs_spans": ("observability", "spans"),
    "obs_profile": ("observability", "profile"),
}


@dataclass(frozen=True)
class Strategy:
    """The distribution strategy `DQGAN` consumes. Frozen and hashable
    ; the default is the paper's setting (qsgd8 + EF,
    sim exchange, lockstep every-step schedule, full participation)."""

    compression: Compression = Compression()
    exchange: ExchangePlan = ExchangePlan()
    schedule: Schedule = Schedule()
    participation: Participation = Participation()
    moments: MomentCompression = MomentCompression()
    observability: Observability = Observability()

    def __post_init__(self):
        for name, cls in _COMPONENTS:
            got = getattr(self, name)
            if not isinstance(got, cls):
                raise StrategyError(
                    f"{name}: expected a {cls.__name__}, got "
                    f"{type(got).__name__}")
        # ---- the cross-field lattice ---------------------------------- #
        if self.participation.partial and self.exchange.kind == "exact":
            raise StrategyError(
                "participation.fraction: partial participation needs a "
                "compressed exchange ('sim'/'allgather'/'two_phase') — "
                "with exchange.kind='exact' non-participants cannot ride "
                "through the collective as zero payloads")
        if self.exchange.spmd == "vmap":
            if self.compression.bucketing:
                raise StrategyError(
                    "compression.plan: bucketing needs "
                    "exchange.spmd='shard_map' — the vmap worker "
                    "formulation keeps per-tensor semantics (its wire "
                    "format is compiler-chosen), so a comm plan would be "
                    "silently ignored")
            if self.exchange.kind != "sim":
                raise StrategyError(
                    f"exchange.kind: spmd='vmap' implements the 'sim' "
                    f"(per-worker roundtrip + mean) semantics only; "
                    f"kind={self.exchange.kind!r} would be silently "
                    f"reinterpreted — spell it exchange.kind='sim'")
        if self.observability.on and not self.compression.error_feedback:
            raise StrategyError(
                "observability.metrics: empirical-δ telemetry reads the "
                "materialized EF residual (e_new = m − Q(m)); it needs "
                "compression.error_feedback=True")
        if self.exchange.fsdp:
            if self.participation.partial:
                raise StrategyError(
                    "participation.fraction: partial participation with "
                    "exchange.parallelism='fsdp' is undefined — a "
                    "participation mask composes with *replicated* "
                    "exchange only; masked reduce-scatter would average "
                    "with silently wrong denominators on every shard. "
                    "Use participation.fraction=1.0 with fsdp")
            if not self.compression.bucketing:
                raise StrategyError(
                    "compression.plan: exchange.parallelism='fsdp' shards "
                    "flat buckets (one lane-aligned chunk per worker); it "
                    "needs the bucketing pipeline — set a comm plan "
                    "(e.g. plan='uniform')")
            if self.compression.adaptive:
                raise StrategyError(
                    "compression.adaptive: round-adaptive plan selection "
                    "keys on the participant count, which fsdp pins to "
                    "the full worker set — the combination is untested; "
                    "use a static plan with parallelism='fsdp'")
        elif self.moments != MomentCompression():
            raise StrategyError(
                "moments.compressor: the optimizer-state compression "
                "slot is only consumed by exchange.parallelism='fsdp' "
                "(replicated DDP never puts moments on the wire) — a "
                "non-default moments component would be silently ignored")

    # ------------------------------------------------------------------ #
    # serialization: canonical, exact JSON round-trip
    # ------------------------------------------------------------------ #
    def to_dict(self) -> dict:
        return {name: dataclasses.asdict(getattr(self, name))
                for name, _ in _COMPONENTS}

    def to_json(self) -> str:
        """Canonical JSON: sorted keys, no whitespace — two equal
        strategies always serialize to the same bytes (the regression
        gate and checkpoint guard hash this string)."""
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_dict(cls, d: dict) -> "Strategy":
        if not isinstance(d, dict):
            raise StrategyError(f"strategy: expected an object, got "
                                f"{type(d).__name__}")
        known = {name for name, _ in _COMPONENTS}
        unknown = sorted(set(d) - known)
        if unknown:
            raise StrategyError(
                f"strategy: unknown component(s) {unknown}; have "
                f"{sorted(known)}")
        parts = {}
        for name, comp_cls in _COMPONENTS:
            sub = d.get(name, {})
            fields = {f.name for f in dataclasses.fields(comp_cls)}
            bad = sorted(set(sub) - fields)
            if bad:
                raise StrategyError(
                    f"{name}: unknown field(s) {bad}; have {sorted(fields)}")
            parts[name] = comp_cls(**sub)
        return cls(**parts)

    @classmethod
    def from_json(cls, s: str) -> "Strategy":
        try:
            d = json.loads(s)
        except json.JSONDecodeError as e:
            raise StrategyError(f"strategy: invalid JSON ({e})") from None
        return cls.from_dict(d)

    def identity_dict(self) -> dict:
        """The trajectory-defining subset of `to_dict()` — every
        component except observability, which is contractually
        bit-exact-invariant and therefore not structural identity."""
        return {name: dataclasses.asdict(getattr(self, name))
                for name in _IDENTITY_COMPONENTS}

    def short_hash(self) -> str:
        """12-hex digest of the canonical *identity* JSON — the
        structural identity the benchmark-regression gate keys baselines
        by and the checkpoint guard verifies. Telemetry settings
        (observability.*) do not shift it, so baselines recorded without
        obs stay valid for instrumented runs."""
        ident = json.dumps(self.identity_dict(), sort_keys=True,
                           separators=(",", ":"))
        return hashlib.sha256(ident.encode()).hexdigest()[:12]

    # ------------------------------------------------------------------ #
    def diff(self, other: "Strategy") -> List[str]:
        """Field-level differences, one dotted line each (both-ways)."""
        out = []
        for comp, _ in _COMPONENTS:
            a, b = getattr(self, comp), getattr(other, comp)
            for f in dataclasses.fields(a):
                va, vb = getattr(a, f.name), getattr(b, f.name)
                if va != vb:
                    out.append(f"{comp}.{f.name}: {va!r} != {vb!r}")
        return out

    def describe(self) -> str:
        c, e, s, p = (self.compression, self.exchange, self.schedule,
                      self.participation)
        bits = [f"{c.compressor}{'+ef' if c.error_feedback else ''}",
                e.kind, s.describe()]
        if c.bucketing:
            bits.append(f"plan={c.plan}"
                        + ("(adaptive)" if c.adaptive else ""))
        if p.partial:
            bits.append(f"part={p.fraction}")
        if p.straggler_profile != "none":
            bits.append(f"stragglers={p.straggler_profile}")
        if e.fsdp:
            bits.append(f"fsdp(zero{e.zero_stage}"
                        + ("" if self.moments.lossless
                           else f",moments={self.moments.compressor}")
                        + ")")
        if e.spmd != "shard_map":
            bits.append(e.spmd)
        if self.observability.on:
            bits.append(f"obs={self.observability.metrics}")
        return " ".join(bits)

    # ------------------------------------------------------------------ #
    # the legacy flat-field bridge
    # ------------------------------------------------------------------ #
    def evolve(self, **legacy_kw) -> "Strategy":
        """A copy with legacy flat-field spellings applied, e.g.
        ``strategy.evolve(schedule="delayed", staleness_tau=4)``. Sweep
        code and the `DQConfig` shim share this mapping."""
        unknown = sorted(set(legacy_kw) - set(LEGACY_FIELDS))
        if unknown:
            raise StrategyError(
                f"strategy: unknown legacy field(s) {unknown}; have "
                f"{sorted(LEGACY_FIELDS)}")
        by_comp: Dict[str, Dict[str, Any]] = {}
        for k, v in legacy_kw.items():
            comp, fld = LEGACY_FIELDS[k]
            by_comp.setdefault(comp, {})[fld] = v
        changes = {comp: dataclasses.replace(getattr(self, comp), **sub)
                   for comp, sub in by_comp.items()}
        return dataclasses.replace(self, **changes)

    @classmethod
    def from_legacy(cls, **legacy_kw) -> "Strategy":
        """Build from the flat DQConfig field spellings."""
        return cls().evolve(**legacy_kw)

    def legacy_fields(self) -> Dict[str, Any]:
        """The flat DQConfig mirror of this strategy."""
        return {k: getattr(getattr(self, comp), fld)
                for k, (comp, fld) in LEGACY_FIELDS.items()}

    # ------------------------------------------------------------------ #
    def modeled_wire_bytes(self, n_elems: int, n_workers: int) -> int:
        """Analytic per-worker bytes of one exchange of `n_elems` floats
        under this strategy (benchmarks' wire model). Under fsdp this is
        the split round: gradient reduce-scatter + moments/param
        all-gather, each leg under its own compressor."""
        if self.exchange.fsdp:
            from repro_torch.core import compressors as C
            from repro_torch.core import exchange as X
            return X.modeled_fsdp_wire_bytes(
                self.exchange.kind, C.get(self.compression.compressor),
                C.get(self.moments.compressor), (n_elems,), n_workers)
        return self.exchange.modeled_wire_bytes(
            self.compression.compressor, n_elems, n_workers)
