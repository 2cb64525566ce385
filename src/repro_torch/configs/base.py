"""Configuration dataclasses (counterpart of `repro.configs.base`): the LM
`ModelConfig` with its sub-configs, and `DQConfig`, the DQGAN optimizer
knobs plus the flat strategy fields.

The sub-configs (`MoEConfig`, `SSMConfig`, `RGLRUConfig`, `EncDecConfig`)
are plain data with the JAX package's fields and defaults; the model code
of the port builds every one of them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block settings (qwen3-moe, arctic)."""
    num_experts: int
    top_k: int
    d_ff_expert: int
    dense_residual_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 1e-2
    router_z_coef: float = 1e-3
    dispatch: str = "global"         # "global" | "per_row"

    @property
    def has_dense_residual(self) -> bool:
        return self.dense_residual_d_ff > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings."""
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 256


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma / Griffin recurrent-block settings."""
    conv_width: int = 4
    expand: int = 1
    c_constant: float = 8.0


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder-decoder (whisper) settings; inputs are precomputed frame
    embeddings of shape (B, enc_seq, d_model)."""
    enc_layers: int = 4
    enc_seq: int = 1500


@dataclass(frozen=True)
class ModelConfig:
    """A decoder LM of the zoo, with the JAX package's fields, defaults,
    `param_count()` and `reduced()`."""
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    # layer pattern, cycled over the depth: 'attn' | 'rglru' | 'ssd'
    layer_pattern: Tuple[str, ...] = ("attn",)
    activation: str = "silu"            # silu | geglu | gelu (geglu/silu are gated)
    norm: str = "rmsnorm"               # rmsnorm | layernorm
    use_rope: bool = True
    rope_theta: float = 10_000.0
    attention_window: int = 0           # 0 -> global attention
    use_bias: bool = False
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    encdec: Optional[EncDecConfig] = None
    embedding_inputs: bool = False
    source: str = ""                    # citation for the assigned spec
    param_dtype: str = "float32"        # "bfloat16" at full width
    scan_layers: bool = True            # params["scan"]: a leading layer axis
    remat: str = "full"
    xent_chunk: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: num_heads {self.num_heads} is not "
                             f"a multiple of num_kv_heads "
                             f"{self.num_kv_heads}")

    @property
    def supports_long_context(self) -> bool:
        """True if decoding at 500k tokens is sub-quadratic or of bounded
        state: no global attention layer."""
        return (all(p != "attn" for p in self.layer_pattern)
                or self.attention_window > 0)

    @property
    def is_encdec(self) -> bool:
        return self.encdec is not None

    @property
    def positional(self) -> str:
        """rope | learned | none."""
        if self.use_rope:
            return "rope"
        if self.is_encdec:
            return "learned"
        return "none"

    def param_count(self) -> int:
        """Analytic parameter count (the JAX package's formula)."""
        d, v = self.d_model, self.vocab_size
        total = v * d
        if not self.tie_embeddings:
            total += v * d
        hd = self.head_dim
        per_layer = {"attn": (d * self.num_heads * hd
                              + 2 * d * self.num_kv_heads * hd
                              + self.num_heads * hd * d)}
        if self.rglru is not None:
            w = self.rglru.expand * d
            per_layer["rglru"] = (2 * d * w + w * d + 2 * w * w
                                  + w * self.rglru.conv_width)
        if self.ssm is not None:
            di = self.ssm.expand * d
            nheads = di // self.ssm.head_dim
            conv_ch = di + 2 * self.ssm.state_dim
            per_layer["ssd"] = (
                d * (2 * di + 2 * self.ssm.state_dim + nheads)
                + conv_ch * (self.ssm.conv_width + 1)
                + di * d + di
                + 3 * nheads)
        n_norm = 2 * d
        if self.moe is not None:
            ff = (3 * d * self.moe.d_ff_expert * self.moe.num_experts
                  + d * self.moe.num_experts)
            if self.moe.has_dense_residual:
                ff += 3 * d * self.moe.dense_residual_d_ff
        else:
            mult = 3 if self.activation in ("silu", "geglu") else 2
            ff = mult * d * self.d_ff
        for i in range(self.num_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            block_ff = ff if (kind != "ssd" or self.d_ff > 0) else 0
            total += per_layer[kind] + block_ff + n_norm
        total += d  # final norm
        if self.encdec is not None:
            enc = self.encdec.enc_layers * (per_layer["attn"] + ff + n_norm)
            cross = self.num_layers * (per_layer["attn"] + d)
            total += enc + cross
        return int(total)

    def active_param_count(self) -> int:
        """Parameters a token uses (MoE: only its top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        expert_p = 3 * self.d_model * self.moe.d_ff_expert
        inactive = ((self.moe.num_experts - self.moe.top_k) * expert_p
                    * self.num_layers)
        return int(self.param_count() - inactive)

    def reduced(self) -> "ModelConfig":
        """Small same-family variant for CPU tests: 2 layers, d_model <=
        256, <= 4 experts (the JAX package's cuts)."""
        d = min(self.d_model, 256)
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        while heads % kv:
            kv -= 1
        changes = dict(
            name=self.name + "-smoke",
            num_layers=(max(2, len(self.layer_pattern))
                        if len(self.layer_pattern) > 1 else 2),
            d_model=d,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=max(d // heads, 8),
            d_ff=min(self.d_ff, 4 * d) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            param_dtype="float32",
            xent_chunk=0,
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe, num_experts=4, top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 2 * d),
                dense_residual_d_ff=(2 * d if self.moe.has_dense_residual
                                     else 0),
                capacity_factor=8.0)
        if self.ssm is not None:
            changes["ssm"] = dataclasses.replace(
                self.ssm, state_dim=16, head_dim=16, chunk_size=32)
        if self.encdec is not None:
            changes["encdec"] = dataclasses.replace(
                self.encdec, enc_layers=2, enc_seq=64)
        if self.attention_window:
            changes["attention_window"] = min(self.attention_window, 32)
        return dataclasses.replace(self, **changes)


@dataclass(frozen=True)
class InputShape:
    """One input shape of the dry-run: `global_batch` sequences of
    `seq_len` tokens, a training step, a prefill or one decode step."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


TRAIN_4K = InputShape("train_4k", 4_096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32_768, 128, "decode")
LONG_500K = InputShape("long_500k", 524_288, 1, "decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


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
