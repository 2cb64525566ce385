"""Paged KV cache of the serving engine (counterpart of
`repro.serve.kv_cache`).

Attention K/V live in fixed-size blocks inside per-layer pools of shape
(num_blocks, block_size, kv_heads, head_dim); each batch slot owns a row
of a block table mapping logical block index -> pool block id. Memory
then scales with live tokens instead of max_seq x max_batch dense
buffers, and a finished request's blocks go straight back on the free
list for the next admission.

Block id 0 is a reserved scratch block: the engine parks the table rows
of inactive slots there, so the writes those slots still perform (the
decode step has a fixed shape: every slot computes every step) never land
in a block owned by a live request.

This module owns cache sizing: the sequential baseline and the engine
both size their context through ``plan_request`` / ``max_context``.
Prefill uses floor buckets (largest bucket <= prompt length; the prompt
tail feeds through decode steps), see ``floor_bucket``. The sizing and the
allocator are host-side Python, the JAX package's own, with its error
messages.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import torch

from repro_torch.models import model as lm

SCRATCH_BLOCK = 0   # never allocated; parked (inactive) slots write here


class ServeError(Exception):
    """Invalid serving configuration or request (sizing, admission)."""


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class ServeConfig:
    """Static serving shapes (frozen: any change is a new engine)."""

    max_batch: int = 8              # decode slots (fixed decode batch)
    block_size: int = 16            # tokens per KV block
    num_blocks: int = 256           # pool blocks per attention layer
    max_blocks_per_seq: int = 16    # block-table width (rows per slot)
    prompt_buckets: Tuple[int, ...] = (32, 64, 128)  # floor prefill shapes

    def __post_init__(self):
        if self.max_batch < 1:
            raise ServeError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.block_size < 1:
            raise ServeError(f"block_size must be >= 1, got {self.block_size}")
        if self.num_blocks < 2:
            raise ServeError(
                f"num_blocks must be >= 2 (block 0 is the reserved scratch "
                f"block), got {self.num_blocks}")
        if not self.prompt_buckets or \
                tuple(sorted(self.prompt_buckets)) != tuple(self.prompt_buckets):
            raise ServeError(
                f"prompt_buckets must be a non-empty ascending tuple, got "
                f"{self.prompt_buckets}")
        for b in self.prompt_buckets:
            if b % self.block_size:
                raise ServeError(
                    f"prompt bucket {b} is not a multiple of block_size="
                    f"{self.block_size} (prefill K/V scatter fills whole "
                    f"blocks)")
            if b > self.max_context:
                raise ServeError(
                    f"prompt bucket {b} exceeds max_context="
                    f"{self.max_context} (= block_size x max_blocks_per_seq)")

    @property
    def max_context(self) -> int:
        """Largest context (prompt + generated) a slot can hold."""
        return self.block_size * self.max_blocks_per_seq


# --------------------------------------------------------------------------- #
# sizing (the one place context arithmetic lives)
# --------------------------------------------------------------------------- #
def floor_bucket(prompt_len: int, cfg: ServeConfig) -> int:
    """Largest prefill bucket that fits *inside* the prompt (0 = skip
    prefill; the whole prompt feeds through decode steps). Floor instead
    of ceiling so prefill never sees a pad token — which is what keeps
    recurrent mixers (RG-LRU / SSD) exact: a right-padded prefill would
    bake the pad positions into their final state."""
    best = 0
    for b in cfg.prompt_buckets:
        if b <= prompt_len:
            best = b
    return best


def required_tokens(prompt_len: int, gen_steps: int, cfg: ServeConfig) -> int:
    """Context positions a request touches: prompt_len + gen_steps - 1
    (generated token 0 comes from the logits of the last prompt token, so
    it costs no extra KV position)."""
    del cfg
    if gen_steps < 1:
        raise ServeError(f"gen_steps must be >= 1, got {gen_steps}")
    if prompt_len < 1:
        raise ServeError(f"empty prompt (prompt_len={prompt_len})")
    return prompt_len + gen_steps - 1


def plan_request(prompt_len: int, gen_steps: int,
                 cfg: ServeConfig) -> Tuple[int, int]:
    """Check a (prompt_len, gen_steps) request fits the block budget;
    returns (prefill_bucket, total_blocks_needed). Raises ServeError with
    the violated limit spelled out instead of letting the decode step
    silently write past the table — this replaces the per-call
    ``S + gen_steps + 1`` arithmetic the old launcher re-derived (and got
    subtly wrong) on every ``generate()`` call."""
    tokens = required_tokens(prompt_len, gen_steps, cfg)
    if tokens > cfg.max_context:
        raise ServeError(
            f"request needs {tokens} context tokens (prompt={prompt_len}, "
            f"gen={gen_steps}) but the block table holds only "
            f"max_context={cfg.max_context} (= block_size={cfg.block_size} "
            f"x max_blocks_per_seq={cfg.max_blocks_per_seq}); raise "
            f"max_blocks_per_seq or lower the generation length")
    n_blocks = cdiv(tokens, cfg.block_size)
    if n_blocks > cfg.num_blocks - 1:
        raise ServeError(
            f"request needs {n_blocks} KV blocks but the pool only has "
            f"{cfg.num_blocks - 1} allocatable blocks; raise "
            f"ServeConfig.num_blocks")
    return floor_bucket(prompt_len, cfg), n_blocks


def dense_cache_len(cfg: ServeConfig) -> int:
    """Context length for the *dense* sequential baseline — identical to
    the paged engine's gathered length, so engine-vs-baseline decode runs
    the same-shape reductions (the bit-exact equivalence tests rely on
    this)."""
    return cfg.max_context


# --------------------------------------------------------------------------- #
# free-list block allocator (host side)
# --------------------------------------------------------------------------- #
class BlockAllocator:
    """LIFO free-list over block ids 1..num_blocks-1 (0 is scratch)."""

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ServeError(f"need >= 2 blocks, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._used = set()

    @property
    def capacity(self) -> int:
        return self.num_blocks - 1

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return len(self._used)

    def occupancy(self) -> float:
        return self.used_blocks / self.capacity

    def alloc(self, n: int) -> List[int]:
        if n > len(self._free):
            raise ServeError(
                f"out of KV blocks: requested {n}, {len(self._free)} free of "
                f"{self.capacity} (raise ServeConfig.num_blocks or admit "
                f"fewer concurrent requests)")
        out = [self._free.pop() for _ in range(n)]
        self._used.update(out)
        return out

    def free(self, ids) -> None:
        for b in ids:
            if b not in self._used:
                raise ServeError(f"double free of block {b}")
            self._used.remove(b)
            self._free.append(b)


# --------------------------------------------------------------------------- #
# paged cache construction
# --------------------------------------------------------------------------- #
def check_model_servable(cfg) -> None:
    """The paged engine serves decoder LMs with global attention and
    recurrent mixers. Fail fast with the reason otherwise (the JAX
    package's messages)."""
    if getattr(cfg, "is_encdec", False):
        raise ServeError(
            f"{cfg.name}: encoder-decoder models are not supported by the "
            f"paged serving engine (cross-attention caches are not paged)")
    kinds = set(lm.pattern_kinds(cfg))
    if "attn" in kinds and cfg.attention_window > 0:
        raise ServeError(
            f"{cfg.name}: sliding-window attention (attention_window="
            f"{cfg.attention_window}) is not supported by the paged KV "
            f"cache; the rolling dense cache already bounds its memory")


def _paged_attn_leaf(cfg, scfg: ServeConfig, dtype, device):
    pool = (scfg.num_blocks, scfg.block_size, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(pool, dtype=dtype, device=device),
        "v": torch.zeros(pool, dtype=dtype, device=device),
        "table": torch.full((scfg.max_batch, scfg.max_blocks_per_seq),
                            SCRATCH_BLOCK, dtype=torch.int32, device=device),
    }


def init_paged_cache(cfg, scfg: ServeConfig, dtype=None, device=None):
    """Cache tree with the structure of `model.init_cache`
    ({"scan": {...}, "tail": [...]}), but attention leaves are paged
    {"k": pool, "v": pool, "table": (max_batch, max_blocks_per_seq)} and
    recurrent leaves are (max_batch, ...) state lanes, one a slot,
    stacked along the layer axis under "scan"."""
    check_model_servable(cfg)
    dtype = dtype or lm._dtype(cfg)
    period, n_scan = lm._n_scan(cfg)

    def one(kind):
        if kind == "attn":
            return _paged_attn_leaf(cfg, scfg, dtype, device)
        return lm.block_cache_init(cfg, kind, scfg.max_batch, 0, dtype,
                                   device)

    caches = {"scan": None, "tail": []}
    if n_scan:
        caches["scan"] = {
            f"b{i}": lm._stack([one(cfg.layer_pattern[i])
                                for _ in range(n_scan)])
            for i in range(period)}
    for kind in lm.pattern_kinds(cfg)[n_scan * period:]:
        caches["tail"].append(one(kind))
    return caches


@dataclass
class CacheStats:
    """Occupancy snapshot for telemetry / bench rows."""
    used_blocks: int
    capacity: int
    live_tokens: int
    occupancy: float = field(init=False)

    def __post_init__(self):
        self.occupancy = self.used_blocks / max(self.capacity, 1)
