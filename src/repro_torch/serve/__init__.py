"""repro_torch.serve — the continuous-batching inference runtime
(counterpart of `repro.serve`): the paged KV cache (kv_cache), the
batching engine (engine) and the sequential batch-1 oracle/baseline
(baseline). Load-time weight quantization arrives with ROADMAP §A
slice 7 (serving: quantized weights)."""
from .baseline import SequentialGenerator
from .engine import Engine, Request, sample_token
from .kv_cache import (
    BlockAllocator,
    CacheStats,
    SCRATCH_BLOCK,
    ServeConfig,
    ServeError,
    cdiv,
    check_model_servable,
    dense_cache_len,
    floor_bucket,
    init_paged_cache,
    plan_request,
    required_tokens,
)

__all__ = [
    "BlockAllocator", "CacheStats", "Engine", "Request", "SCRATCH_BLOCK",
    "SequentialGenerator", "ServeConfig", "ServeError", "cdiv",
    "check_model_servable", "dense_cache_len", "floor_bucket",
    "init_paged_cache", "plan_request", "required_tokens", "sample_token",
]
