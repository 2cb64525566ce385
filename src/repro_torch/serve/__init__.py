"""repro_torch.serve — the continuous-batching inference runtime
(counterpart of `repro.serve`): the paged KV cache (kv_cache), the
batching engine (engine), the sequential batch-1 oracle/baseline
(baseline) and strategy-driven load-time weight quantization
(quantized_weights)."""
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
from .quantized_weights import (
    WeightQuantMeta,
    dequantize_weights,
    quantize_weights,
)

__all__ = [
    "BlockAllocator", "CacheStats", "Engine", "Request", "SCRATCH_BLOCK",
    "SequentialGenerator", "ServeConfig", "ServeError", "WeightQuantMeta",
    "cdiv", "check_model_servable", "dense_cache_len", "dequantize_weights",
    "floor_bucket", "init_paged_cache", "plan_request", "quantize_weights",
    "required_tokens", "sample_token",
]
