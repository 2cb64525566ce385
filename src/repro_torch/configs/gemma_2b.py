"""gemma-2b [dense]: GeGLU, head_dim=256, MQA (kv=1).
18L d_model=2048 8H d_ff=16384 vocab=256000. [arXiv:2403.08295]
(counterpart of `repro.configs.gemma_2b`, same numbers)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    arch_type="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256_000,
    activation="geglu",
    norm="rmsnorm",
    use_rope=True,
    source="arXiv:2403.08295",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
