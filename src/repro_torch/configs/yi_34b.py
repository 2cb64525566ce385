"""yi-34b [dense]: llama-architecture GQA.
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000. [arXiv:2403.04652]
(counterpart of `repro.configs.yi_34b`, same numbers)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64_000,
    activation="silu",
    norm="rmsnorm",
    use_rope=True,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
