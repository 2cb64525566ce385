"""starcoder2-7b [dense]: GQA + RoPE, layernorm + non-gated GELU MLP,
biases on. 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
[arXiv:2402.19173]
(counterpart of `repro.configs.starcoder2_7b`, same numbers)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    arch_type="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49_152,
    activation="gelu",
    norm="layernorm",
    use_rope=True,
    use_bias=True,
    source="arXiv:2402.19173",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
