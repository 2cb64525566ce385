"""command-r-plus-104b [dense]: GQA, no biases.
64L d_model=12288 96H (GQA kv=8) d_ff=33792 vocab=256000.
[hf:CohereForAI/c4ai-command-r-v01]
(counterpart of `repro.configs.command_r_plus_104b`, same numbers)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    arch_type="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256_000,
    activation="silu",
    norm="layernorm",
    use_rope=True,
    use_bias=False,
    tie_embeddings=True,   # cohere ties input/output embeddings
    source="hf:CohereForAI/c4ai-command-r-v01",
    param_dtype="bfloat16",
    xent_chunk=512,
)
