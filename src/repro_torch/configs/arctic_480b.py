"""arctic-480b [moe]: 128 experts top-2 + a dense FFN residually in
parallel (dense-MoE hybrid). 35L d_model=7168 56H (GQA kv=8) expert
d_ff=4864 vocab=32000. [hf:Snowflake/snowflake-arctic-base]
The dense-residual FFN width is not in the assignment line; we use
2*d_model=14336 and cite the model card's dense+MoE parallel structure.
(counterpart of `repro.configs.arctic_480b`, same numbers)"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    arch_type="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    activation="silu",
    norm="rmsnorm",
    use_rope=True,
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual_d_ff=14336,
    ),
    source="hf:Snowflake/snowflake-arctic-base",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
