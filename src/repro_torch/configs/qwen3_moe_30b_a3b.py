"""qwen3-moe-30b-a3b [moe]: 128 experts, top-8, expert d_ff=768.
48L d_model=2048 32H (GQA kv=4) vocab=151936. [hf:Qwen/Qwen3-30B-A3B]
(counterpart of `repro.configs.qwen3_moe_30b_a3b`, same numbers)"""
from .base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    arch_type="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151_936,
    activation="silu",
    norm="rmsnorm",
    use_rope=True,
    rope_theta=1_000_000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
    source="hf:Qwen/Qwen3-30B-A3B",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
