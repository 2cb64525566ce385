"""recurrentgemma-2b [hybrid]: RG-LRU + local attention, 1:2
attention:recurrent pattern. 26L d_model=2560 10H (GQA kv=1, i.e. MQA)
d_ff=7680 vocab=256000. [arXiv:2402.19427 (Griffin / RecurrentGemma)]
(counterpart of `repro.configs.recurrentgemma_2b`, same numbers)"""
from .base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,  # the pattern below cycles (rglru, rglru, attn)
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256_000,
    layer_pattern=("rglru", "rglru", "attn"),
    activation="geglu",
    norm="rmsnorm",
    use_rope=True,
    attention_window=2048,
    rglru=RGLRUConfig(conv_width=4, expand=1),
    source="arXiv:2402.19427",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
