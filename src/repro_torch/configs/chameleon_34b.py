"""chameleon-34b [vlm]: early-fusion mixed-modal; images arrive as discrete
VQ tokens in the shared vocab (the VQ-VAE image tokenizer is the stubbed
modality frontend — input_specs feeds token ids that may be image tokens).
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536. [arXiv:2405.09818]
(counterpart of `repro.configs.chameleon_34b`, same numbers)"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65_536,
    activation="silu",
    norm="rmsnorm",
    use_rope=True,
    source="arXiv:2405.09818",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
