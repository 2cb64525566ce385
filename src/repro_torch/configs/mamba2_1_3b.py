"""mamba2-1.3b [ssm]: SSD (state-space duality), attention-free.
48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]
(counterpart of `repro.configs.mamba2_1_3b`, same numbers)"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    arch_type="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused by the ssd mixer
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,               # attention-free, no separate FFN (mamba block only)
    vocab_size=50_280,
    layer_pattern=("ssd",),
    norm="rmsnorm",
    use_rope=False,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_width=4,
                  chunk_size=256),
    source="arXiv:2405.21060",
    param_dtype="bfloat16",
    xent_chunk=1024,
)
