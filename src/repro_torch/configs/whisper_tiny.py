"""whisper-tiny [audio]: encoder-decoder; the mel-spectrogram + conv
frontend is a stub: the encoder takes precomputed frame embeddings of
shape (B, 1500, d_model). 4L d_model=384 6H d_ff=1536 vocab=51865.
[arXiv:2212.04356]
(counterpart of `repro.configs.whisper_tiny`, same numbers)"""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,                 # decoder layers
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    activation="gelu",
    norm="layernorm",
    use_rope=False,               # learned absolute positions
    use_bias=True,
    encdec=EncDecConfig(enc_layers=4, enc_seq=1500),
    embedding_inputs=True,        # the encoder takes precomputed embeddings
    tie_embeddings=True,
    source="arXiv:2212.04356",
    param_dtype="bfloat16",
    scan_layers=False,            # 4 decoder layers, a list under "tail"
)
