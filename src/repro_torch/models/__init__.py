"""Models of the port (counterpart of `repro.models`): the GANs of the
paper's experiments (`gan`), the decoder LM with dense and MoE blocks
(`model`, `layers`, `moe`), and `build`, which binds a config to its
bundle (`registry`); the RG-LRU and SSD mixers and the encoder arrive
with ROADMAP §A slice 6."""
from .registry import ModelBundle, build  # noqa: F401
