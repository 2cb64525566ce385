"""Models of the port (counterpart of `repro.models`): the GANs of the
paper's experiments (`gan`), the LM with attention, RG-LRU and SSD blocks,
dense and MoE FFNs and the encoder of encoder-decoder models (`model`,
`layers`, `mixers`, `moe`), and `build`, which binds a config to its
bundle (`registry`)."""
from .registry import ModelBundle, build, param_specs  # noqa: F401
