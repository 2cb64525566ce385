"""Configs of the port (counterpart of `repro.configs`): the GAN of the
paper and, of the LM zoo, gemma-2b and gemma-2b-swa (the serving slice).
The other archs of the JAX package are refused with the ROADMAP slice
that brings them."""
from __future__ import annotations

from importlib import import_module

from .base import (  # noqa: F401
    DQConfig,
    EncDecConfig,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)

_ARCH_MODULES = {
    "gemma-2b": "gemma_2b",
    "gemma-2b-swa": "gemma_2b_swa",
    "dcgan32": "dcgan32",
}

# archs of the JAX package the port does not build yet -> what brings them
UNPORTED = {
    "recurrentgemma-2b": "ROADMAP §A slice 6 (LM zoo: the RG-LRU mixer)",
    "mamba2-1.3b": "ROADMAP §A slice 6 (LM zoo: the SSD mixer)",
    "qwen3-moe-30b-a3b": "ROADMAP §A slice 6 (LM zoo: MoE)",
    "arctic-480b": "ROADMAP §A slice 6 (LM zoo: MoE)",
    "whisper-tiny": "ROADMAP §A slice 6 (LM zoo: encoder-decoder)",
    "yi-34b": "ROADMAP §A slice 6 (LM zoo: the other dense archs)",
    "chameleon-34b": "ROADMAP §A slice 6 (LM zoo: the other dense archs)",
    "command-r-plus-104b": "ROADMAP §A slice 6 (LM zoo: the other dense "
                           "archs)",
    "starcoder2-7b": "ROADMAP §A slice 6 (LM zoo: the other dense archs)",
}


def get(name: str):
    if name in UNPORTED:
        raise KeyError(f"arch {name!r} is not ported yet; it arrives with "
                       f"{UNPORTED[name]}")
    try:
        mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_ARCH_MODULES)}") from None
    return mod.CONFIG
