"""Configs of the port (counterpart of `repro.configs`): the GAN of the
paper and every arch of the LM zoo: the dense archs (gemma-2b,
gemma-2b-swa, starcoder2-7b, yi-34b, chameleon-34b, command-r-plus-104b),
the MoE archs (qwen3-moe-30b-a3b, arctic-480b), the SSD and RG-LRU
mixers (mamba2-1.3b, recurrentgemma-2b) and the encoder-decoder
(whisper-tiny)."""
from __future__ import annotations

from importlib import import_module

from .base import (  # noqa: F401
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    DQConfig,
    EncDecConfig,
    InputShape,
    ModelConfig,
    MoEConfig,
    RGLRUConfig,
    SSMConfig,
)

_ARCH_MODULES = {
    "gemma-2b": "gemma_2b",
    "gemma-2b-swa": "gemma_2b_swa",
    "yi-34b": "yi_34b",
    "chameleon-34b": "chameleon_34b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "arctic-480b": "arctic_480b",
    "starcoder2-7b": "starcoder2_7b",
    "mamba2-1.3b": "mamba2_1_3b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "whisper-tiny": "whisper_tiny",
    "dcgan32": "dcgan32",
}

# the assigned LM archs, in the JAX package's order (the dry-run sweeps
# these and gemma-2b-swa)
ASSIGNED = ("recurrentgemma-2b", "gemma-2b", "yi-34b", "mamba2-1.3b",
            "chameleon-34b", "command-r-plus-104b", "whisper-tiny",
            "qwen3-moe-30b-a3b", "arctic-480b", "starcoder2-7b")


def get(name: str):
    try:
        mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_ARCH_MODULES)}") from None
    return mod.CONFIG
