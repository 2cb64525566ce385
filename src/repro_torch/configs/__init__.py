"""Configs of the port (counterpart of `repro.configs`). Only the GAN
architecture is ported so far; the LM configs arrive with ROADMAP §A
slice 6."""
from __future__ import annotations

from importlib import import_module

from .base import DQConfig  # noqa: F401

_ARCH_MODULES = {
    "dcgan32": "dcgan32",
}


def get(name: str):
    try:
        mod = import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has "
                       f"{sorted(_ARCH_MODULES)}") from None
    return mod.CONFIG
