"""Plain float32 references of the benchmark's configurations and of the
DQGAN worker step, in plain PyTorch. Nothing here imports the program
under test."""
from __future__ import annotations

import importlib


def model(name):
    """The reference module `bench.reference.<name>` (a configuration
    file's "reference")."""
    return importlib.import_module(f"{__name__}.{name}")
