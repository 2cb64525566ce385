"""Model FLOPs of one training step, one formula a file:
`flops(model, batch, seq, n_params)` of a configuration's "model" object,
the step's batch and sequence length and the parameter count. A
configuration lists the formulas it takes under "flops"; the step's model
FLOPs are their sum."""
from __future__ import annotations

import importlib


def step_flops(cfg_file: dict, batch: int, seq: int, n_params: int) -> float:
    return sum(importlib.import_module(f"{__name__}.{name}").flops(
        cfg_file["model"], batch, seq, n_params)
        for name in cfg_file["flops"])
