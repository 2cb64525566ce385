"""gemma-2b-swa [dense, beyond-paper variant]: gemma-2b with a 4096-token
sliding attention window (a rolling KV cache of 4096 slots).
(counterpart of `repro.configs.gemma_2b_swa`, same numbers)"""
import dataclasses

from .gemma_2b import CONFIG as _BASE

CONFIG = dataclasses.replace(_BASE, name="gemma-2b-swa", attention_window=4096)
