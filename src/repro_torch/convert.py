"""Moving parameter trees between the JAX package and the port.

Both packages keep parameters as nested dicts in the same layout (conv
``w`` HWIO, linear ``w`` (d_in, d_out)) and flatten them in the same
sorted-key order, so crossing over is a copy, with no permutation:
`params_from_jax` takes a tree of numpy arrays (``jax.device_get`` of
JAX parameters) and returns torch tensors on `device`; `params_to_jax`
returns numpy arrays for ``jax.numpy.asarray``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T


def params_from_jax(tree_of_numpy, device="cpu"):
    return T.tree_map(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device),
        tree_of_numpy)


def params_to_jax(params):
    return T.tree_map(lambda t: t.detach().cpu().numpy(), params)
