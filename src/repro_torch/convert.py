"""Moving parameter trees between the JAX package and the port.

Both packages keep parameters as nested dicts (and lists, for unscanned
LM layers) in the same layout (conv ``w`` HWIO, linear ``w`` (d_in,
d_out), LM layers stacked along a leading axis under ``"scan"``) and
flatten them in the same order, so crossing over is a copy, with no
permutation: `params_from_jax` takes a tree of numpy arrays
(``jax.device_get`` of JAX parameters or caches) and returns torch tensors
on `device`; `params_to_jax` returns numpy arrays for ``jax.numpy.asarray``.

bfloat16 crosses bit for bit: numpy holds it as the ``ml_dtypes`` type,
which torch cannot read, so its 16-bit patterns move as int16 and are
reinterpreted on the other side. `None` (an absent subtree) stays `None`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as T


def _from_numpy(a):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _to_numpy(t):
    if t is None:
        return None
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # the dtype is registered with numpy by ml_dtypes, which jax loads
        return t.view(torch.int16).numpy().view(np.dtype("bfloat16"))
    return t.numpy()


def params_from_jax(tree_of_numpy, device="cpu"):
    return T.tree_map(
        lambda a: None if a is None else _from_numpy(a).to(device),
        tree_of_numpy)


def params_to_jax(params):
    return T.tree_map(_to_numpy, params)
