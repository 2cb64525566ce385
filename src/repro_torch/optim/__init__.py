"""Single-machine optimizers (counterpart of `repro.optim`). The
distributed optimizers (OMD / optimistic Adam / Adam / SGD with the
quantized exchange) live in `repro_torch.core.dqgan`; these are the small
(init, update) transforms of the tests, examples and GAN baselines, over
the port's nested-dict trees of tensors (`repro_torch.tree`).

The Adam moments are float32 whatever the parameters' dtype, as in the
reference; `t` is a 0-d int32 tensor.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch import tree as T


class Optimizer(NamedTuple):
    init: Callable    # params -> state
    update: Callable  # (grads, state, params) -> (new_params, new_state)


def _f32_zeros(params):
    return T.tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32),
                      params)


def _moments(grads, state, b1, b2):
    """(t, tf, m, v) after one more step: the count, as float32, and the
    two moments."""
    t = state["t"] + 1
    tf = t.to(torch.float32)
    m = T.tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
    v = T.tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g),
                   state["v"], grads)
    return t, tf, m, v


def _direction(m, v, tf, b1, b2, eps):
    return (m / (1 - b1 ** tf)) / (torch.sqrt(v / (1 - b2 ** tf)) + eps)


def sgd(lr: float) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params):
        new = T.tree_map(lambda w, g: w - lr * g.to(w.dtype), params, grads)
        return new, state

    return Optimizer(init, update)


def adam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    def init(params):
        z = _f32_zeros(params)
        dev = T.leaves(params)[0].device
        return {"m": z, "v": T.tree_map(torch.clone, z),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params):
        t, tf, m, v = _moments(grads, state, b1, b2)
        new = T.tree_map(
            lambda w, m_, v_: w - (lr * _direction(m_, v_, tf, b1, b2, eps)
                                   ).to(w.dtype),
            params, m, v)
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def oadam(lr, b1=0.9, b2=0.999, eps=1e-8) -> Optimizer:
    """Optimistic Adam (Daskalakis et al. 2018): w ← w − η(2 d_t − d_{t−1})."""
    base = adam(lr, b1, b2, eps)

    def init(params):
        st = base.init(params)
        st["prev"] = _f32_zeros(params)
        return st

    def update(grads, state, params):
        t, tf, m, v = _moments(grads, state, b1, b2)
        d = T.tree_map(lambda m_, v_: _direction(m_, v_, tf, b1, b2, eps),
                       m, v)
        new = T.tree_map(
            lambda w, d_, p: w - (lr * (2 * d_ - p)).to(w.dtype),
            params, d, state["prev"])
        return new, {"m": m, "v": v, "t": t, "prev": d}

    return Optimizer(init, update)


def cosine_lr(base_lr, warmup, total):
    """Linear warm-up over `warmup` steps, then a cosine decay to 0 at
    `total`: a function of the step (an int or a tensor) to a float32
    tensor."""
    def schedule(step):
        s = torch.as_tensor(step, dtype=torch.float32)
        warm = s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0, 1)
        cos = 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup, warm, cos)

    return schedule


REGISTRY = {"sgd": sgd, "adam": adam, "oadam": oadam}
