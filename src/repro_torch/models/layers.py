"""Linear layers in the JAX package's layout (counterpart of the linear
helpers of `repro.models.layers`): ``w`` is (d_in, d_out), ``y = x @ w + b``.
"""
from __future__ import annotations

import math

import torch


def linear_init(d_in, d_out, use_bias=False, *, generator=None, device=None,
                dtype=torch.float32, scale=None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=generator, device=device,
                    dtype=torch.float32) * scale
    p = {"w": w.to(dtype)}
    if use_bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def linear(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y
