"""The kernels' abstract forms on the meta device.

A wrapper given meta operands runs nothing: it calls its kernel's op in
the `repro_torch` operator namespace, which has a Meta implementation
only and returns empty meta tensors of the kernel's output shapes and
dtypes. So a traced step (`launch.op_analysis`, `launch.dryrun`) sees
each kernel as the card runs it: one op with its outputs, not the plain
version's many. The ops are defined on first use, never at import.
"""
from __future__ import annotations

from typing import Callable

import torch

_lib = None
_ops = {}


def op(name: str, schema: str, meta_fn: Callable):
    """`torch.ops.repro_torch.<name>`, defined with `schema` and `meta_fn`
    as its Meta implementation the first time it is asked for."""
    global _lib
    hit = _ops.get(name)
    if hit is None:
        if _lib is None:
            _lib = torch.library.Library("repro_torch", "FRAGMENT")
        _lib.define(f"{name}{schema}")
        _lib.impl(name, meta_fn, "Meta")
        hit = _ops[name] = getattr(torch.ops.repro_torch, name).default
    return hit


def check_meta(who: str, tensors) -> None:
    """Every one of `tensors` ((name, tensor) pairs) lies on the meta
    device."""
    for name, t in tensors:
        if t.device.type != "meta":
            raise ValueError(f"{who}: {name} is on {t.device}; a meta call "
                             f"takes every operand on the meta device")
