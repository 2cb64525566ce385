"""Plain PyTorch versions of the port's kernels: the CPU path of each
wrapper, and the reference `chip_smoke.py` holds each kernel against.

Counterpart of `repro.kernels.ref`; the attention references arrive with
the kernels that need them (ROADMAP §B)."""
from __future__ import annotations

import torch


def quantize_ef_ref(g, e, rand, levels=127):
    """Fused error-feedback stochastic quantization, per-row scales.

    g, e, rand: (R, C) float32 (rand uniform in [0, 1)). `levels` is a
    Python int (the plain version of `_quantize_ef_kernel`) or a
    one-element float32 tensor on the operands' device (the plain version
    of `_quantize_ef_kernel_dyn`, whose level count is a device operand).
    Returns (codes int8, scale (R, 1) f32, e_new f32) with
        m      = g + e
        scale  = max(|m|, axis=1) + 1e-20
        codes  = floor(m / scale * levels) + (rand < frac)
        e_new  = m - codes * scale / levels
    """
    m = g.float() + e.float()
    scale = m.abs().amax(dim=1, keepdim=True) + 1e-20
    if isinstance(levels, torch.Tensor):
        lvl = levels.reshape(1, 1)
    else:
        # a device tensor as divisor: PyTorch's CUDA division by a Python
        # scalar multiplies by its reciprocal, which is not IEEE division
        lvl = scale.new_tensor(float(levels))
    lv = m / scale * lvl
    low = torch.floor(lv)
    codes = (low + (rand < (lv - low)).float()).to(torch.int8)
    deq = codes.float() * (scale / lvl)
    return codes, scale, m - deq
