"""Fused error-feedback + stochastic int8 quantization (CUDA kernels).

Counterpart of `repro.kernels.quantize`: the Pallas TPU kernels
`_quantize_ef_kernel` (B1, `levels` a Python int) and
`_quantize_ef_kernel_dyn` (B2, `levels` a one-element float32 tensor on
the operands' device, read by the kernel itself so that a level count
chosen on the device never syncs with the host). Per row of C elements,
one scale block:

    m = g + e;  s = rowmax|m| + 1e-20
    q = floor(m/s*L) + (rand < frac);  e' = m - q*s/L

The kernel is `csrc/quantize_ef.cu` (the row held in registers, every
byte across device memory once; its note gives the bound): one warp a
row for B1 at 1024 columns, the comm buckets' width, so that one launch
can cover many buckets' rows; one block a row otherwise. Randomness
stays an operand, so the kernel and its plain version
(`kernels.ref.quantize_ef_ref`) agree given the same `rand`.

Dispatch is by device: a CPU tensor goes to the plain version, a CUDA
tensor to the kernel, which raises on anything it does not take. There
is no fallback from one to the other. `launches` counts B1's launches and
`launches_dyn` B2's (CPU calls do not count); `reset_launches()` zeroes
both.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import quantize_ef_ref

launches = 0       # B1: quantize_ef_f32
launches_dyn = 0   # B2: quantize_ef_dyn_f32
_fns = {}


def reset_launches() -> None:
    global launches, launches_dyn
    launches = launches_dyn = 0


def _kernel(dyn: bool):
    """The C entry point of B2 (dyn) or B1, loaded on first use."""
    fn = _fns.get(dyn)
    if fn is None:
        lib = _build.load("quantize_ef")
        fn = lib.quantize_ef_dyn_f32 if dyn else lib.quantize_ef_f32
        # 6 array pointers, rows, cols, levels (B1: float; B2: a pointer),
        # stream
        fn.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p if dyn else ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dyn] = fn
    return fn


def check_levels(levels, device):
    """`levels` is a Python int (B1) or a one-element float32 tensor on
    `device` (B2). Never reads a tensor's value: that would sync."""
    if isinstance(levels, int):
        return
    if not isinstance(levels, torch.Tensor):
        raise TypeError(f"quantize_ef: levels must be an int or a float32 "
                        f"tensor, got {type(levels).__name__}")
    if levels.dtype != torch.float32 or levels.numel() != 1:
        raise ValueError(f"quantize_ef: a tensor levels must be float32 with "
                         f"one element, got {levels.dtype} of shape "
                         f"{tuple(levels.shape)}")
    if levels.device != device:
        raise ValueError(f"quantize_ef: levels is on {levels.device}, the "
                         f"operands on {device}")


def _launch(g, e, rand, levels):
    global launches, launches_dyn
    for name, t in (("g", g), ("e", e), ("rand", rand)):
        if t.device != g.device or t.device.type != "cuda":
            raise ValueError(
                f"quantize_ef: {name} is on {t.device}, the kernel needs "
                f"every operand on the same CUDA device as g ({g.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"quantize_ef: {name} must be float32 on CUDA, "
                            f"got {t.dtype}")
        if t.shape != g.shape:
            raise ValueError(f"quantize_ef: {name} has shape "
                             f"{tuple(t.shape)}, g has {tuple(g.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"quantize_ef: {name} must be contiguous and "
                             f"16-byte aligned")
    dyn = isinstance(levels, torch.Tensor)
    R, C = g.shape
    codes = torch.empty((R, C), dtype=torch.int8, device=g.device)
    scale = torch.empty((R, 1), dtype=torch.float32, device=g.device)
    e_new = torch.empty_like(e)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = _kernel(dyn)(g.data_ptr(), e.data_ptr(), rand.data_ptr(),
                      codes.data_ptr(), scale.data_ptr(), e_new.data_ptr(),
                      R, C, levels.data_ptr() if dyn else float(levels),
                      stream)
    if rc != 0:
        raise RuntimeError(f"quantize_ef{'_dyn' if dyn else ''} kernel launch "
                           f"failed: CUDA error {rc} at shape ({R}, {C})")
    if dyn:
        launches_dyn += 1
    else:
        launches += 1
    return codes, scale, e_new


def quantize_ef_blocked(g, e, rand, *, levels=127, block_rows: int = 256):
    """g, e, rand: (R, C) with C % 128 == 0 and R % block_rows == 0 (the
    TPU tiling contract, kept so both packages accept the same shapes).
    `levels`: a Python int (B1) or a one-element float32 tensor on g's
    device (B2). Returns (codes int8 (R, C), scale f32 (R, 1), e_new (R,
    C) in e's dtype)."""
    check_levels(levels, g.device)
    R, C = g.shape
    if C % 128:
        raise ValueError(f"quantize_ef: lane-align C to 128, got {C}")
    br = min(block_rows, R)
    if br <= 0 or R % br:
        raise ValueError(f"quantize_ef: R={R} is not a multiple of "
                         f"block_rows={br}")
    if g.device.type == "cpu":
        codes, scale, e_new = quantize_ef_ref(g, e, rand, levels)
        return codes, scale, e_new.to(e.dtype)
    return _launch(g, e, rand, levels)


def bucket_tile_shape(n: int):
    """(R, C, block_rows) tiling for a flat comm bucket of n elements.
    Buckets are padded to a multiple of n_workers·1024, so C = 1024 always
    divides; block_rows is the largest divisor of R up to 256."""
    C = 1024 if n % 1024 == 0 else 128
    if n % C:
        raise ValueError(f"bucket size {n} not lane-aligned")
    R = n // C
    br = min(256, R)
    while R % br:
        br -= 1
    return R, C, br


def quantize_ef_flat(g, e, rand, *, levels=127):
    """Fused quantize+EF over a flat comm bucket (1-D, lane-aligned size),
    tiled as (R, 1024) rows, one scale each.
    Returns (codes (n,) int8, scales (R,) f32, e_new (n,))."""
    n = g.shape[0]
    R, C, br = bucket_tile_shape(n)
    codes, scale, e_new = quantize_ef_blocked(
        g.reshape(R, C), e.reshape(R, C), rand.reshape(R, C),
        levels=levels, block_rows=br)
    return codes.reshape(n), scale.reshape(R), e_new.reshape(n)
