"""Paged decode attention (CUDA kernel B3).

Counterpart of `repro.kernels.flash_attention.paged_flash_attention`,
whose Pallas TPU kernel `_paged_kernel` it replaces: one query token per
row, grouped GQA heads, over a paged KV pool, with an online softmax that
reads only the row's live blocks. The kernel is
`csrc/paged_attention.cu` (one block per (row, kv head); its note gives
the bound), instantiated for bfloat16 (the serving path) and float32.

Dispatch is by device: CPU tensors go to the plain version
(`kernels.ref.paged_attention_ref`), CUDA tensors to the kernel, which
raises on anything it does not take. There is no fallback from one to the
other. `launches` counts the kernel's launches (CPU calls do not count);
`reset_launches()` zeroes it.

The causal prefill kernel of the same JAX module (B4, `flash_attention`)
is on no model path of the JAX package; it arrives with ROADMAP §B.4.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import paged_attention_ref

launches = 0
_fns = {}
_CTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_G, MAX_GD = 8, 2048           # query heads per kv head; G·D per block
HEAD_DIMS = (16, 32, 64, 128, 256)  # the kernel's instantiations
MAX_SMEM = 232448                 # bytes of shared memory a block may use


def reset_launches() -> None:
    global launches
    launches = 0


def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        lib = _build.load("paged_attention")
        fn = getattr(lib, f"paged_attention_{_CTYPES[dtype]}")
        # q, pool_k, pool_v, table, lengths, out; B, K, G, D, bs, MAXB;
        # sm_scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check_shapes(q, pool_k, pool_v, table, lengths):
    if q.dim() != 4 or pool_k.dim() != 4:
        raise ValueError(f"paged_flash_attention: q must be (B, K, G, D) and "
                         f"the pools (NB, bs, K, D), got {tuple(q.shape)} and "
                         f"{tuple(pool_k.shape)}")
    B, Kh, G, D = q.shape
    if pool_v.shape != pool_k.shape:
        raise ValueError(f"paged_flash_attention: pool_v has shape "
                         f"{tuple(pool_v.shape)}, pool_k {tuple(pool_k.shape)}")
    if pool_k.shape[2:] != (Kh, D):
        raise ValueError(f"paged_flash_attention: pools hold (K, D) = "
                         f"{tuple(pool_k.shape[2:])}, q has {(Kh, D)}")
    if table.dim() != 2 or table.shape[0] != B:
        raise ValueError(f"paged_flash_attention: table must be (B={B}, "
                         f"MAXB), got {tuple(table.shape)}")
    if lengths.shape != (B,):
        raise ValueError(f"paged_flash_attention: lengths must be (B={B},), "
                         f"got {tuple(lengths.shape)}")


def _launch(q, pool_k, pool_v, table, lengths):
    global launches
    B, Kh, G, D = q.shape
    bs = pool_k.shape[1]
    for name, t in (("q", q), ("pool_k", pool_k), ("pool_v", pool_v),
                    ("table", table), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_flash_attention: {name} is on "
                             f"{t.device}, q on {q.device}; the kernel needs "
                             f"every operand on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"paged_flash_attention: {name} must be "
                             f"contiguous")
    if q.dtype not in _CTYPES:
        raise TypeError(f"paged_flash_attention: q must be float32 or "
                        f"bfloat16 on CUDA, got {q.dtype}")
    if pool_k.dtype != q.dtype or pool_v.dtype != q.dtype:
        raise TypeError(f"paged_flash_attention: the pools are "
                        f"{pool_k.dtype}/{pool_v.dtype}, q is {q.dtype}; the "
                        f"kernel takes one dtype")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_flash_attention: table and lengths must be "
                        f"int32, got {table.dtype} and {lengths.dtype}")
    if B < 1 or G > MAX_G or G * D > MAX_GD or D not in HEAD_DIMS:
        raise ValueError(f"paged_flash_attention: the kernel takes B >= 1, "
                         f"G <= {MAX_G}, D in {HEAD_DIMS} and G*D <= "
                         f"{MAX_GD}, got B={B}, G={G}, D={D}")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_flash_attention: the pools must be 16-byte "
                         "aligned (the kernel loads them 16 bytes at a time)")
    smem = (2 * q.element_size() * bs * D + 4 * (G * D + G * bs)
            + 12 * MAX_G)
    if smem > MAX_SMEM:
        raise ValueError(f"paged_flash_attention: a block of bs={bs} x D={D} "
                         f"needs {smem} B of shared memory, more than "
                         f"{MAX_SMEM}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel(q.dtype)(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                          table.data_ptr(), lengths.data_ptr(),
                          out.data_ptr(), B, Kh, G, D, bs, table.shape[1],
                          1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{rc} at q {tuple(q.shape)}, pool "
                           f"{tuple(pool_k.shape)}, table "
                           f"{tuple(table.shape)}")
    launches += 1
    return out


def paged_flash_attention(q, pool_k, pool_v, table, lengths):
    """Decode-step attention over a paged KV cache.

    q:        (B, K, G, D) — one query token per row, grouped GQA heads.
    pool_k/v: (NB, bs, K, D) block pools (shared across rows via the table).
    table:    (B, MAXB) int32 — row's logical block i is pool block
              table[row, i].
    lengths:  (B,) int32 — valid context per row (positions >= lengths[row]
              are masked; rows with length 0 return 0).
    Returns (B, K, G, D) in q's dtype.
    """
    _check_shapes(q, pool_k, pool_v, table, lengths)
    if q.device.type == "cpu":
        for t in (pool_k, pool_v, table, lengths):
            if t.device.type != "cpu":
                raise ValueError(f"paged_flash_attention: q is on the CPU, "
                                 f"an operand on {t.device}")
        return paged_attention_ref(q, pool_k, pool_v, table, lengths)
    return _launch(q, pool_k, pool_v, table, lengths)
