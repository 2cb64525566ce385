"""Attention kernels of the port: paged decode attention (CUDA kernel B3)
and causal flash attention (CUDA kernel B4).

`paged_flash_attention` is the counterpart of
`repro.kernels.flash_attention.paged_flash_attention`, whose Pallas TPU
kernel `_paged_kernel` it replaces: one query token per row, grouped GQA
heads, over a paged KV pool, with an online softmax that reads only the
row's live blocks. The kernel is `csrc/paged_attention.cu` (one block per
(row, kv head); its note gives the bound), instantiated for bfloat16 (the
serving path) and float32.

`flash_attention` is the counterpart of
`repro.kernels.flash_attention.flash_attention`, whose Pallas TPU kernel
`_flash_kernel` it replaces: causal (or full) softmax attention over
(BH, S, D) tensors with the online softmax. The kernel is
`csrc/flash_attention.cu`, in float32 and bfloat16. No model path of the
JAX package calls it (its prefill is `attention_dense`), and none of the
port does; `chip_smoke.py` holds it against its plain version and times
it, as the JAX package's kernel benchmark does.

Dispatch is by device: CPU tensors go to the plain versions
(`kernels.ref.paged_attention_ref`, `kernels.ref.flash_attention_ref`),
CUDA tensors to the kernels, which raise on anything they do not take.
There is no fallback from one to the other. `launches` counts B3's
launches and `flash_launches` B4's (CPU calls do not count);
`reset_launches()` zeroes both.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import flash_attention_ref, paged_attention_ref

launches = 0
flash_launches = 0
_fns = {}
_flash_fns = {}
_CTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_G, MAX_GD = 8, 2048           # query heads per kv head; G·D per block
HEAD_DIMS = (16, 32, 64, 128, 256)  # B3's and B4's instantiations
MAX_SMEM = 232448                 # bytes of shared memory a block may use


def reset_launches() -> None:
    global launches, flash_launches
    launches = 0
    flash_launches = 0


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


# --------------------------------------------------------------------------- #
# B4: causal flash attention
# --------------------------------------------------------------------------- #
def _flash_kernel(dtype):
    fn = _flash_fns.get(dtype)
    if fn is None:
        lib = _build.load("flash_attention")
        fn = getattr(lib, f"flash_attention_{_CTYPES[dtype]}")
        # q, k, v, out; BH, S, D, causal; sm_scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _flash_fns[dtype] = fn
    return fn


def _flash_launch(q, k, v, causal):
    global flash_launches
    BH, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {q.device}; the kernel needs every operand "
                             f"on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be 16-byte "
                             f"aligned (the kernel loads it 16 bytes at a "
                             f"time)")
    if q.dtype not in _CTYPES:
        raise TypeError(f"flash_attention: q must be float32 or bfloat16 on "
                        f"CUDA, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: k and v are {k.dtype}/{v.dtype}, "
                        f"q is {q.dtype}; the kernel takes one dtype")
    if D not in HEAD_DIMS or BH < 1 or S < 1:
        raise ValueError(f"flash_attention: the kernel takes D in "
                         f"{HEAD_DIMS}, BH >= 1 and S >= 1, got BH={BH}, "
                         f"S={S}, D={D}")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _flash_kernel(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), BH, S, D, int(causal),
                                1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)} {q.dtype}")
    flash_launches += 1
    return out


def flash_attention(q, k, v, *, causal=True, bq=128, bk=128):
    """q, k, v: (BH, S, D), batch*heads flattened, the same heads for k/v.
    Returns (BH, S, D) in q's dtype.

    `bq` and `bk` carry the JAX kernel's tiling contract (both must divide
    S); the CUDA kernel's own tiles do not depend on them, and they change
    nothing but float summation order."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 3:
            raise ValueError(f"flash_attention: {name} must be (BH, S, D), "
                             f"got shape {tuple(t.shape)}")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"flash_attention: q, k and v must have one shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    S = q.shape[1]
    for name, b in (("bq", bq), ("bk", bk)):
        if not isinstance(b, int) or b < 1 or S % b:
            raise ValueError(f"flash_attention: {name}={b!r} must be a "
                             f"positive int dividing S={S}")
    if q.device.type == "cpu":
        for name, t in (("k", k), ("v", v)):
            if t.device.type != "cpu":
                raise ValueError(f"flash_attention: q is on the CPU, {name} "
                                 f"on {t.device}")
        return flash_attention_ref(q[:, :, None], k[:, :, None],
                                   v[:, :, None], causal=causal)[:, :, 0]
    return _flash_launch(q, k, v, causal)
