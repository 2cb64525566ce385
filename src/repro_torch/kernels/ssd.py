"""Mamba2's chunked SSD, forward and backward: CUDA kernel set B5.

`ssd_chunked` computes what `kernels.ref.ssd_chunked_ref` computes (the
chunked SSD of `models.mixers`, the JAX package's `_ssd_chunked`, which
XLA runs: no Pallas kernel is replaced). The kernels are
`csrc/ssd_chunked.cu`, float32 FFMA on CUDA cores with bfloat16 or float32
activations (x, B, C) widened on load; no (L, L) block of a head reaches
device memory. The forward is four launches (`cumsum`, `state`, `pass`,
`scan`); the backward, a `torch.autograd.Function`, seven (`state` again,
`pass_bwd`, `bwd_bc`, `bwd_dx`, `bwd_dg`, `bwd_gbc`, `bwd_dt`). The backward
uses no atomics: where several CTAs add to one value each writes its part to a
workspace slot of its own and a later kernel sums the slots in a fixed order,
so one input gives the same bits on every run. The source builds into one
library (`_build`'s `ssd_chunked`) on first use. The forward keeps
for the backward x, B, C, dt, A, the running log-decay `cum` (B, T, H),
the chunk decays (B, nc, H) and the states entering each chunk (B, nc, H,
P, N) float32. The skip D·x is added here, in x's dtype, as the plain
version adds it.

The kernels take P and N in (16, 32, 64, 128), a chunk of 1 to 256
positions (T a multiple of it, as the plain version asks), any number of
heads and rows, x, B and C in one dtype (float32 or bfloat16, the last
dimension contiguous, 16-byte aligned with batch and token strides of
whole 16 bytes), dt and A float32. `kernel_check` raises on anything else,
on any device. `ssd_chunked` hands the kernels the views of the mixer's
conv output as they are (at every shape of the main path they meet the
layout rule) and a contiguous copy of an operand that does not (a model
rank whose conv output rows are not whole 16 bytes, or a strided view).

Dispatch is by device: CPU tensors go to the plain version, CUDA tensors
to the kernels, which raise on what they do not take; there is no
fallback. Meta tensors take the kernels' path to its abstract form: the
same checks and the same allocations (outputs, saved tensors, the
backward's scratch) with no launch, so a traced step (`launch.dryrun`,
`launch.op_analysis`) holds the memory the card holds, and none of the
plain version's (L, L) blocks. `ssd_launches` counts forward calls on
CUDA tensors (four kernels each) and `ssd_bwd_launches` backward calls
(seven kernels each); `ssd_meta_launches` and `ssd_bwd_meta_launches`
the meta calls; a CPU call counts nothing. `reset_launches()` zeroes all
four.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .ref import ssd_chunked_ref

ssd_launches = 0
ssd_bwd_launches = 0
ssd_meta_launches = 0        # the abstract form's calls (nothing runs)
ssd_bwd_meta_launches = 0
WIDTHS = (16, 32, 64, 128)   # P and N the kernels are built for
MAX_CHUNK = 256
GRID_MAX = 65535
_fns = {}


def reset_launches() -> None:
    global ssd_launches, ssd_bwd_launches, ssd_meta_launches
    global ssd_bwd_meta_launches
    ssd_launches = ssd_bwd_launches = 0
    ssd_meta_launches = ssd_bwd_meta_launches = 0


def _fn(pass_, dtype):
    """The C entry point of a pass ("fwd" or "bwd") for activations of
    `dtype`, from the one library of `csrc/ssd_chunked.cu`."""
    key = (pass_, dtype)
    fn = _fns.get(key)
    if fn is None:
        lib = _build.load("ssd_chunked")
        fn = getattr(lib, f"ssd_chunked_{pass_}_"
                          f"{'bf16' if dtype == torch.bfloat16 else 'f32'}")
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        seq = [ptr, i64, i64] * 3          # x, B, C with their strides
        if pass_ == "fwd":
            # x, B, C; dt, A, cum, cd, hs, hfin, y; B, T, H, P, N, L; stream
            fn.argtypes = seq + [ptr] * 7 + [i32] * 6 + [ptr]
        else:
            # x, B, C; dt, A, cum, cd, hs, dy, dhf, dx, dS, ws; its floats;
            # dB, dC, ddt, dAp; B, T, H, P, N, L; stream
            fn.argtypes = seq + [ptr] * 10 + [i64] + [ptr] * 4 + [i32] * 6 \
                + [ptr]
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def ws_floats(B_, T, H, P, N, L) -> int:
    """Floats of the backward's scratch, laid out as the source's `Work`
    lays it (the backward refuses fewer): dcum and dlast, the slots of dcum
    and of ddt (one a 64-row tile of the chunk), the d(cd) parts (one a
    256-thread CTA over P·N) and the dG tiles (64 x 64, one a tile on or
    below the diagonal, a (row, chunk) and a group of 16 heads), each part
    a multiple of 4."""
    def up4(n):
        return -(-n // 4) * 4
    nlt, nc = -(-L // 64), T // L
    bth = up4(B_ * T * H)
    parts = up4(B_ * nc * H * -(-(P * N) // 256))
    tiles = B_ * nc * nlt * (nlt + 1) // 2 * -(-H // 16) * 64 * 64
    return 2 * bth + 2 * nlt * bth + parts + tiles


def kernel_check(x, Bm, Cm, dt, A, P, L) -> None:
    """Raises on operands the kernels do not take (see the module's
    docstring); shapes the plain version would refuse too are checked by
    `ssd_chunked` itself."""
    B_, T, di = x.shape
    H, N = di // P, Bm.shape[-1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"ssd_chunked: x must be float32 or bfloat16 on "
                        f"CUDA, got {x.dtype}")
    if Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_chunked: B and C are {Bm.dtype}/{Cm.dtype}, x "
                        f"is {x.dtype}; the kernels take one dtype")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_chunked: dt and A must be float32, got "
                        f"{dt.dtype} and {A.dtype}")
    if P not in WIDTHS or N not in WIDTHS:
        raise ValueError(f"ssd_chunked: the kernels take P and N in "
                         f"{WIDTHS}, got P={P}, N={N}")
    if not 1 <= L <= MAX_CHUNK:
        raise ValueError(f"ssd_chunked: the kernels take a chunk of 1 to "
                         f"{MAX_CHUNK} positions, got {L}")
    if B_ * (T // L) > GRID_MAX or H > GRID_MAX:
        raise ValueError(f"ssd_chunked: the kernels take at most {GRID_MAX} "
                         f"(row, chunk) pairs and heads, got "
                         f"{B_ * (T // L)} and {H}")
    for name, t in (("x", x), ("B", Bm), ("C", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_chunked: {name}'s last dimension must be "
                             f"contiguous")
        if not _loads_whole(t):
            raise ValueError(f"ssd_chunked: {name} must start 16-byte aligned "
                             f"with its rows 16 bytes apart (the kernels "
                             f"load 16 bytes at a time), got strides "
                             f"{t.stride()[:2]}")
    for name, t in (("B", Bm), ("C", Cm), ("dt", dt), ("A", A)):
        if t.device != x.device:
            raise ValueError(f"ssd_chunked: {name} is on {t.device}, x on "
                             f"{x.device}; the kernels need every operand "
                             f"on one device")


def _loads_whole(t) -> bool:
    """t starts 16-byte aligned and its batch and token strides are whole
    16 bytes: the kernels load its rows 16 bytes at a time."""
    per16 = 16 // t.element_size()
    return not (t.data_ptr() % 16 or t.stride(0) % per16
                or t.stride(1) % per16)


def _seq(t):
    return [t.data_ptr(), t.stride(0), t.stride(1)]


def _launch_fwd(x, Bm, Cm, dt, A, P, L, stream):
    """The forward launches: (y without the skip, final state, cum, chunk
    decays, states entering each chunk). dt and A contiguous. On meta
    tensors the outputs alone (the abstract form)."""
    B_, T, di = x.shape
    H, N, nc = di // P, Bm.shape[-1], T // L
    f32 = dict(dtype=torch.float32, device=x.device)
    cum = torch.empty((B_, T, H), **f32)
    cd = torch.empty((B_, nc, H), **f32)
    hs = torch.empty((B_, nc, H, P, N), **f32)
    hfin = torch.empty((B_, H, P, N), **f32)
    y = torch.empty((B_, T, di), dtype=x.dtype, device=x.device)
    if x.is_meta:
        return y, hfin, cum, cd, hs
    rc = _fn("fwd", x.dtype)(
        *_seq(x), *_seq(Bm), *_seq(Cm),
        dt.data_ptr(), A.data_ptr(), cum.data_ptr(), cd.data_ptr(),
        hs.data_ptr(), hfin.data_ptr(), y.data_ptr(), B_, T, H, P, N, L,
        stream)
    if rc != 0:
        raise RuntimeError(f"ssd_chunked forward launch failed: CUDA error "
                           f"{rc} at x {tuple(x.shape)} {x.dtype}, P={P}, "
                           f"N={N}, L={L}")
    return y, hfin, cum, cd, hs


def _launch_bwd(x, Bm, Cm, dt, A, cum, cd, hs, dy, dhf, P, L, stream):
    """The backward launches: (dx, dB, dC, ddt, dA). On meta tensors the
    scratch and the outputs alone (the abstract form)."""
    B_, T, di = x.shape
    H, N, nc = di // P, Bm.shape[-1], T // L
    f32 = dict(dtype=torch.float32, device=x.device)
    ws = torch.empty(ws_floats(B_, T, H, P, N, L), **f32)
    dS = torch.empty_like(hs)
    dB = torch.empty((B_, T, N), **f32)
    dC = torch.empty((B_, T, N), **f32)
    ddt = torch.empty((B_, T, H), **f32)
    dAp = torch.empty((B_ * nc, H), **f32)
    dx = torch.empty((B_, T, di), dtype=x.dtype, device=x.device)
    if not x.is_meta:
        rc = _fn("bwd", x.dtype)(
            *_seq(x), *_seq(Bm), *_seq(Cm),
            dt.data_ptr(), A.data_ptr(), cum.data_ptr(), cd.data_ptr(),
            hs.data_ptr(), dy.data_ptr(),
            None if dhf is None else dhf.data_ptr(), dx.data_ptr(),
            dS.data_ptr(), ws.data_ptr(), ws.numel(), dB.data_ptr(),
            dC.data_ptr(), ddt.data_ptr(), dAp.data_ptr(), B_, T, H, P, N, L,
            stream)
    else:
        rc = 0
    if rc != 0:
        raise RuntimeError(f"ssd_chunked backward launch failed: CUDA error "
                           f"{rc} at x {tuple(x.shape)} {x.dtype}, P={P}, "
                           f"N={N}, L={L}")
    # dA: the (batch, chunk) parts summed by one reduction, in a fixed order
    return dx, dB.to(Bm.dtype), dC.to(Cm.dtype), ddt, dAp.sum(0)


def _stream(x):
    return None if x.is_meta else torch.cuda.current_stream(
        x.device).cuda_stream


class _SSDChunked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A, P, L):
        global ssd_launches, ssd_meta_launches
        ctx.set_materialize_grads(False)
        y, hfin, cum, cd, hs = _launch_fwd(x, Bm, Cm, dt, A, P, L,
                                           _stream(x))
        ctx.save_for_backward(x, Bm, Cm, dt, A, cum, cd, hs)
        ctx.P, ctx.L = P, L
        if x.is_meta:
            ssd_meta_launches += 1
        else:
            ssd_launches += 1
        return y, hfin

    @staticmethod
    def backward(ctx, dy, dhf):
        global ssd_bwd_launches, ssd_bwd_meta_launches
        x, Bm, Cm, dt, A, cum, cd, hs = ctx.saved_tensors
        dy = (torch.zeros_like(x, memory_format=torch.contiguous_format)
              if dy is None else dy.to(x.dtype).contiguous())
        if dy.data_ptr() % 16:   # a view into its storage: the kernels load
            dy = dy.clone()      # 16 bytes at a time
        if dhf is not None:
            dhf = dhf.float().contiguous()
        grads = _launch_bwd(x, Bm, Cm, dt, A, cum, cd, hs, dy, dhf, ctx.P,
                            ctx.L, _stream(x))
        if x.is_meta:
            ssd_bwd_meta_launches += 1
        else:
            ssd_bwd_launches += 1
        return (*grads, None, None)


def ssd_chunked(x, Bm, Cm, dt, A, D, P, chunk_size):
    """The chunked SSD over a full sequence: x (B, T, H·P) (its dtype is
    the output's), Bm and Cm (B, T, N), dt (B, T, H) float32, A and D
    (H,). Returns y (B, T, H·P) with the skip D·x, before the gated norm,
    and the final state (B, H, P, N) float32."""
    if x.device.type == "cpu":
        return ssd_chunked_ref(x, Bm, Cm, dt, A, D, P, chunk_size)
    B_, T, di = x.shape
    L = min(chunk_size, T)
    if T % L:
        raise ValueError(f"ssd_apply: T={T} is not a multiple of the chunk "
                         f"size {L}")
    x, Bm, Cm = (t if t.stride(-1) == 1 and _loads_whole(t)
                 else t.clone(memory_format=torch.contiguous_format)
                 for t in (x, Bm, Cm))
    kernel_check(x, Bm, Cm, dt, A, P, L)
    y, h = _SSDChunked.apply(x, Bm, Cm, dt.contiguous(), A.contiguous(), P,
                             L)
    H = di // P
    y = (y.view(B_, T, H, P)
         + D.to(y.dtype)[:, None] * x.reshape(B_, T, H, P))
    return y.view(B_, T, di), h
