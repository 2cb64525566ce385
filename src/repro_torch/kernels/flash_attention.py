"""Attention kernels of the port: paged decode attention (CUDA kernel B3)
and causal flash attention (CUDA kernel B4).

`paged_flash_attention` is the counterpart of
`repro.kernels.flash_attention.paged_flash_attention`, whose Pallas TPU
kernel `_paged_kernel` it replaces: one query token per row, grouped GQA
heads, over a paged KV pool, with an online softmax that reads only the
row's live blocks. The kernel is `csrc/paged_attention.cu`, instantiated
for bfloat16 (the serving path) and float32: a thread block cluster of
`paged_split(...)` CTAs per (row, kv head), each over a contiguous share
of the row's live blocks (`paged_ranges`), merged inside the cluster.

`flash_attention` is the counterpart of
`repro.kernels.flash_attention.flash_attention`, whose Pallas TPU kernel
`_flash_kernel` it replaces: causal (or full) softmax attention over
(BH, S, D) tensors with the online softmax. The kernel is
`csrc/flash_attention.cu`, float32 on CUDA cores and bfloat16 on tensor
cores, each q tile's key range split over a cluster of `flash_split(...)`
CTAs (`flash_ranges`). No model path of the JAX package calls it (its
prefill is `attention_dense`), and none of the port does; `chip_smoke.py`
holds it against its plain version and times it, as the JAX package's
kernel benchmark does.

The plan functions (cluster sizes, key ranges) are plain Python of the
shapes, the kernel's tiles and the SM count, so the CPU tests check them;
the kernels compute the same ranges on the device (B3 from `lengths`, with
no host sync). The tiles and the shared-memory layout belong to the CUDA
sources, which export them (`flash_attention_tiles`,
`paged_attention_smem`); a wrapper makes its plan once per shape and
device and keeps it. `csrc/softmax_merge.cuh` holds the merge both kernels
share.

Dispatch is by device: CPU tensors go to the plain versions
(`kernels.ref.paged_attention_ref`, `kernels.ref.flash_attention_ref`),
CUDA tensors to the kernels, which raise on anything they do not take.
There is no fallback from one to the other. Meta tensors go to the
kernels' abstract forms (`kernels.meta`): an empty meta output of q's
shape and dtype from one `repro_torch.paged_attention` (or
`flash_attention`) op, for a traced call; nothing runs. `launches` counts
B3's launches and `flash_launches` B4's (CPU calls do not count),
`meta_launches` and `flash_meta_launches` their meta calls;
`reset_launches()` zeroes all four.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from . import meta as M
from .ref import flash_attention_ref, paged_attention_ref

launches = 0
flash_launches = 0
meta_launches = 0        # B3 on meta operands (nothing runs)
flash_meta_launches = 0  # B4 on meta operands
_fns = {}
_flash_fns = {}
_paged_plans = {}
_flash_plans = {}
_CTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_G, MAX_GD = 8, 2048           # query heads per kv head; G·D per block
HEAD_DIMS = (16, 32, 64, 128, 256)  # B3's and B4's instantiations
MAX_CLUSTER = 8                   # CTAs a cluster: the portable limit
GRID_MAX = 65535                  # blocks along a grid's y or z
PAGED_STAGE_BYTES = 96 * 1024     # keys and values a B3 CTA stages at once


def reset_launches() -> None:
    global launches, flash_launches, meta_launches, flash_meta_launches
    launches = flash_launches = meta_launches = flash_meta_launches = 0


def _like_q(q, *rest):
    return torch.empty_like(q)


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------- #
# The plans: cluster sizes, tiles and key ranges of B3 and B4
# --------------------------------------------------------------------------- #
def paged_split(B: int, Kh: int, maxb: int, sms: int) -> int:
    """B3's cluster size c: CTAs per (row, kv head). The largest power of
    two up to MAX_CLUSTER (and up to MAXB, so that a CTA can own a block)
    with B·K·c CTAs within the SM count; 1 where B·K already fills the
    card. gemma-2b serving (B·K = 16, MAXB = 20, 132 SMs): 8, 128 CTAs."""
    c = 1
    while (2 * c <= MAX_CLUSTER and 2 * c <= maxb
           and 2 * c * B * Kh <= sms):
        c *= 2
    return c


def paged_ranges(lengths, bs: int, maxb: int, cluster: int):
    """Per row, CTA r's share of the row's live blocks as a half-open range
    of logical block indices: [r·nb/c, (r+1)·nb/c) with nb = ceil(L/bs)
    clamped to MAXB, as the kernel computes it from `lengths`. Empty (lo ==
    hi) for a row with L = 0 and for CTAs past the live blocks."""
    out = []
    for L in lengths:
        nb = min(-(-int(L) // bs), maxb) if L > 0 else 0
        out.append([(r * nb // cluster, (r + 1) * nb // cluster)
                    for r in range(cluster)])
    return out


def paged_chunk(bs: int, D: int, esize: int, maxb: int, cluster: int) -> int:
    """Pool blocks a B3 CTA stages at once: its whole share (at most
    ceil(MAXB/c) blocks) where PAGED_STAGE_BYTES holds it, at least one."""
    share = -(-maxb // cluster)
    return max(1, min(share, PAGED_STAGE_BYTES // (2 * bs * D * esize)))


def flash_split(BH: int, S: int, bq: int, bk: int, sms: int) -> int:
    """B4's cluster size c, CTAs per q tile, for the kernel's tiles of bq
    query rows and bk keys (`flash_tiles`). c doubles (up to MAX_CLUSTER)
    while BH·ceil(S/bq)·c is below twice the SM count, so the grid fills
    the card about twice, and while the longest q tile keeps at least two
    key tiles a CTA (each CTA loads its q tile and merges: a CTA of one key
    tile is mostly overhead); the longest CTA then does about 1/c of the
    longest q tile's keys. Causal or not, the cluster is the same; the
    ranges differ (`flash_ranges`)."""
    tiles = BH * -(-S // bq)
    kt_max = -(-S // bk)
    c = 1
    while (2 * c <= MAX_CLUSTER and 4 * c <= kt_max
           and tiles * c < 2 * sms):
        c *= 2
    return c


def flash_ranges(S: int, bq: int, bk: int, cluster: int, causal: bool):
    """Per q tile (rows [t·BQ, min(S, (t+1)·BQ))), CTA r's keys as a
    half-open range: key tiles [r·nkt/c, (r+1)·nkt/c) of the tile's keys
    [0, kend), kend = min(S, (t+1)·BQ) when causal, else S; as the kernel
    computes them. Key tiles above the diagonal belong to no CTA."""
    out = []
    for t in range(-(-S // bq)):
        kend = min(S, (t + 1) * bq) if causal else S
        nkt = -(-kend // bk)
        out.append([(min(kend, (r * nkt // cluster) * bk),
                     min(kend, ((r + 1) * nkt // cluster) * bk))
                    for r in range(cluster)])
    return out


# --------------------------------------------------------------------------- #
# B3: paged decode attention
# --------------------------------------------------------------------------- #
def _kernel(dtype):
    fn = _fns.get(dtype)
    if fn is None:
        lib = _build.load("paged_attention")
        fn = getattr(lib, f"paged_attention_{_CTYPES[dtype]}")
        # q, pool_k, pool_v, table, lengths, out; B, K, G, D, bs, MAXB,
        # cluster, chunk; sm_scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def paged_smem(esize: int, G: int, D: int, bs: int, chunk: int) -> int:
    """Shared memory of one B3 CTA in bytes, as the CUDA source lays it out
    (`paged_attention_smem`), or -1 where that is more than a block may
    use. Needs the built library."""
    fn = _build.load("paged_attention").paged_attention_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    return fn(esize, G, D, bs, chunk)


def _paged_plan(q, bs: int, maxb: int):
    """(cluster, chunk) of B3 for q's shape, dtype and device, the pool's
    block size and MAXB; made once and kept."""
    key = (tuple(q.shape), bs, maxb, q.dtype, q.device)
    plan = _paged_plans.get(key)
    if plan is None:
        B, Kh, G, D = q.shape
        cluster = paged_split(B, Kh, maxb, sm_count(q.device))
        chunk = paged_chunk(bs, D, q.element_size(), maxb, cluster)
        if paged_smem(q.element_size(), G, D, bs, chunk) < 0:
            raise ValueError(f"paged_flash_attention: a block of bs={bs} x "
                             f"D={D} needs more shared memory than a block "
                             f"of the kernel may use")
        plan = _paged_plans[key] = (cluster, chunk)
    return plan


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
    if (not 1 <= B <= GRID_MAX or Kh > GRID_MAX or G > MAX_G
            or G * D > MAX_GD or D not in HEAD_DIMS):
        raise ValueError(f"paged_flash_attention: the kernel takes 1 <= B "
                         f"<= {GRID_MAX}, K <= {GRID_MAX}, G <= {MAX_G}, D "
                         f"in {HEAD_DIMS} and G*D <= {MAX_GD}, got B={B}, "
                         f"K={Kh}, G={G}, D={D}")
    if pool_k.data_ptr() % 16 or pool_v.data_ptr() % 16:
        raise ValueError("paged_flash_attention: the pools must be 16-byte "
                         "aligned (the kernel loads them 16 bytes at a time)")
    maxb = table.shape[1]
    cluster, chunk = _paged_plan(q, bs, maxb)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _kernel(q.dtype)(q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
                          table.data_ptr(), lengths.data_ptr(),
                          out.data_ptr(), B, Kh, G, D, bs, maxb, cluster,
                          chunk, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error "
                           f"{rc} at q {tuple(q.shape)}, pool "
                           f"{tuple(pool_k.shape)}, table "
                           f"{tuple(table.shape)}, cluster {cluster}, chunk "
                           f"{chunk}")
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
    if q.device.type == "meta":
        return _paged_meta(q, pool_k, pool_v, table, lengths)
    return _launch(q, pool_k, pool_v, table, lengths)


def _paged_meta(q, pool_k, pool_v, table, lengths):
    """B3's abstract form: its output as a meta tensor, from one op."""
    global meta_launches
    M.check_meta("paged_flash_attention", (
        ("pool_k", pool_k), ("pool_v", pool_v), ("table", table),
        ("lengths", lengths)))
    out = M.op("paged_attention", "(Tensor q, Tensor pool_k, Tensor pool_v, "
               "Tensor table, Tensor lengths) -> Tensor", _like_q)(
        q, pool_k, pool_v, table, lengths)
    meta_launches += 1
    return out


# --------------------------------------------------------------------------- #
# B4: causal flash attention
# --------------------------------------------------------------------------- #
def _flash_kernel(dtype):
    fn = _flash_fns.get(dtype)
    if fn is None:
        lib = _build.load("flash_attention")
        fn = getattr(lib, f"flash_attention_{_CTYPES[dtype]}")
        # q, k, v, out; BH, S, D, causal, cluster; sm_scale; stream
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _flash_fns[dtype] = fn
    return fn


def flash_tiles(dtype, D: int):
    """(BQ, BK) of B4's kernel for `dtype` and head dim D, as the CUDA
    source defines them (`flash_attention_tiles`). Needs the built
    library."""
    fn = _build.load("flash_attention").flash_attention_tiles
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    bq, bk = ctypes.c_int(), ctypes.c_int()
    if fn(dtype.itemsize, D, ctypes.byref(bq), ctypes.byref(bk)) != 0:
        raise ValueError(f"flash_attention: no kernel for {dtype} at D={D}")
    return bq.value, bk.value


def _flash_plan(q):
    """(BQ, BK, cluster) of B4 for q's shape, dtype and device; made once
    and kept."""
    key = (tuple(q.shape), q.dtype, q.device)
    plan = _flash_plans.get(key)
    if plan is None:
        BH, S, D = q.shape
        bq, bk = flash_tiles(q.dtype, D)
        if -(-S // bq) > GRID_MAX:
            raise ValueError(f"flash_attention: the kernel takes at most "
                             f"{GRID_MAX} q tiles of {bq} rows, got S={S}")
        plan = _flash_plans[key] = (bq, bk, flash_split(BH, S, bq, bk,
                                                        sm_count(q.device)))
    return plan


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
    if D not in HEAD_DIMS or not 1 <= BH <= GRID_MAX or S < 1:
        raise ValueError(f"flash_attention: the kernel takes D in "
                         f"{HEAD_DIMS}, 1 <= BH <= {GRID_MAX} and 1 <= S, "
                         f"got BH={BH}, S={S}, D={D}")
    bq, bk, cluster = _flash_plan(q)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = _flash_kernel(q.dtype)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                out.data_ptr(), BH, S, D, int(causal),
                                cluster, 1.0 / math.sqrt(D), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc} at q {tuple(q.shape)} {q.dtype}, "
                           f"tiles {bq}x{bk}, cluster {cluster}")
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
    if q.device.type == "meta":
        return _flash_meta(q, k, v, causal)
    return _flash_launch(q, k, v, causal)


def _flash_meta(q, k, v, causal):
    """B4's abstract form: its output as a meta tensor, from one op."""
    global flash_meta_launches
    M.check_meta("flash_attention", (("k", k), ("v", v)))
    out = M.op("flash_attention",
               "(Tensor q, Tensor k, Tensor v, bool causal) -> Tensor",
               _like_q)(q, k, v, bool(causal))
    flash_meta_launches += 1
    return out
