"""Error feedback (paper Algorithm 2, lines 6–8; Lemma 1).

Counterpart of `repro.core.error_feedback`. The worker sends Q(m) with
m = message + e_prev and keeps e_new = m − Q(m). For the block-1024 linf
quantizers over a flat bucket, the EF add, scale, stochastic round and
residual run in one pass of the fused kernel (`kernels.quantize`): B1 for
a registry compressor, B2 for a `TracedQuant`, whose level count is a
device tensor. `compress_with_ef_stacked` does the same for a stack of
workers' messages (or of their two_phase chunks), with one kernel launch
over all of their rows, or one `compress` call where the quantizer's
blocks tile each row; `row_draws` gives each worker its own generator's
draws; `packed_levels` says when one launch over a step's comm buckets
packed back to back is exact.

A leaf sharded over the model axis (`LeafShard`: each rank holds a slice
of it along one dimension) is compressed as the JAX package compresses
the global tensor: a per-tensor scale is the model group's max (linf) or
root sum of squares (l2) over the rank's slices; a blocked quantizer's
blocks are the global ravel's, local where every block lies inside the
rank's slice, else taken on the leaf gathered over the model group; the
draws are made at the global shape and each rank takes its slice. The
bucket path is unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Tuple

import torch

from repro_torch.kernels.quantize import quantize_ef_flat

from . import compressors as C

FUSED_BLOCK = 1024  # kernel row width; must match kernels.quantize tiling


def fused_compatible(compressor, message) -> bool:
    """True when the fused quantize+EF kernel realizes exactly this
    compressor on this operand: linf quantization with one scale per
    FUSED_BLOCK elements, over a flat array whose length FUSED_BLOCK
    divides (comm buckets always are). A `TracedQuant` qualifies with the
    same block, whatever its level count."""
    shaped = message.dim() == 1 and message.shape[0] % FUSED_BLOCK == 0
    if isinstance(compressor, C.TracedQuant):
        return compressor.per_block == FUSED_BLOCK and shaped
    return _static_fused(compressor) and shaped


def _static_fused(compressor) -> bool:
    """A registry compressor that B1 realizes on rows of FUSED_BLOCK."""
    return (isinstance(compressor, C.StochasticQuant)
            and compressor.norm == "linf"
            and compressor.per_block == FUSED_BLOCK)


def packed_levels(compressors, sizes):
    """The level count L when ONE B1 launch over flat buckets of these
    sizes, packed back to back, realizes each bucket's compressor exactly:
    every one a registry compressor that `fused_compatible` takes on its
    bucket, all at the same static L. Rows are independent, so the packed
    launch then equals one launch a bucket. Otherwise None (a
    `TracedQuant`'s level count lives on the device: B2, a launch a
    bucket)."""
    if not (all(map(_static_fused, compressors))
            and all(n % FUSED_BLOCK == 0 for n in sizes)):
        return None
    levels = {c.levels for c in compressors}
    return levels.pop() if len(levels) == 1 else None


def compress_with_ef(compressor, message, e_prev, rand=None, generator=None,
                     *, use_ef: bool = True, allow_fused: bool = True):
    """Compress (message + e_prev); return (payload, local dequant, e_new).

    use_ef=False is the CPOAdam-GQ baseline: the compression error is
    dropped. `rand` replaces the compressor's draws (see compressors).
    """
    if use_ef and allow_fused and fused_compatible(compressor, message):
        return fused_quantize_ef(message, e_prev, rand, generator,
                                 levels=compressor.levels)
    m = message + e_prev.to(message.dtype) if use_ef else message
    payload = compressor.compress(m, rand, generator)
    m_hat = compressor.decompress(payload, m.shape, m.dtype)
    if use_ef:
        e_new = (m - m_hat).to(e_prev.dtype)
    else:
        e_new = e_prev  # stays zero
    return payload, m_hat, e_new


def row_draws(generators, R: int, n: int, device):
    """(R, n) uniform draws for a stack of R rows of n elements from G
    generators, one a worker: R/G rows from each in turn, one draw each,
    so that a worker's draws do not depend on which other workers share
    its stack."""
    per = R // len(generators)
    return torch.cat([torch.rand((per * n,), generator=g, device=device)
                      for g in generators]).reshape(R, n)


def _row_generator(generator, R: int, i: int):
    if isinstance(generator, (list, tuple)):
        return generator[i // (R // len(generator))]
    return generator


def rows_blocked(compressor, n: int) -> bool:
    """True when a blocked quantizer's scale blocks tile a row of n
    elements exactly: one `compress` over a stack of such rows, flattened,
    is then the per-row calls side by side (the same blocks, the same
    elementwise arithmetic)."""
    b = getattr(compressor, "per_block", 0)
    return (isinstance(compressor, (C.StochasticQuant, C.TracedQuant))
            and b > 0 and n % b == 0)


def compress_rows(compressor, x, rand=None, generator=None):
    """`compressor.compress` of each row of the (R, ...) stack `x` as ONE
    call over the stack (`rows_blocked` must hold); each payload entry
    gains a leading R axis. Without `rand`, row i draws from its worker's
    generator (see `row_draws`)."""
    R = x.shape[0]
    n = x[0].numel()
    assert rows_blocked(compressor, n), "compress_rows: rows not blocked"
    if rand is None and isinstance(generator, (list, tuple)):
        rand = row_draws(generator, R, n, x.device)
    pl = compressor.compress(x.reshape(-1), None if rand is None
                             else rand.reshape(-1), generator)
    return {k: v.reshape((R, -1) + tuple(v.shape[1:]))
            for k, v in pl.items()}


def decompress_rows(compressor, payload, row_shape, dtype, shard=None):
    """(R, *row_shape): `compressor.decompress` of each row of a stacked
    payload (as `compress_rows` makes it); one call where `rows_blocked`.
    With a `shard` whose mode is "gather" the payload is the global rows'
    and the result their slices (row_shape is the local shape)."""
    if shard is not None and shard.mode(compressor) == "gather":
        return shard.slice(decompress_rows(compressor, payload, shard.shape,
                                           dtype))
    R = next(iter(payload.values())).shape[0]
    n = math.prod(row_shape)
    if rows_blocked(compressor, n):
        flat = {k: v.reshape((-1,) + tuple(v.shape[2:]))
                for k, v in payload.items()}
        return compressor.decompress(flat, (R * n,), dtype).reshape(
            (R,) + tuple(row_shape))
    return torch.stack([compressor.decompress({k: v[i] for k, v in
                                               payload.items()},
                                              row_shape, dtype)
                        for i in range(R)])


@dataclasses.dataclass(frozen=True)
class LeafShard:
    """Where a stack of rows sits in its global tensors: each row's global
    shape is `shape`, of which this rank (model index `index` of `size`)
    holds the slice of dimension `axis`; `group` is the model group (a
    `parallel.tensor.ModelGroup`)."""
    shape: Tuple[int, ...]
    axis: int
    index: int
    size: int
    group: Any = dataclasses.field(compare=False, default=None)

    @property
    def local_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        s[self.axis] //= self.size
        return tuple(s)

    def chunked(self, ax: int, n: int) -> "LeafShard":
        """The shard of two_phase's chunks: a row of `shape` moved to lead
        with unsharded axis `ax` and cut n ways along it."""
        rest = [d for i, d in enumerate(self.shape) if i != ax]
        axis = self.axis + 1 if self.axis < ax else self.axis
        return dataclasses.replace(
            self, shape=(self.shape[ax] // n, *rest), axis=axis)

    def _pre_post(self):
        return (math.prod(self.shape[:self.axis]), self.shape[self.axis],
                math.prod(self.shape[self.axis + 1:]))

    def mode(self, compressor) -> str:
        """"local": the compressor acts on the slice as on the global
        tensor (elementwise, or every scale block inside the slice);
        "scale": a per-tensor quantizer, its scale reduced over the
        group; "gather": the rest, compressed on the gathered leaf."""
        if compressor.name == "identity":
            return "local"
        if not isinstance(compressor, (C.StochasticQuant, C.TracedQuant)):
            return "gather"
        b = compressor.per_block
        if b <= 0:
            return "scale"
        _, D, post = self._pre_post()
        c = D // self.size
        if (c * post) % b == 0 and (D * post) % b == 0:
            return "local"
        return "gather"

    def take(self, flat):
        """(R, ≥ global numel) rows of the global ravel (draws) -> this
        rank's slices, (R, local numel)."""
        R = flat.shape[0]
        pre, D, post = self._pre_post()
        c = D // self.size
        g = flat[:, :pre * D * post].reshape(R, pre, D, post)
        return g[:, :, self.index * c:(self.index + 1) * c].reshape(R, -1)

    def gather(self, x):
        """(R, *local) -> (R, *shape): the rows gathered over the group."""
        return self.group.all_gather(x, self.axis + 1)

    def slice(self, x):
        """(R, *shape) -> (R, *local): this rank's slices."""
        c = self.shape[self.axis] // self.size
        return x.narrow(self.axis + 1, self.index * c, c)


def _draw_count(compressor, d: int) -> int:
    """The uniform draws a stochastic quantizer takes for d elements (its
    blocked, padded shape), 0 for the others."""
    if not isinstance(compressor, (C.StochasticQuant, C.TracedQuant)):
        return 0
    b = compressor.per_block
    return d if b <= 0 else -(-d // b) * b


def _sharded_draws(compressor, R, shard, rand, generator, device):
    """(R, global draws) for the rows: `rand` (already global), or made at
    the global shape from the generator(s), one a worker."""
    n = _draw_count(compressor, math.prod(shard.shape))
    if rand is not None or n == 0:
        return None if rand is None else rand.reshape(R, -1)
    if isinstance(generator, (list, tuple)):
        return row_draws(generator, R, n, device)
    return torch.rand((R, n), generator=generator, device=device,
                      dtype=torch.float32)


def _compress_sharded(compressor, m, rand, generator, shard):
    """(payload, m_hat) of the rows of m (R, *local), each compressed as
    its global tensor is (see `LeafShard.mode`); `rand` the global draws."""
    R = m.shape[0]
    mode = shard.mode(compressor)
    rand = _sharded_draws(compressor, R, shard, rand, generator, m.device)
    if mode == "gather":
        full = shard.gather(m)
        outs = [compressor.compress(full[i], None if rand is None
                                    else rand[i],
                                    _row_generator(generator, R, i))
                for i in range(R)]
        payload = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        m_hat = decompress_rows(compressor, payload, m.shape[1:], m.dtype,
                                shard)
        return payload, m_hat
    local = None if rand is None else shard.take(rand)
    if mode == "scale":
        f = m.reshape(R, -1).float()
        if compressor.norm == "l2":
            s = torch.sqrt(shard.group.all_reduce(
                f.square().sum(-1, keepdim=True)))
        else:
            s = shard.group.all_reduce(f.abs().amax(-1, keepdim=True),
                                       torch.distributed.ReduceOp.MAX)
        s = s + C._EPS
        codes = C._stochastic_round_codes(f, s, compressor.levels, local)
        payload = {"codes": codes[:, None, :], "scale": s[:, None, :]}
    elif compressor.name == "identity":
        payload = {"values": m}
    else:
        payload = compress_rows(compressor, m, local, generator)
    return payload, decompress_rows(compressor, payload, m.shape[1:],
                                    m.dtype, shard)


def compress_with_ef_stacked(compressor, message, e_prev, rand=None,
                             generator=None, *, use_ef: bool = True,
                             allow_fused: bool = True, shard=None):
    """`compress_with_ef` for each row of an (R, ...) stack (R workers'
    messages, or their chunks), as JAX's per-worker body computes it;
    returns the stacked (payload, m_hat, e_new), each payload entry with a
    leading R axis.

    When the fused kernel realizes the compressor on one row, every row's
    scale rows are disjoint rows of the stack, so ONE launch over the
    stacked (R·r, 1024) rows is exact. Otherwise, where `rows_blocked`
    holds, one `compress` over the stack; else each row on its own.
    `rand` holds the rows' draws in order (row i of an (R, ...) stack);
    without it they come from `generator`, one or one per worker (see
    `row_draws`). `allow_fused=False` keeps the registry compressor's own
    rounding (the kernel rounds m, the compressor |m| with its sign).
    `shard` (a `LeafShard`): the rows are slices of model-sharded
    tensors, compressed as the global tensors are (a flat one the fused
    kernel realizes through it: on the slices where each holds whole
    scale rows, else on the gathered rows); `rand` then holds the global
    draws."""
    R = message.shape[0]
    n = message[0].numel()
    if shard is not None and not (
            use_ef and allow_fused and len(shard.shape) == 1
            and fused_compatible(compressor, message.new_empty(
                shard.shape, device="meta"))):
        m = message + e_prev.to(message.dtype) if use_ef else message
        payload, m_hat = _compress_sharded(compressor, m, rand, generator,
                                           shard)
        e_new = (m - m_hat).to(e_prev.dtype) if use_ef else e_prev
        return payload, m_hat, e_new
    if shard is not None and not fused_compatible(compressor, message[0]):
        # the slices cut the flat leaf's scale rows: the fused kernel runs
        # on the gathered leaf, as the JAX package runs it on the global one
        payload, m_hat, e_new = compress_with_ef_stacked(
            compressor, shard.gather(message), shard.gather(e_prev), rand,
            generator)
        return payload, shard.slice(m_hat), shard.slice(e_new)
    per_worker = isinstance(generator, (list, tuple))
    if shard is not None:
        # a flat sharded leaf the fused kernel takes (as the JAX package
        # takes the global one): its scale rows lie inside each slice
        rand = shard.take(_sharded_draws(compressor, R, shard, rand,
                                         generator, message.device))
    if use_ef and allow_fused and fused_compatible(compressor, message[0]):
        if rand is None and per_worker:
            rand = row_draws(generator, R, n, message.device)
        payload, m_hat, e_new = compress_with_ef(
            compressor, message.reshape(-1), e_prev.reshape(-1),
            None if rand is None else rand.reshape(-1), generator)
        payload = {k: v.reshape((R, -1) + tuple(v.shape[1:]))
                   for k, v in payload.items()}
        return payload, m_hat.reshape(message.shape), \
            e_new.reshape(e_prev.shape)
    if rows_blocked(compressor, n):
        m = message + e_prev.to(message.dtype) if use_ef else message
        payload = compress_rows(compressor, m, rand, generator)
        m_hat = decompress_rows(compressor, payload, m.shape[1:], m.dtype)
        e_new = (m - m_hat).to(e_prev.dtype) if use_ef else e_prev
        return payload, m_hat, e_new
    outs = [compress_with_ef(compressor, message[w], e_prev[w],
                             None if rand is None else rand.reshape(R, -1)[w],
                             _row_generator(generator, R, w), use_ef=use_ef,
                             allow_fused=allow_fused)
            for w in range(R)]
    payload = {k: torch.stack([o[0][k] for o in outs]) for k in outs[0][0]}
    return (payload, torch.stack([o[1] for o in outs]),
            torch.stack([o[2] for o in outs]))


def fused_quantize_ef(message_flat, e_prev, rand=None, generator=None, *,
                      levels=127):
    """EF + int8 quantization of a flat comm bucket in one kernel pass
    (kernels.quantize.quantize_ef_flat): the fused equivalent of
    compress_with_ef(StochasticQuant(bits=8, norm="linf",
    per_block=FUSED_BLOCK), ...). `rand` is a uniform (n,) tensor, drawn
    from `generator` when not given. `levels` is a Python int (kernel B1)
    or a one-element float32 tensor on the message's device (B2).

    Returns (payload {"codes" (R, 1024) int8, "scale" (R, 1) f32}, m_hat,
    e_new), laid out like the blocked StochasticQuant payload."""
    m32 = message_flat.float()
    if rand is None:
        rand = torch.rand(m32.shape, generator=generator, device=m32.device,
                          dtype=torch.float32)
    codes, scales, e_new = quantize_ef_flat(
        m32, e_prev.float(), rand.reshape(m32.shape), levels=levels)
    R = scales.shape[0]
    # the kernel's step s/L, by IEEE division (see kernels.ref), so that
    # m_hat + e_new = m holds to the last bit
    lvl = (levels.reshape(1, 1) if isinstance(levels, torch.Tensor)
           else _level_divisor(scales.device, levels))
    step = scales[:, None] / lvl
    m_hat = (codes.reshape(R, -1).float() * step).reshape(message_flat.shape)
    return ({"codes": codes.reshape(R, -1), "scale": scales.reshape(R, 1)},
            m_hat.to(message_flat.dtype), e_new.to(e_prev.dtype))


@functools.lru_cache(maxsize=64)
def _level_divisor(device, levels: int):
    """B1's static level count as a float32 scalar on `device`, made once
    a (device, levels) by a fill on the device: no copy from the host, so
    no B1 call synchronizes with it."""
    return torch.full((), float(levels), dtype=torch.float32, device=device)


def lemma1_bound(eta, delta, G, sigma, B):
    """RHS of Lemma 1: 8η²(1-δ)(G² + σ²/B)/δ²."""
    return 8.0 * eta**2 * (1.0 - delta) * (G**2 + sigma**2 / B) / delta**2
