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

A leaf sharded over the model axis, or under the fsdp layout over the
data and model axes (`LeafShard`: each rank holds a slice of it, cut
along one dimension a mesh axis), is compressed as the JAX package
compresses the global tensor: a per-tensor scale is the groups' max
(linf) or root sum of squares (l2) over the rank's slices; a blocked
quantizer's blocks are the global ravel's, quantized on the rank's slice
where every block lies inside it, or where the caller reads no payload
(the scales of blocks that cross the slices reduced over the groups),
else on the leaf gathered over the groups (a stacked leaf one layer at a
time). A leaf's draws above one tile (`DRAW_TILE`) come from its own
stream in tiles of its global ravel, of which a rank draws only those
its slice meets (`DrawChunks`); one process draws the same stream
(`stream_draws`). A leaf of at most one
tile draws at its global shape from the generator, each rank taking its
slice. The bucket path is unchanged.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional, Tuple

import numpy as np
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
    shape is `shape`, of which this rank holds the slice that model index
    `index` of `size` takes of dimension `axis` (None: not cut over
    'model') and, under the fsdp layout, data index `data_index` of
    `data_size` takes of dimension `data_axis`; `group` and `data_group`
    are the model and fsdp groups (`parallel.tensor.ModelGroup`,
    `parallel.fsdp.FsdpGroup`)."""
    shape: Tuple[int, ...]
    axis: Optional[int]
    index: int
    size: int
    group: Any = dataclasses.field(compare=False, default=None)
    data_axis: Optional[int] = None
    data_index: int = 0
    data_size: int = 1
    data_group: Any = dataclasses.field(compare=False, default=None)

    @property
    def cuts(self):
        """[(dimension, index, size, group)] of each cut, the model's
        first."""
        out = []
        if self.axis is not None and self.size > 1:
            out.append((self.axis, self.index, self.size, self.group))
        if self.data_axis is not None and self.data_size > 1:
            out.append((self.data_axis, self.data_index, self.data_size,
                        self.data_group))
        return out

    @property
    def local_shape(self) -> Tuple[int, ...]:
        s = list(self.shape)
        for ax, _, n, _ in self.cuts:
            s[ax] //= n
        return tuple(s)

    def ranges(self):
        """[(dimension, lo, hi)]: the global index range of each cut."""
        out = []
        for ax, i, n, _ in self.cuts:
            c = self.shape[ax] // n
            out.append((ax, i * c, (i + 1) * c))
        return out

    def chunked(self, ax: int, n: int) -> "LeafShard":
        """The shard of two_phase's chunks: a row of `shape` moved to lead
        with unsharded axis `ax` and cut n ways along it."""
        rest = [d for i, d in enumerate(self.shape) if i != ax]

        def moved(a):
            return None if a is None else (a + 1 if a < ax else a)
        return dataclasses.replace(
            self, shape=(self.shape[ax] // n, *rest), axis=moved(self.axis),
            data_axis=moved(self.data_axis))

    def mode(self, compressor) -> str:
        """"local": the compressor acts on the slice as on the global
        tensor (elementwise, or every scale block inside the slice);
        "scale": a per-tensor quantizer, its scale reduced over the
        groups; "gather": the rest, compressed on the gathered leaf."""
        if compressor.name == "identity":
            return "local"
        if not isinstance(compressor, (C.StochasticQuant, C.TracedQuant)):
            return "gather"
        b = compressor.per_block
        if b <= 0:
            return "scale"
        # the rank's elements are runs of the innermost cut's c · post
        # elements at multiples of that, inside rows of D · post
        ax, _, n, _ = max(self.cuts)
        D, post = self.shape[ax], math.prod(self.shape[ax + 1:])
        if (D // n * post) % b == 0 and (D * post) % b == 0:
            return "local"
        return "gather"

    def take(self, flat):
        """(R, ≥ global numel) rows of the global ravel (draws) -> this
        rank's slices, (R, local numel)."""
        R = flat.shape[0]
        g = flat[:, :math.prod(self.shape)].reshape((R,) + self.shape)
        for ax, lo, hi in self.ranges():
            g = g.narrow(ax + 1, lo, hi - lo)
        return g.reshape(R, -1)

    def gather(self, x):
        """(R, *local) -> (R, *shape): the rows gathered over the groups."""
        for ax, _, _, group in self.cuts:
            x = group.all_gather(x, ax + 1)
        return x

    def slice(self, x):
        """(R, *shape) -> (R, *local): this rank's slices."""
        for ax, lo, hi in self.ranges():
            x = x.narrow(ax + 1, lo, hi - lo)
        return x

    def reduce(self, x, op=None):
        """x summed (or reduced by `op`) over the cuts' groups, in
        place."""
        for _, _, _, group in self.cuts:
            if op is None:
                group.all_reduce(x)
            else:
                group.all_reduce(x, op)
        return x


def _draw_count(compressor, d: int) -> int:
    """The uniform draws a stochastic quantizer takes for d elements (its
    blocked, padded shape), 0 for the others."""
    if not isinstance(compressor, (C.StochasticQuant, C.TracedQuant)):
        return 0
    b = compressor.per_block
    return d if b <= 0 else -(-d // b) * b


# --------------------------------------------------------------------------- #
# a leaf's draws, in tiles
# --------------------------------------------------------------------------- #
# A leaf whose quantizer takes more than DRAW_TILE draws draws them from
# its own stream, in tiles of DRAW_TILE elements of its global ravel: tile
# t from a generator seeded by (the stream's seed, t), the stream's seed
# from (the worker's step seed, the leaf's index) (`leaf_stream`). A rank
# holding a slice draws the tiles its slice meets, one at a time, keeping
# its part of each (`DrawChunks`); one process draws them all
# (`tile_draws`). A leaf of at most one tile draws from the step's
# generator, in leaf order, as ever.
DRAW_TILE = 1 << 20


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a well-spread 64-bit value of x."""
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def leaf_stream(step_seed: int, leaf: int) -> int:
    """The seed of a leaf's tile stream: a function of the worker's step
    seed and the leaf's index alone."""
    return _mix64(step_seed ^ _mix64(leaf + 1))


def _tile(stream: int, t: int, n: int, device):
    """Tile t of a stream of n draws: min(DRAW_TILE, n − t·DRAW_TILE)
    uniforms."""
    m = min(DRAW_TILE, n - t * DRAW_TILE)
    if device.type == "meta":
        return torch.rand((m,), device=device)
    g = torch.Generator(device=device)
    g.manual_seed(_mix64(stream + (t + 1) * 0x9E3779B97F4A7C15))
    return torch.rand((m,), generator=g, device=device)


def tile_draws(stream: int, n: int, start: int, stop: int, device):
    """Draws [start, stop) of a stream of n, tile by tile."""
    device = torch.device(device)
    out = torch.empty((stop - start,), device=device)
    if device.type == "meta":
        _tile(stream, start // DRAW_TILE, n, device)
        return out
    T = DRAW_TILE
    for t in range(start // T, (stop - 1) // T + 1):
        tile = _tile(stream, t, n, device)
        a, b = max(start, t * T), min(stop, t * T + tile.numel())
        out[a - start:b - start] = tile[a - t * T:b - t * T]
        del tile
    return out


def _met_tiles(n: int, shard: "LeafShard", device):
    """(tile index, mask of the slice's elements in it, their count) of
    each tile of a stream of n that the slice meets, in order: the tiles
    of each block of the outermost cut's rows."""
    shape, ranges = shard.shape, shard.ranges()
    T = DRAW_TILE
    a0, lo0, hi0 = min(ranges)
    pre, S0 = math.prod(shape[:a0]), shape[a0]
    post0 = math.prod(shape[a0 + 1:])
    p = np.arange(pre, dtype=np.int64) * S0
    t_lo, t_hi = (p + lo0) * post0 // T, ((p + hi0) * post0 - 1) // T
    mark = np.zeros(-(-n // T) + 1, np.int64)
    np.add.at(mark, t_lo, 1)
    np.add.at(mark, t_hi + 1, -1)
    strides = [math.prod(shape[ax + 1:]) for ax, _, _ in ranges]
    for t in np.flatnonzero(np.cumsum(mark)[:-1] > 0):
        t = int(t)
        idx = torch.arange(min(T, n - t * T), device=device) + t * T
        keep = idx < math.prod(shape)
        for (ax, lo, hi), st in zip(ranges, strides):
            c = torch.div(idx, st, rounding_mode="floor") % shape[ax]
            keep &= (c >= lo) & (c < hi)
        yield t, keep, int(keep.sum())


class DrawChunks:
    """The draws of R rows' slices of a leaf (`shard`), each row from its
    stream of n (`leaf_stream`), in the slice's ravel order, made as they
    are read: `take(a, z)` gives local elements [a, z), (R, z − a), for
    consecutive ranges from 0, drawing the tiles the range meets one at
    a time (the whole rows of the outer cut's range, each masked to the
    slice's elements) and keeping only the part of the last one that the
    next range starts with. A rank so holds a range's draws and a tile,
    never its slice's draws whole unless it reads them in one range."""

    def __init__(self, streams, n: int, shard: "LeafShard", device):
        self.streams, self.n, self.device = streams, n, torch.device(device)
        self.tiles = (None if self.device.type == "meta"
                      else _met_tiles(n, shard, self.device))
        self.start, self.buf = 0, None

    def take(self, a: int, z: int):
        assert a == self.start, (a, self.start)
        R = len(self.streams)
        out = torch.empty((R, z - a), device=self.device)
        self.start = z
        if self.tiles is None:     # meta: the range, and one tile made
            _tile(self.streams[0], 0, self.n, self.device)
            return out
        have = 0
        if self.buf is not None:
            have = min(self.buf.shape[1], z - a)
            out[:, :have] = self.buf[:, :have]
            self.buf = self.buf[:, have:] if self.buf.shape[1] > have \
                else None
        while have < z - a:
            t, keep, cnt = next(self.tiles)
            c = min(cnt, z - a - have)
            rest = (torch.empty((R, cnt - c), device=self.device)
                    if cnt > c else None)
            for i, s in enumerate(self.streams):
                part = _tile(s, t, self.n, self.device)[keep]
                out[i, have:have + c] = part[:c]
                if rest is not None:
                    rest[i] = part[c:]
                del part
            self.buf, have = rest, have + c
        return out


def stream_draws(compressor, R: int, n_elems: int, stream, device,
                 shard=None):
    """(R, draws) of R rows of a leaf of `n_elems` global elements from
    their tile streams (`stream`: one seed a row), this rank's slices with
    a `shard`; None when the leaf takes at most one tile (it draws from
    the generator) or no stream is given."""
    n = _draw_count(compressor, n_elems)
    if stream is None or n <= DRAW_TILE:
        return None
    if shard is not None and shard.cuts:
        return DrawChunks(stream, n, shard, device).take(
            0, math.prod(shard.local_shape))
    rows = [tile_draws(s, n, 0, n, device) for s in stream]
    return rows[0][None] if R == 1 else torch.stack(rows)


def _sharded_draws(compressor, R, shard, rand, generator, device):
    """(R, global draws) for the rows: `rand` (already global), or made at
    the global shape from the generator(s), one a worker (a leaf of at
    most one tile)."""
    n = _draw_count(compressor, math.prod(shard.shape))
    if rand is not None or n == 0:
        return None if rand is None else rand.reshape(R, -1)
    if isinstance(generator, (list, tuple)):
        return row_draws(generator, R, n, device)
    return torch.rand((R, n), generator=generator, device=device,
                      dtype=torch.float32)


def _slice_draws(compressor, R, shard, rand, generator, stream, device):
    """The draws of the rows' slices: a `DrawChunks` over their tile
    streams (a leaf above one tile, no `rand`), else (R, local numel)
    cut from the global draws (`rand`, or the generator's)."""
    n = _draw_count(compressor, math.prod(shard.shape))
    if rand is None and stream is not None and n > DRAW_TILE:
        return DrawChunks(stream, n, shard, device)
    return shard.take(_sharded_draws(compressor, R, shard, rand, generator,
                                     device))


def _gathered_slices(compressor, m, rand, generator, shard, stream):
    """"gather" mode, one leading slice at a time: a stacked leaf whose
    leading (layer) axis no cut splits and whose quantizer's blocks tile
    one layer. (payload, m_hat) as the whole leaf's, or None when the
    leaf does not qualify."""
    shape = shard.shape
    b = getattr(compressor, "per_block", 0)
    if (len(shape) < 2 or shape[0] < 2 or b <= 0
            or any(ax == 0 for ax, _, _ in shard.ranges())
            or not isinstance(compressor, (C.StochasticQuant, C.TracedQuant))
            or math.prod(shape[1:]) % b):
        return None
    R, P = m.shape[0], math.prod(shape[1:])
    n = _draw_count(compressor, math.prod(shape))
    glob = None
    if rand is None and (stream is None or n <= DRAW_TILE):
        glob = _sharded_draws(compressor, R, shard, None, generator, m.device)
    elif rand is not None:
        glob = rand.reshape(R, -1)
    m_hat = torch.empty_like(m)
    parts = []
    for layer in range(shape[0]):
        full = shard.gather(m[:, layer:layer + 1])[:, 0]       # (R, *rest)
        if glob is not None:
            r = glob[:, layer * P:(layer + 1) * P]
        else:
            r = torch.stack([tile_draws(s, n, layer * P, (layer + 1) * P,
                                        m.device) for s in stream])
        pl = compress_rows(compressor, full, r, generator)
        parts.append(pl)
        deq = decompress_rows(compressor, pl, full.shape[1:], m.dtype)
        m_hat[:, layer] = shard.slice(deq[:, None])[:, 0]
    payload = {k: torch.cat([pl[k] for pl in parts], 1) for k in parts[0]}
    return payload, m_hat


# elements a chunk of `_blocked_slices`: its temporaries are a few of these
QUANT_CHUNK = 1 << 22


def _global_positions(shard, start: int, stop: int, device):
    """The global ravel positions of the rank's local ravel indices
    [start, stop)."""
    rem = torch.arange(start, stop, device=device)
    offset = {ax: lo for ax, lo, _ in shard.ranges()}
    local, out, stride = shard.local_shape, torch.zeros_like(rem), 1
    for d in reversed(range(len(local))):
        out += (rem % local[d] + offset.get(d, 0)) * stride
        rem = torch.div(rem, local[d], rounding_mode="floor")
        stride *= shard.shape[d]
    return out


def _blocked_slices(compressor, m, draws, shard, payload: bool):
    """(payload, m_hat (R, *local)) of a blocked stochastic quantizer on
    the rows of m, each row compressed as its global tensor is, with no
    gathered leaf, QUANT_CHUNK elements at a time. A block's scale is the
    compressor's over it, taken on the rank's slice where every block
    lies inside it ("local" mode) or, where blocks cross the slices, from
    the ranks' parts of it (the (R, global blocks) partial maxima, or
    sums of squares, all-reduced over the cuts' groups); each element is
    rounded where it lies, with its own draw, by the compressor's own
    arithmetic (`compressors._stochastic_round_codes`, its
    dequantization). With `payload` ("local" mode only) the slice's
    blocks come back as `compress_rows` lays them out, else None.
    `draws` (R, local numel): the slice's draws, or a `DrawChunks` making
    them as the chunks read them."""
    R, b, levels = m.shape[0], compressor.per_block, compressor.levels
    flat = m.reshape(R, -1)
    k, dev = flat.shape[1], m.device
    local = shard.mode(compressor) == "local"
    assert local or not payload, "a payload needs every block local"
    l2 = compressor.norm == "l2"
    chunk = max(b, QUANT_CHUNK // b * b)
    if not local:
        nb = -(-math.prod(shard.shape) // b)
        part = torch.zeros((R, nb), dtype=torch.float32, device=dev)
        for a in range(0, k, chunk):
            z = min(k, a + chunk)
            gid = torch.div(_global_positions(shard, a, z, dev), b,
                            rounding_mode="floor").expand(R, -1)
            f = flat[:, a:z].float()
            if l2:
                part.scatter_add_(1, gid, f.square())
            else:
                part.scatter_reduce_(1, gid, f.abs(), "amax")
        shard.reduce(part, None if l2 else torch.distributed.ReduceOp.MAX)
        if l2:
            part.sqrt_()
    out = torch.empty_like(flat)
    codes = scales = None
    if payload:
        codes = torch.empty((R, k // b, b), dtype=torch.int8, device=dev)
        scales = torch.empty((R, k // b, 1), dtype=torch.float32, device=dev)
    for a in range(0, k, chunk):
        z = min(k, a + chunk)
        f = flat[:, a:z].float()
        if local:   # the chunk is whole blocks of the slice
            f = f.reshape(R, -1, b)
            s = compressor._scale(f) + C._EPS
        else:
            gid = torch.div(_global_positions(shard, a, z, dev), b,
                            rounding_mode="floor")
            s = part.gather(1, gid.expand(R, -1)) + C._EPS
        u = (draws.take(a, z) if isinstance(draws, DrawChunks)
             else draws[:, a:z])
        q = C._stochastic_round_codes(f, s, levels, u.reshape(f.shape))
        out[:, a:z] = C._dequantize_codes({"codes": q, "scale": s},
                                          (R, z - a), m.dtype, levels)
        if payload:
            codes[:, a // b:z // b] = q
            scales[:, a // b:z // b] = s
    pl = {"codes": codes, "scale": scales} if payload else None
    return pl, out.reshape(m.shape)


def _compress_sharded(compressor, m, rand, generator, shard, stream=None,
                      payload: bool = True):
    """(payload, m_hat) of the rows of m (R, *local), each compressed as
    its global tensor is (see `LeafShard.mode`); `rand` the global draws,
    else the rows' tile streams (`stream`) or the generator(s). A blocked
    quantizer runs on the slices (`_blocked_slices`) in "local" mode, and
    in "gather" mode too where the caller reads no `payload` (None is
    returned for it); the rest of "gather" mode compresses the gathered
    leaf."""
    R = m.shape[0]
    mode = shard.mode(compressor)
    if (getattr(compressor, "per_block", 0) > 0
            and isinstance(compressor, (C.StochasticQuant, C.TracedQuant))
            and (mode == "local" or not payload)):
        return _blocked_slices(
            compressor, m, _slice_draws(compressor, R, shard, rand,
                                        generator, stream, m.device),
            shard, payload and mode == "local")
    if mode == "gather":
        out = _gathered_slices(compressor, m, rand, generator, shard, stream)
        if out is not None:
            return out
        full = shard.gather(m)
        n = math.prod(shard.shape)
        tiles = None if rand is not None else stream_draws(
            compressor, R, n, stream, m.device)
        rand = _sharded_draws(compressor, R, shard,
                              rand if tiles is None else tiles, generator,
                              m.device)
        outs = [compressor.compress(full[i], None if rand is None
                                    else rand[i],
                                    _row_generator(generator, R, i))
                for i in range(R)]
        payload = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        m_hat = decompress_rows(compressor, payload, m.shape[1:], m.dtype,
                                shard)
        return payload, m_hat
    if mode == "scale":
        f = m.reshape(R, -1).float()
        if compressor.norm == "l2":
            s = torch.sqrt(shard.reduce(f.square().sum(-1, keepdim=True)))
        else:
            s = shard.reduce(f.abs().amax(-1, keepdim=True),
                             torch.distributed.ReduceOp.MAX)
        s = s + C._EPS
        u = _slice_draws(compressor, R, shard, rand, generator, stream,
                         m.device)
        if isinstance(u, DrawChunks):
            u = u.take(0, f.shape[1])
        codes = C._stochastic_round_codes(f, s, compressor.levels, u)
        payload = {"codes": codes[:, None, :], "scale": s[:, None, :]}
    else:       # "local": the identity
        payload = {"values": m}
    return payload, decompress_rows(compressor, payload, m.shape[1:],
                                    m.dtype, shard)


def compress_with_ef_stacked(compressor, message, e_prev, rand=None,
                             generator=None, *, use_ef: bool = True,
                             allow_fused: bool = True, shard=None,
                             stream=None, payload: bool = True):
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
    draws. `stream` (one seed a row, `leaf_stream`): the rows are a
    leaf's, whose draws, above one tile, come from its tile streams
    (`DrawChunks`) instead of the generator. `payload=False`: the caller
    reads m_hat alone (one worker, a mean of the m_hats), and a sharded
    leaf's blocked quantizer runs on the rank's slice without gathering
    the leaf (its payload comes back None)."""
    R = message.shape[0]
    n = message[0].numel()
    if shard is not None and not shard.cuts:
        shard = None
    if rand is None and shard is None:
        rand = stream_draws(compressor, R, n, stream, message.device)
    if shard is not None and not (
            use_ef and allow_fused and len(shard.shape) == 1
            and fused_compatible(compressor, message.new_empty(
                shard.shape, device="meta"))):
        m = message + e_prev.to(message.dtype) if use_ef else message
        pl, m_hat = _compress_sharded(compressor, m, rand, generator,
                                      shard, stream, payload)
        if use_ef and pl is None:   # m is this call's own, and no payload
            e_new = m.sub_(m_hat).to(e_prev.dtype)     # holds it
        else:
            e_new = (m - m_hat).to(e_prev.dtype) if use_ef else e_prev
        return pl, m_hat, e_new
    if shard is not None and not fused_compatible(compressor, message[0]):
        # the slices cut the flat leaf's scale rows: the fused kernel runs
        # on the gathered leaf, as the JAX package runs it on the global one
        payload, m_hat, e_new = compress_with_ef_stacked(
            compressor, shard.gather(message), shard.gather(e_prev), rand,
            generator, stream=stream)
        return payload, shard.slice(m_hat), shard.slice(e_new)
    per_worker = isinstance(generator, (list, tuple))
    if shard is not None:
        # a flat sharded leaf the fused kernel takes (as the JAX package
        # takes the global one): its scale rows lie inside each slice
        local = None if rand is not None else stream_draws(
            compressor, R, math.prod(shard.shape), stream, message.device,
            shard)
        rand = local if local is not None else shard.take(_sharded_draws(
            compressor, R, shard, rand, generator, message.device))
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
