"""Static gradient bucketing (counterpart of `repro.comm.buckets`).

The parameter tree is flattened (sorted-key order) into a few contiguous
f32 buckets, each padded to a multiple of n_workers·1024, so every bucket
tiles as (R, 1024) rows for the fused quantize+EF kernel and chunks evenly
over the workers. The layout must equal the JAX package's element for
element: it decides which elements share a scale row. Leaves whose spec
shards a dimension stay on the per-tensor path (``skipped``); bucketing
them at their local shard shape (the JAX package's shard-aware mode)
arrives with FSDP (ROADMAP §A slice 5).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch import tree as T

LANE = 128      # TPU lane width; kept so the layouts match the JAX package
SUBLANE = 8     # LANE*SUBLANE = 1024 = one scale row of the fused kernel

DEFAULT_BUCKET_BYTES = 4 << 20  # 4 MiB of f32 per bucket before closing it


@dataclass(frozen=True)
class LeafSlot:
    """One tensor's place in the layout; ``bucket == -1``: skipped."""
    index: int                  # position in flatten order
    path: str                   # jax-style key path, e.g. "['gen']['fc']['w']"
    shape: Tuple[int, ...]
    size: int
    bucket: int
    offset: int                 # element offset inside the bucket
    local: bool = False         # a shard-aware slot (JAX package only)


@dataclass(frozen=True)
class Bucket:
    bid: int
    size: int                   # padded length (elements), % align == 0
    used: int                   # sum of member leaf sizes
    slots: Tuple[LeafSlot, ...]

    @property
    def padding(self) -> int:
        return self.size - self.used


@dataclass(frozen=True)
class BucketLayout:
    buckets: Tuple[Bucket, ...]
    skipped: Tuple[LeafSlot, ...]
    n_workers: int
    align: int
    n_leaves: int

    @property
    def bucketed_elems(self) -> int:
        return sum(b.used for b in self.buckets)

    @property
    def padded_elems(self) -> int:
        return sum(b.size for b in self.buckets)

    @property
    def pad_fraction(self) -> float:
        tot = self.padded_elems
        return (tot - self.bucketed_elems) / tot if tot else 0.0

    def describe(self) -> str:
        return (f"{len(self.buckets)} buckets ({self.bucketed_elems} elems, "
                f"{self.pad_fraction:.1%} pad), {len(self.skipped)} leaves "
                f"on the per-tensor path")


def _spec_entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def _spec_shards_locally(spec, shape) -> bool:
    """True if any dim is partitioned over a mesh axis."""
    if spec is None:
        return False
    return any(_spec_entry_axes(spec[ax])
               for ax in range(min(len(spec), len(shape))))


def build_layout(
    shapes_tree,
    specs_tree=None,
    n_workers: int = 1,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> BucketLayout:
    """Greedy first-fit bucketing in flatten order. ``shapes_tree`` is a
    nested dict of shape tuples; ``specs_tree`` (optional) the matching
    per-dimension mesh-axis tuples."""
    paths, shapes = T.flatten(shapes_tree)
    specs = ([None] * len(shapes) if specs_tree is None
             else T.flatten_up_to(paths, specs_tree))
    align = n_workers * LANE * SUBLANE
    cap = max(1, bucket_bytes // 4)          # elements of f32 per bucket

    buckets, skipped = [], []
    cur_slots, cur_used = [], 0

    def close():
        nonlocal cur_slots, cur_used
        if not cur_slots:
            return
        bid = len(buckets)
        size = -(-cur_used // align) * align
        buckets.append(Bucket(bid=bid, size=size, used=cur_used,
                              slots=tuple(
                                  LeafSlot(s.index, s.path, s.shape,
                                           s.size, bid, s.offset, s.local)
                                  for s in cur_slots)))
        cur_slots, cur_used = [], 0

    for idx, (shape, path, spec) in enumerate(zip(shapes, paths, specs)):
        shape = tuple(shape)
        name = T.keystr(path)
        if _spec_shards_locally(spec, shape):
            skipped.append(LeafSlot(idx, name, shape, math.prod(shape), -1,
                                    0))
            continue
        size = math.prod(shape)
        if cur_used and cur_used + size > cap:
            close()
        cur_slots.append(LeafSlot(idx, name, shape, size, -1, cur_used))
        cur_used += size
    close()

    return BucketLayout(buckets=tuple(buckets), skipped=tuple(skipped),
                        n_workers=n_workers, align=align, n_leaves=len(shapes))


def _lead(x, slot):
    """The leading (worker) dims of leaf `x` in front of its slot shape."""
    return tuple(x.shape[:x.dim() - len(slot.shape)])


def pack(layout: BucketLayout, leaves, dtype=torch.float32):
    """One zero-padded flat tensor per bucket from the flat leaf list. A
    leaf stacked over workers, (W, *shape), packs into (W, size). The
    buckets are contiguous views of one `pack_concat` buffer."""
    if not layout.buckets:
        return []
    first = layout.buckets[0].slots[0]
    return split_concat(layout, pack_concat(layout, leaves, dtype),
                        _lead(leaves[first.index], first))


def pack_concat(layout: BucketLayout, leaves, dtype=torch.float32):
    """All buckets in ONE flat tensor, made by one copy: bucket after
    bucket, each a row-major (*lead, size) block for leaves with leading
    (worker) dims `lead`. With no worker axis, or one worker, the buckets
    lie back to back. `split_concat` cuts it into `pack`'s buckets."""
    first = layout.buckets[0].slots[0]
    lead = _lead(leaves[first.index], first)
    W = math.prod(lead)
    rows = {s.index: leaves[s.index].to(dtype).reshape(W, s.size)
            for b in layout.buckets for s in b.slots}
    pad = torch.zeros((max(b.padding for b in layout.buckets),), dtype=dtype,
                      device=leaves[first.index].device)
    parts = []
    for b in layout.buckets:
        for w in range(W):
            parts += [rows[s.index][w] for s in b.slots]
            if b.padding:
                parts.append(pad[:b.padding])
    return torch.cat(parts)


def split_concat(layout: BucketLayout, flat, lead=()):
    """The buckets of a `pack_concat` tensor, in bucket order: contiguous
    views of it, (*lead, size) each."""
    out, start, W = [], 0, math.prod(lead)
    for b in layout.buckets:
        out.append(flat[start:start + W * b.size].view(
            tuple(lead) + (b.size,)))
        start += W * b.size
    return out


def unpack_into(layout: BucketLayout, flats, leaves):
    """Scatter bucket contents over a copy of the flat leaf list; skipped
    leaves keep their entries. The new leaves are views of the buckets; a
    (W, size) bucket unpacks into (W, *shape) leaves."""
    out = list(leaves)
    for b in layout.buckets:
        flat = flats[b.bid]
        for s in b.slots:
            like = leaves[s.index]
            out[s.index] = flat[..., s.offset:s.offset + s.size].reshape(
                tuple(flat.shape[:-1]) + tuple(s.shape)).to(
                like.dtype if hasattr(like, "dtype") else flat.dtype)
    return out
