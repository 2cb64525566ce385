"""Load-time weight quantization for serving (counterpart of
`repro.serve.quantized_weights`).

The `Compression` component that describes wire compression describes the
serving weights' precision too: the `repro_torch.comm` bucket layout cuts
the parameter tree into flat (R, 1024) buckets, `plan_comm` gives each
bucket its bit width (uniform / size_tiered / delta_budget), and B1
(`kernels.quantize.quantize_ef_flat`) makes the int8 codes, once a
bucket at load, with a zero residual: plain stochastic rounding.

Honoured `Compression` fields (the JAX package's contract):
  compressor  a linf `StochasticQuant` (any per_block); the base width.
              Scales are one per 1024-element row of a bucket whatever
              per_block says.
  plan        "none" -> uniform, else the planner policy as given.
  bucket_mb   f32 MiB per weight bucket.
  budget_mb   the delta_budget target, in payload MiB of weights.
Ignored: error_feedback / ef_dtype and adaptive. Buckets the plan leaves
at identity (size_tiered's small-tensor tier) stay raw f32.

Where the JAX package packs every bucket at once, this one packs, draws
and quantizes one bucket at a time, so that at full width the f32
operands of only the largest bucket are alive at once. Each bucket's
draws come from a `torch.Generator` on the parameters' device seeded
from (seed, bucket id): the same seed gives a bit-identical payload.
JAX's threefry draws cannot be replayed, so `draws=` injects them for
parity.

`dequantize_weights` rebuilds the tree from the payload; the serving
engine calls it at every step (dequant-on-read) and keeps only the
payload between steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.comm.buckets import BucketLayout, layout_for_params
from repro_torch.comm.planner import CommPlan, plan_comm
from repro_torch.core import compressors as C
from repro_torch.core.error_feedback import _level_divisor
from repro_torch.kernels.quantize import bucket_tile_shape, quantize_ef_flat

from .kv_cache import ServeError


@dataclass(frozen=True)
class WeightQuantMeta:
    """The static recipe for rebuilding the parameter tree from a payload."""
    layout: BucketLayout
    plan: CommPlan
    skeleton: Any                       # the tree, leaf i replaced by i
    leaf_shapes: Tuple[Tuple[int, ...], ...]
    leaf_dtypes: Tuple[torch.dtype, ...]
    levels: Tuple[int, ...]             # per bucket; 0 = raw f32 bucket
    bits: Tuple[int, ...]               # per bucket; 32 = raw

    @property
    def payload_bytes(self) -> int:
        total = 0
        for b in self.layout.buckets:
            if self.levels[b.bid]:
                rows, _, _ = bucket_tile_shape(b.size)
                total += b.size + 4 * rows          # int8 codes + f32 scales
            else:
                total += 4 * b.size
        return total

    @property
    def f32_bytes(self) -> int:
        return 4 * sum(b.size for b in self.layout.buckets)

    def describe(self) -> str:
        mix: Dict[int, int] = {}
        for bt in self.bits:
            mix[bt] = mix.get(bt, 0) + 1
        bits = " ".join(f"{b}bx{n}" for b, n in sorted(mix.items()))
        return (f"weights[{len(self.layout.buckets)} buckets {bits}] "
                f"{self.payload_bytes / 2**20:.2f} MiB "
                f"({self.payload_bytes / max(self.f32_bytes, 1):.2%} of f32)")


def _resolve_plan(params, compression) -> Tuple[BucketLayout, CommPlan]:
    base = C.get(compression.compressor)
    if not (isinstance(base, C.StochasticQuant) and base.norm == "linf"):
        raise ServeError(
            f"weight quantization needs a linf StochasticQuant compressor "
            f"(int8-codes + scales payload); got "
            f"{compression.compressor!r}. l2/sign/topk compressors have no "
            f"weight-precision meaning here")
    layout = layout_for_params(
        params, bucket_bytes=int(compression.bucket_mb * 2**20))
    policy = compression.plan
    if policy == "none":
        policy = "uniform"
    plan = plan_comm(layout, compression.compressor, policy,
                     budget_bytes=int(compression.budget_mb * 2**20))
    return layout, plan


def _bucket_levels(plan: CommPlan, layout: BucketLayout) -> Tuple[int, ...]:
    """Per-bucket level count; 0 marks a raw (identity) bucket."""
    levels = []
    for b in layout.buckets:
        comp = C.get(plan.compressor_for(b.bid))
        if isinstance(comp, C.StochasticQuant) and comp.norm == "linf":
            levels.append(comp.levels)
        elif comp.name == "identity":
            levels.append(0)
        else:
            raise ServeError(
                f"weight plan assigned non-linf compressor {comp.name!r} "
                f"to bucket {b.bid}; only linf quant rungs and identity "
                f"are valid serving weight precisions")
    return tuple(levels)


def _mix64(x: int) -> int:
    """splitmix64's finalizer: a well-spread 64-bit value of x."""
    x &= (1 << 64) - 1
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return x ^ (x >> 31)


def _bucket_seed(seed: int, bid: int) -> int:
    """The generator seed of bucket `bid`'s draws: a function of (seed,
    bid) alone, as the JAX package folds the bucket id into its key.
    Mixed so that every bit of both reaches the low 32 bits, all that a
    CPU generator keeps."""
    return _mix64(_mix64(seed) ^ bid) >> 1


def _pack_bucket(bucket, leaves):
    """One bucket's leaves as a zero-padded flat f32 tensor: one copy a
    leaf into its slice, no other temporary."""
    dev = leaves[bucket.slots[0].index].device
    flat = torch.empty((bucket.size,), dtype=torch.float32, device=dev)
    for s in bucket.slots:
        flat[s.offset:s.offset + s.size].copy_(leaves[s.index].reshape(-1))
    flat[bucket.used:].zero_()
    return flat


def _draw(draws, seed, bid, n, device):
    """Bucket `bid`'s n uniform draws: from `draws` (a mapping bid ->
    array, or a callable (bid, n) -> array) when given, else from a
    generator on `device` seeded with `_bucket_seed(seed, bid)`."""
    if draws is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(_bucket_seed(seed, bid))
        return torch.rand((n,), generator=gen, device=device)
    r = draws(bid, n) if callable(draws) else draws[bid]
    if not isinstance(r, torch.Tensor):
        r = torch.from_numpy(np.array(r, np.float32))
    r = r.to(device=device, dtype=torch.float32).reshape(-1)
    if r.shape != (n,):
        raise ValueError(f"quantize_weights: bucket {bid} needs {n} draws, "
                         f"got {tuple(r.shape)}")
    return r


def quantize_weights(params, compression, *, seed: int = 0, draws=None):
    """One-shot load-time quantization: B1 once a non-identity bucket.

    Returns (meta, payload): payload maps "b<bid>" to {"codes" (n,) int8,
    "scales" (R,) f32} or, for an identity bucket, {"flat" (n,) f32}, on
    the parameters' device; meta is the recipe `dequantize_weights`
    follows."""
    _, leaves = T.flatten(params)
    layout, plan = _resolve_plan(params, compression)
    levels = _bucket_levels(plan, layout)
    bits = tuple(
        32 if lv == 0 else C.get(plan.compressor_for(b.bid)).bits
        for lv, b in zip(levels, layout.buckets))
    counter = iter(range(len(leaves)))
    meta = WeightQuantMeta(
        layout=layout, plan=plan,
        skeleton=T.tree_map(lambda _: next(counter), params),
        leaf_shapes=tuple(tuple(x.shape) for x in leaves),
        leaf_dtypes=tuple(x.dtype for x in leaves),
        levels=levels, bits=bits)

    payload = {}
    for b in layout.buckets:
        flat = _pack_bucket(b, leaves)
        if levels[b.bid] == 0:
            payload[f"b{b.bid}"] = {"flat": flat}
            continue
        rand = _draw(draws, seed, b.bid, b.size, flat.device)
        codes, scales, _ = quantize_ef_flat(
            flat, torch.zeros_like(flat), rand, levels=levels[b.bid])
        payload[f"b{b.bid}"] = {"codes": codes, "scales": scales}
        del flat, rand
    return meta, payload


def dequantize_weights(meta: WeightQuantMeta, payload):
    """Rebuild the parameter tree from a payload: per bucket, codes times
    the row's step scale / levels (IEEE division by a device tensor, as
    the JAX package divides), written in one pass into a buffer of the
    leaves' dtype whose slices are the leaves. Two launches a quantized
    bucket (the step, the product), one a raw bucket whose leaves are not
    f32, none a raw f32 one (its leaves are views of the payload)."""
    leaves = [None] * len(meta.leaf_shapes)
    for b in meta.layout.buckets:
        entry = payload[f"b{b.bid}"]
        dtypes = {meta.leaf_dtypes[s.index] for s in b.slots}
        dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32
        if meta.levels[b.bid] == 0:
            flat = entry["flat"].to(dtype)
        else:
            codes, scales = entry["codes"], entry["scales"]
            rows, cols, _ = bucket_tile_shape(b.size)
            step = scales[:, None] / _level_divisor(scales.device,
                                                    meta.levels[b.bid])
            flat = torch.empty((rows, cols), dtype=dtype,
                               device=codes.device)
            # int8 x f32 computes in f32 and rounds once to `dtype`, as
            # the reference's product and its cast at unpack
            torch.mul(codes.view(rows, cols), step, out=flat)
            flat = flat.view(-1)
        for s in b.slots:
            leaves[s.index] = flat[s.offset:s.offset + s.size].view(
                meta.leaf_shapes[s.index]).to(meta.leaf_dtypes[s.index])
    return T.tree_map(lambda i: leaves[i], meta.skeleton)
