"""Continuous-batching serving engine (counterpart of `repro.serve.engine`).

One fixed-shape decode step serves `max_batch` slots; requests join and
leave at decode-step granularity. Prefill runs per request at a *floor*
bucket (the largest configured bucket that fits inside the prompt) and the
remaining prompt tail is fed through the shared decode step one token per
step, so no pad token ever enters the model.

Token accounting per request (prompt length P, floor bucket F <= P,
max_new G): prefill covers positions 0..F-1; decode steps consume
prompt[F..P-1] then the sampled tokens, writing positions F..P+G-2; the
step that consumes prompt[P-1] (or the prefill itself when F == P)
yields generated token 0, so a request costs (P-F) + (G-1) decode steps
and P+G-1 KV positions. The sequential baseline (baseline.py) runs the
same model functions at batch 1 over a dense cache.

Where the JAX engine jits its pieces and threads the cache functionally,
this one runs eagerly and writes the paged cache (its own tensors) in
place: table parking, prefill insertion and the decode step's K/V.
Greedy tokens of all live rows are taken on the device and cross to the
host in one transfer a step. Sampling at temperature > 0 draws from a
`torch.Generator` keyed by (seed, rid, token index), independent of
scheduling order; it cannot replay JAX's threefry draws, so sampled
tokens agree with the port's own sequential baseline, not with JAX's.

``attn_impl`` selects the paged decode attention: "gather" (the default,
as in the JAX engine) or "kernel", B3 as a CUDA kernel (the counterpart of
the JAX engine's "pallas"); on CPU tensors "kernel" runs B3's plain
version.

With ``compression=`` the weights are quantized at construction (B1 once
a bucket, `quantized_weights.quantize_weights`, seeded by ``seed``) and
the engine keeps only the payload: every prefill and decode step rebuilds
the weights from it (dequant-on-read, as the JAX engine's jitted steps
do), and drops them when the step ends.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import layers
from repro_torch.models import model as lm

from .kv_cache import (
    BlockAllocator,
    ServeConfig,
    ServeError,
    check_model_servable,
    init_paged_cache,
    plan_request,
)
from .quantized_weights import _mix64, dequantize_weights, quantize_weights

_WEIGHTS = {"float32": "f32", "bfloat16": "bf16"}


class _Weights:
    """The serving weights: the params as given, or a quantized payload
    rebuilt into params at every `params()` call (dequant-on-read)."""

    def __init__(self, cfg, params, compression, seed):
        self.cfg = cfg
        self.meta = None
        if compression is not None:
            self.meta, self.stored = quantize_weights(params, compression,
                                                      seed=seed)
        else:
            self.stored = params

    def params(self):
        if self.meta is None:
            return self.stored
        return dequantize_weights(self.meta, self.stored)

    def describe(self) -> str:
        if self.meta is None:
            return _WEIGHTS[self.cfg.param_dtype]
        return self.meta.describe()


# --------------------------------------------------------------------------- #
# requests
# --------------------------------------------------------------------------- #
@dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int
    temperature: float = 0.0
    stop_token: Optional[int] = None
    arrival: float = 0.0            # virtual seconds (load generator clock)


def draw_seed(seed: int, rid: int, index: int) -> int:
    """The generator seed of token `index` of request `rid`."""
    return _mix64(_mix64(_mix64(seed) ^ rid) ^ index) >> 1


def sample_token(logits_row, temperature: float, rid: int, index: int,
                 seed: int) -> int:
    """Shared by the engine and the sequential baseline so both draw the
    same token from the same logits: greedy argmax (first index on ties)
    at temperature <= 0, else a categorical draw (Gumbel-max, as
    `jax.random.categorical`) from a generator keyed by (seed, rid,
    index), on the CPU so the draw does not depend on the device."""
    if temperature <= 0.0:
        return int(torch.argmax(logits_row))
    gen = torch.Generator(device="cpu").manual_seed(
        draw_seed(seed, rid, index))
    row = logits_row.detach().float().cpu() / temperature
    u = torch.rand(row.shape, generator=gen)
    return int(torch.argmax(row - torch.log(-torch.log(u))))


# --------------------------------------------------------------------------- #
# cache tree surgery, in place on the engine's paged cache
# --------------------------------------------------------------------------- #
def _walk(paged, pre, attn_fn, state_fn, stacked):
    """Parallel walk of the paged cache and a prefill cache; attn leaves
    are dicts with a "table", everything else recurses down to
    recurrent-state tensors."""
    if isinstance(paged, dict):
        if "table" in paged:
            return attn_fn(paged, pre, stacked)
        return {k: _walk(paged[k], None if pre is None else pre[k],
                         attn_fn, state_fn, stacked) for k in paged}
    if isinstance(paged, list):
        return [_walk(a, None if pre is None else b, attn_fn, state_fn,
                      stacked)
                for a, b in zip(paged, pre if pre is not None else paged)]
    return state_fn(paged, pre, stacked)


def _map_cache(cache, attn_fn, state_fn, pre=None):
    out = {"scan": None, "tail": []}
    if cache.get("scan") is not None:
        out["scan"] = _walk(cache["scan"],
                            None if pre is None else pre["scan"],
                            attn_fn, state_fn, stacked=True)
    for i, leaf in enumerate(cache.get("tail", [])):
        out["tail"].append(_walk(
            leaf, None if pre is None else pre["tail"][i],
            attn_fn, state_fn, stacked=False))
    return out


def _park_tables(cache, active):
    """Point every inactive slot's table row at the scratch block, so the
    fixed-shape decode's writes for vacated slots never land in a block
    the allocator has handed to a live request. `active`: (B,) bool on the
    cache's device."""
    def attn(leaf, _, stacked):
        mask = ~active[None, :, None] if stacked else ~active[:, None]
        leaf["table"].masked_fill_(mask, 0)
        return leaf

    return _map_cache(cache, attn, lambda s, _, st: s)


def _insert_prefill(cache, pre, slot, block_ids, row, block_size):
    """Scatter a batch-1 prefill cache into `slot`: K/V into the request's
    pool blocks (whole blocks: buckets are block-aligned), the block map
    into the slot's table row, recurrent states into the slot's lane."""
    nb = block_ids.shape[0]

    def attn(leaf, p, stacked):
        k, v = p["k"], p["v"]
        if stacked:
            ns = k.shape[0]
            leaf["k"][:, block_ids] = k[:, 0].reshape(ns, nb, block_size,
                                                      *k.shape[3:])
            leaf["v"][:, block_ids] = v[:, 0].reshape(ns, nb, block_size,
                                                      *v.shape[3:])
            leaf["table"][:, slot] = row
        else:
            leaf["k"][block_ids] = k[0].reshape(nb, block_size, *k.shape[2:])
            leaf["v"][block_ids] = v[0].reshape(nb, block_size, *v.shape[2:])
            leaf["table"][slot] = row
        return leaf

    def state(leaf, p, stacked):
        if stacked:
            leaf[:, slot] = p[:, 0]
        else:
            leaf[slot] = p[0]
        return leaf

    return _map_cache(cache, attn, state, pre=pre)


def _claim_slot(cache, slot, row):
    """Admission without prefill (prompt shorter than every bucket): write
    the block map and zero the slot's recurrent state lanes."""
    def attn(leaf, _, stacked):
        if stacked:
            leaf["table"][:, slot] = row
        else:
            leaf["table"][slot] = row
        return leaf

    def state(leaf, _, stacked):
        (leaf[:, slot] if stacked else leaf[slot]).zero_()
        return leaf

    return _map_cache(cache, attn, state)


# --------------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------------- #
@dataclass
class _Slot:
    rid: int
    to_feed: List[int]              # prompt tokens not yet consumed
    blocks: List[int]
    max_new: int
    temperature: float
    stop_token: Optional[int]
    last_tok: int = 0
    emitted: int = 0


class Engine:
    """Continuous-batching decode over a paged KV cache.

    submit() enqueues; step() admits whatever fits (FIFO: the head blocks
    the queue until slots AND blocks are free, a deliberate no-starvation
    policy), runs ONE fixed-shape decode for all slots, samples, and
    releases finished requests' blocks back to the free list. The engine
    runs on the device of ``params["embed"]``.
    """

    def __init__(self, cfg, serve_cfg: ServeConfig, params, *,
                 compression=None, seed: int = 0, attn_impl: str = "gather"):
        check_model_servable(cfg)
        if attn_impl not in ("gather", "kernel"):
            raise ServeError(f"attn_impl must be gather|kernel, "
                             f"got {attn_impl!r}")
        self.cfg = cfg
        self.scfg = serve_cfg
        self.attn_impl = attn_impl
        self.device = params["embed"].device
        self.weights = _Weights(cfg, params, compression, seed)

        self.cache = init_paged_cache(cfg, serve_cfg, device=self.device)
        self.alloc = BlockAllocator(serve_cfg.num_blocks)
        self.slots: List[Optional[_Slot]] = [None] * serve_cfg.max_batch
        self._lengths = [0] * serve_cfg.max_batch
        self.queue: deque = deque()
        self.outputs: Dict[int, List[int]] = {}
        self.completed = set()
        self._seed = seed

        self.steps = 0
        self.peak_occupancy = 0.0

    def _tensor(self, array):
        return torch.as_tensor(array, device=self.device)

    # -- model calls -------------------------------------------------------- #
    def _decode(self, tokens, lengths, active):
        prev = layers.set_paged_attn_impl(self.attn_impl)
        try:
            _park_tables(self.cache, active)
            logits, self.cache = lm.decode_step_paged(
                self.weights.params(), self.cfg, tokens, self.cache,
                lengths)
        finally:
            layers.set_paged_attn_impl(prev)
        return logits

    def _prefill(self, prompt):
        return lm.prefill(self.weights.params(), self.cfg,
                          self._tensor(np.asarray([prompt], np.int64)))

    # -- request lifecycle ------------------------------------------------- #
    def submit(self, req: Request) -> None:
        if req.rid in self.outputs:
            raise ServeError(f"duplicate request id {req.rid}")
        bucket, n_blocks = plan_request(len(req.prompt), req.max_new,
                                        self.scfg)
        self.outputs[req.rid] = []
        self.queue.append((req, bucket, n_blocks))

    def _sample(self, logits_row, s: _Slot) -> int:
        return sample_token(logits_row, s.temperature, s.rid, s.emitted,
                            self._seed)

    def _finish(self, idx: int, s: _Slot) -> None:
        self.alloc.free(s.blocks)
        self.slots[idx] = None
        self._lengths[idx] = 0
        self.completed.add(s.rid)

    def _try_admit(self) -> None:
        while self.queue:
            req, bucket, n_blocks = self.queue[0]
            P = len(req.prompt)
            if bucket == P and req.max_new == 1:
                # generated token 0 falls out of the prefill logits: the
                # request completes without ever occupying a decode slot
                self.queue.popleft()
                logits, _ = self._prefill(req.prompt)
                tok = sample_token(logits[0], req.temperature, req.rid, 0,
                                   self._seed)
                self.outputs[req.rid].append(tok)
                self.completed.add(req.rid)
                continue
            idx = next((i for i, s in enumerate(self.slots) if s is None),
                       None)
            if idx is None or n_blocks > self.alloc.free_blocks:
                return                        # FIFO: head blocks the queue
            self.queue.popleft()
            self._admit(req, bucket, n_blocks, idx)

    def _admit(self, req: Request, bucket: int, n_blocks: int,
               idx: int) -> None:
        blocks = self.alloc.alloc(n_blocks)
        row = np.zeros(self.scfg.max_blocks_per_seq, np.int32)
        row[:n_blocks] = blocks
        row = self._tensor(row)
        s = _Slot(rid=req.rid, to_feed=list(req.prompt[bucket:]),
                  blocks=blocks, max_new=req.max_new,
                  temperature=req.temperature, stop_token=req.stop_token)
        if bucket > 0:
            logits, pre = self._prefill(req.prompt[:bucket])
            nb_prefill = bucket // self.scfg.block_size
            _insert_prefill(self.cache, pre, idx,
                            self._tensor(np.asarray(blocks[:nb_prefill],
                                                    np.int64)),
                            row, self.scfg.block_size)
            if not s.to_feed:               # bucket == P: token 0 is here
                tok = self._sample(logits[0], s)
                self.outputs[s.rid].append(tok)
                s.emitted = 1
                if tok == s.stop_token:     # max_new == 1 handled pre-slot
                    self.alloc.free(blocks)
                    self.completed.add(s.rid)
                    return
                s.last_tok = tok
        else:
            _claim_slot(self.cache, idx, row)
        self._lengths[idx] = bucket
        self.slots[idx] = s
        self.peak_occupancy = max(self.peak_occupancy,
                                  self.alloc.occupancy())

    def step(self) -> bool:
        """Admit + one batched decode + sample/release. Returns False when
        there was nothing to do (no live slots after admission). Ends with
        the step's tokens on the host (a device sync)."""
        self._try_admit()
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return False
        B = self.scfg.max_batch
        tokens = np.zeros((B, 1), np.int64)
        active = np.zeros((B,), bool)
        for i in live:
            s = self.slots[i]
            tokens[i, 0] = s.to_feed[0] if s.to_feed else s.last_tok
            active[i] = True
        lengths = np.asarray(self._lengths, np.int32)
        logits = self._decode(self._tensor(tokens), self._tensor(lengths),
                              self._tensor(active))
        self.steps += 1
        # the rows that emit a token this step, greedy ones in one transfer
        emit = [i for i in live if len(self.slots[i].to_feed) <= 1]
        greedy = torch.argmax(logits, dim=-1).tolist()
        drawn = [i for i in emit if self.slots[i].temperature > 0.0]
        rows = dict(zip(drawn, logits[drawn].cpu())) if drawn else {}
        for i in live:
            s = self.slots[i]
            self._lengths[i] += 1
            if s.to_feed:
                s.to_feed.pop(0)
                if s.to_feed:
                    continue                 # still consuming the prompt
            tok = self._sample(rows[i], s) if i in rows else greedy[i]
            self.outputs[s.rid].append(tok)
            s.emitted += 1
            if s.emitted >= s.max_new or tok == s.stop_token:
                self._finish(i, s)
            else:
                s.last_tok = tok
        return True

    # -- driving ----------------------------------------------------------- #
    @property
    def idle(self) -> bool:
        return not self.queue and all(s is None for s in self.slots)

    def run(self, requests) -> Dict[int, List[int]]:
        """Drain a batch of requests (arrival times ignored: closed loop);
        returns {rid: generated tokens}."""
        for r in sorted(requests, key=lambda r: r.arrival):
            self.submit(r)
        while not self.idle:
            if not self.step() and self.queue:
                raise ServeError(
                    "admission deadlock: queue non-empty but nothing "
                    "admitted with all slots free")
        return self.outputs

    def stats(self) -> dict:
        return {
            "steps": self.steps,
            "occupancy": self.alloc.occupancy(),
            "peak_occupancy": self.peak_occupancy,
            "live_tokens": sum(self._lengths),
            "weights": self.weights.describe(),
        }
