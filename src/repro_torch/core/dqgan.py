"""DQGAN (paper Algorithm 2) over W workers (counterpart of
`repro.core.dqgan`).

    w_{t-1/2}^m = w_{t-1} - [η F(w_{t-3/2}^m; ξ_{t-1}^m) + e_{t-1}^m]
    g_t^m       = F(w_{t-1/2}^m; ξ_t^m)                  (each worker m)
    p_t^m       = η g_t^m + e_{t-1}^m;  p̂_t^m = Q(p_t^m);  e_t^m = p_t^m - p̂_t^m
    w_t         = w_{t-1} - (1/M) Σ_m p̂_t^m               (the server)

The JAX package maps the M workers onto its devices (a `data` mesh axis
under `shard_map`). Here they are a leading axis of size W on one device
(`core.exchange.StackedWorkers`): per-worker state (prev_grad, ef) is
stacked (W, ...), the global batch splits W ways in order, each worker
evaluates its own field at its own w_{t-1/2}, the exchange is a tensor
operation over the worker axis, and the server update runs once on the
replicated state. There is no model axis, so no leaf is sharded and the
bucket layout skips none. With one worker the exchange is
(EF-)compression, per leaf or over flat comm buckets.

Partial participation masks the sitting workers' messages and residuals
to zero, rescales q̂ by W/n and folds their messages into their EF. An
adaptive PlanFamily selects each bucket's level count by the round's
participant count, on the device, and the bucket's `TracedQuant` runs
the fused kernel's dynamic-levels variant (B2) once per bucket over all
W workers' rows; a static `*_block1024` plan runs B1 the same way. With
one worker, where every bucket runs B1 at one level count, the step packs
its buckets back to back and makes ONE B1 launch over all of their rows
(`_exchange_packed`).

State mirrors the JAX package's `DQState`, parameters keep its layout and
leaf order. Randomness comes from the trainer's `torch.Generator` on its
device, or from `draws` handed to `step` (the tests replay the JAX
package's draws that way).

The other schedules, fsdp, spmd='vmap', overlap and observability are
refused at construction, each naming the ROADMAP slice that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.comm import CommLedger
from repro_torch.comm import buckets as B
from repro_torch.configs.base import DQConfig
from repro_torch.sched.participation import round_count
from repro_torch.strategy import Strategy

from . import compressors as C
from . import exchange as X
from .error_feedback import (compress_with_ef_stacked, fused_quantize_ef,
                             packed_levels)


class DQState(NamedTuple):
    """Optimizer state; the fields of `repro.core.dqgan.DQState`. Trees are
    nested dicts in the parameters' structure; per-worker trees (prev_grad,
    ef) have a leading worker axis of size W. `step` is a Python int."""
    step: int
    params: Any
    prev_grad: Any       # F(w_{t-3/2}; ξ_{t-1}) per worker (omd, local) | None
    prev_update: Any     # q̂_{t-1} (omd, global) or Adam prev direction | None
    ef: Any              # exchange EF state dicts | None
    m: Any               # Adam first moment | None
    v: Any               # Adam second moment | None
    sched: Any = None    # schedule buffers: None for every_step
    fsdp: Any = None     # fsdp shard state: None (not ported)


class StepOutput(NamedTuple):
    state: DQState
    metrics: Any


def _unported(strategy: Strategy) -> Optional[str]:
    """What of `strategy` the port cannot run yet, and the slice that
    brings it, or None."""
    s = strategy
    checks = (
        (s.schedule.kind != "every_step",
         f"schedule {s.schedule.kind!r}", "slice 3 (schedules)"),
        (s.exchange.fsdp, "parallelism 'fsdp'", "slice 5 (FSDP)"),
        (s.exchange.spmd == "vmap", "spmd 'vmap'",
         "slice 2 (multiple workers: the spmd='vmap' path)"),
        (s.exchange.overlap, "overlap=True", "slice 3 (schedules, overlap)"),
        (s.observability.on or s.observability.spans
         or s.observability.profile,
         "observability (metrics/spans/profile)", "slice 4 (observability)"),
    )
    for hit, what, where in checks:
        if hit:
            return (f"repro_torch does not run {what} yet: it arrives with "
                    f"ROADMAP §A {where}")
    return None


def _worker_norms(tensors, W):
    """(W,) per-worker global L2 norm over a list of (W, ...) tensors."""
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros((W,))
    return torch.sqrt(sum(torch.square(t.float()).reshape(W, -1).sum(dim=1)
                          for t in tensors))


def _ef_tensors(ef):
    """Every residual tensor of an EF tree (leaf dicts and bucket dicts)."""
    out = []
    for leaf in T.leaves(ef) if isinstance(ef, dict) else []:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


def _bcast(mask, x):
    """A (W,) mask shaped to broadcast over a (W, ...) stack."""
    return mask.reshape((-1,) + (1,) * (x.dim() - 1)).to(x.dtype)


@dataclasses.dataclass
class DQGAN:
    """DQGAN trainer over `workers` stacked workers. Build once per
    (field, strategy, device, workers); then `init(params)` and
    `step(state, batch)`.

    `field_fn(params, batch, z=None, generator=None) -> (grads, metrics)`.
    `dq` carries the optimizer knobs and the strategy (or pass `strategy`
    alone, like the JAX package). `workers` > 1 stands for the JAX
    package's device count and needs `strategy.exchange.worker_axes`.
    `device` is where the generator draws: the parameters' device. On
    CUDA, constructing the trainer turns TF32 off for matmuls and
    convolutions (process-wide PyTorch flags)."""

    field_fn: Callable
    dq: Optional[DQConfig] = None
    strategy: Optional[Strategy] = None
    device: Any = "cuda"
    seed: int = 0
    workers: int = 1
    generator: torch.Generator = dataclasses.field(init=False, repr=False)
    _comm_cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                          compare=False)

    def __post_init__(self):
        if self.dq is None:
            self.dq = DQConfig.from_strategy(self.strategy or Strategy())
        elif self.strategy is not None and self.strategy != self.dq.strategy:
            raise ValueError(
                "DQGAN: dq and strategy disagree:\n  "
                + "\n  ".join(self.dq.strategy.diff(self.strategy)))
        self.strategy = self.dq.strategy
        why = _unported(self.strategy)
        if why:
            raise NotImplementedError(why)
        if self.workers < 1:
            raise ValueError(f"DQGAN: workers must be >= 1, got "
                             f"{self.workers}")
        if self.workers > 1 and not self.strategy.exchange.worker_axes:
            raise ValueError(
                "DQGAN: workers > 1 needs strategy.exchange.worker_axes "
                "(the JAX package runs one worker without them)")
        self.device = torch.device(self.device)
        if self.device.type == "cuda":
            # the reference computes in float32; cuDNN convolutions would
            # otherwise run in TF32 (about three decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)
        self._workers = X.StackedWorkers(self.workers)

    # ------------------------------------------------------------------ #
    @property
    def n_workers(self) -> int:
        return self.workers

    @property
    def compressor(self) -> C.Compressor:
        return self.strategy.compression.get()

    @property
    def uses_adam(self) -> bool:
        return self.dq.optimizer in ("adam", "oadam")

    @property
    def bucketed(self) -> bool:
        return self.strategy.compression.bucketing

    @property
    def adaptive(self) -> bool:
        return self.strategy.compression.adaptive

    @property
    def ef_dtype(self) -> torch.dtype:
        return getattr(torch, self.strategy.compression.ef_dtype)

    def _comm_full(self, params):
        """(BucketLayout, CommPlan, PlanFamily | None, device levels table
        | None), derived from leaf shapes, memoized. An adaptive
        strategy's CommPlan is its family's full-participation member."""
        shapes = T.tree_map(lambda x: tuple(x.shape), params)
        key = tuple(zip(*T.flatten(shapes)))
        hit = self._comm_cache.get(key)
        if hit is None:
            comp = self.strategy.compression
            table = None
            if self.adaptive:
                layout, family = comp.build_family(shapes, None,
                                                   self.n_workers)
                plan = family.full
                if family.n_distinct > 1:
                    # (M, n_buckets) level counts, on the device once
                    table = torch.tensor(family.levels_table(),
                                         dtype=torch.float32,
                                         device=self.device)
            else:
                layout, plan = comp.build(shapes, None, self.n_workers)
                family = None
            hit = (layout, plan, family, table)
            self._comm_cache[key] = hit
        return hit

    def _comm(self, params):
        """(BucketLayout, CommPlan): the static (full-participation) view."""
        return self._comm_full(params)[:2]

    def _family(self, params):
        """The PlanFamily, or None for a non-adaptive strategy."""
        return self._comm_full(params)[2]

    def comm_ledger(self, params) -> CommLedger:
        """Per-step wire cost of this trainer (launch.train's log fields)."""
        strat = self.strategy
        shapes = T.tree_map(lambda x: tuple(x.shape), params)
        if self.bucketed:
            layout, cplan, family, _ = self._comm_full(params)
            budget = (int(strat.compression.budget_mb * (1 << 20))
                      if strat.compression.plan == "delta_budget" else 0)
            return CommLedger.from_plan(
                layout, cplan, strat.exchange.kind, self.n_workers,
                strat.compression.compressor, family=family,
                budget_bytes=budget)
        return CommLedger.from_tree(strat.exchange.kind,
                                    strat.compression.compressor, shapes,
                                    None, self.n_workers)

    def _plans(self, params):
        """Flat list of per-leaf exchange plans (flatten order)."""
        shapes = T.tree_map(lambda x: tuple(x.shape), params)
        plans = T.flatten_up_to(T.flatten(shapes)[0],
                                self.strategy.exchange.leaf_plans(
                                    shapes, None, self.n_workers))
        if not self.bucketed:
            return plans
        layout, _ = self._comm(params)
        in_bucket = {s.index for b in layout.buckets for s in b.slots}
        return [{"strategy": "bucketed", "chunk_axis": None,
                 "fallback": False} if i in in_bucket else p
                for i, p in enumerate(plans)]

    def _validate_lr_mults(self, params):
        if not self.dq.lr_mults:
            return
        unknown = sorted(k for k, _ in self.dq.lr_mults if k not in params)
        if unknown:
            raise ValueError(
                f"lr_mults group(s) {unknown} not found in the top-level "
                f"param groups {sorted(params)}")

    def _scale_groups(self, paths, leaves):
        """Apply DQConfig.lr_mults by top-level key (TTUR)."""
        if not self.dq.lr_mults:
            return leaves
        mults = dict(self.dq.lr_mults)
        return [l * mults.get(p[0], 1.0) for p, l in zip(paths, leaves)]

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #
    def init(self, params) -> DQState:
        """Zero state around `params` (a nested dict of tensors)."""
        dq = self.dq
        W = self.n_workers
        self._validate_lr_mults(params)
        paths, leaves = T.flatten(params)
        plans = self._plans(params)
        ef_dtype = self.ef_dtype

        def zeros(x, lead=(), dtype=None):
            return torch.zeros(lead + tuple(x.shape), dtype=dtype or x.dtype,
                               device=x.device)

        def tree(fn):
            return T.unflatten(paths, [fn(x) for x in leaves])

        prev_grad = prev_update = m = v = None
        if dq.optimizer == "omd" and dq.extrapolation == "local":
            prev_grad = tree(lambda x: zeros(x, (W,)))
        if (dq.optimizer == "omd" and dq.extrapolation == "global"
                or dq.optimizer == "oadam"):
            prev_update = tree(zeros)
        if self.uses_adam:
            m, v = tree(zeros), tree(zeros)

        def ef_leaf(x, plan):
            st = {}
            if dq.error_feedback:
                st["e1"] = zeros(x, (W,), ef_dtype)
            if X.plan_has_owner_ef(plan):
                cs = list(x.shape)
                cs[plan["chunk_axis"]] //= W
                st["e2"] = torch.zeros((W, *cs), dtype=ef_dtype,
                                       device=x.device)
            return st or None

        ef = T.unflatten(paths, [ef_leaf(x, p) for x, p in zip(leaves, plans)])
        if self.bucketed:
            layout, _ = self._comm(params)
            bucket_ef = {}
            if self.strategy.exchange.owner_ef:
                for b in layout.buckets:
                    bucket_ef[str(b.bid)] = {"e2": torch.zeros(
                        (W, b.size // W), dtype=ef_dtype,
                        device=leaves[0].device)}
            ef = {"leaf": ef, "bucket": bucket_ef}
        return DQState(step=0, params=params, prev_grad=prev_grad,
                       prev_update=prev_update, ef=ef, m=m, v=v)

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    def _split_batch(self, batch):
        """The global batch split W ways in order (the JAX package's
        batch_spec P(('data',)))."""
        W = self.n_workers

        def split(x):
            if x.shape[0] % W:
                raise ValueError(f"batch of {x.shape[0]} does not split "
                                 f"over {W} workers")
            return x.reshape((W, x.shape[0] // W) + tuple(x.shape[1:]))

        stacked = {k: split(x) for k, x in batch.items()}
        return [{k: x[w] for k, x in stacked.items()} for w in range(W)]

    @torch.no_grad()
    def step(self, state: DQState, batch,
             draws: Optional[Dict[str, Any]] = None) -> StepOutput:
        """One Algorithm-2 iteration over the W workers.

        `draws` (optional) replaces the generator. Each draw holds the W
        workers' draws in worker order, split W ways like the batch: a
        (W, ...) stack, or with one worker the worker's draw itself.
          "z":    (W, B/W, latent) or (B, latent), the latent draws;
          "rand": {stream: draw}, a stream being the leaf index on the
                  per-leaf path and the bucket id on the bucketed path,
                  as the JAX package folds them into its key; for
                  two_phase with W > 1 {"phase1": (W, W, ...), "phase2":
                  (W, ...)} (see core.exchange);
          "mask": (W,) float32 participation mask of the round (partial
                  participation only)."""
        dq = self.dq
        eta = dq.lr
        W = self.n_workers
        draws = draws or {}
        rand = draws.get("rand", {})
        paths, params = T.flatten(state.params)
        plans = self._plans(state.params)
        prev_grad = (T.flatten_up_to(paths, state.prev_grad)
                     if state.prev_grad is not None else None)
        ef = state.ef
        ef_leaf_tree = ef["leaf"] if self.bucketed else ef
        ef_leaves = [dict(e) if e else {}
                     for e in T.flatten_up_to(paths, ef_leaf_tree)]
        part = self.strategy.participation.round_setup(
            W, self.generator, draws.get("mask"))

        # ---------- extrapolation to w_{t-1/2}, per worker ------------- #
        if dq.optimizer == "omd" and dq.extrapolation == "local":
            w_half = []
            for w, g, e in zip(params, prev_grad, ef_leaves):
                upd = eta * g
                if dq.error_feedback and "e1" in e:
                    upd = upd + e["e1"].to(w.dtype)
                w_half.append(w - upd.to(w.dtype))      # (W, ...)
            worker_params = [T.unflatten(paths, [x[i] for x in w_half])
                             for i in range(W)]
        else:
            if dq.optimizer == "omd":   # global: the last applied update
                w_half = [w - u.to(w.dtype) for w, u in zip(
                    params, T.flatten_up_to(paths, state.prev_update))]
            else:   # adam/oadam/sgd evaluate at the current params
                w_half = params
            worker_params = [T.unflatten(paths, w_half)] * W

        # ---------- each worker's stochastic field --------------------- #
        z = draws.get("z")
        if z is not None:
            z = z.reshape((W, -1, z.shape[-1]))
        grads_w, losses = [], []
        for i, b in enumerate(self._split_batch(batch)):
            g, met = self.field_fn(worker_params[i], b,
                                   z=None if z is None else z[i],
                                   generator=self.generator)
            grads_w.append(T.flatten_up_to(paths, g))
            losses.append(met.get("loss", torch.zeros(())))
        grads = [torch.stack(gs) for gs in zip(*grads_w)]   # (W, ...)
        if dq.message == "update" and dq.optimizer == "omd":
            message = [(eta * g).float() for g in grads]
        else:
            message = [g.float() for g in grads]

        # ---------- exchange + server update ---------------------------- #
        if part is not None:
            qhat, new_ef = self._exchange_with_participation(
                state.params, paths, message, ef, ef_leaves, plans, rand,
                part)
        else:
            qhat, new_ef = self._exchange(state.params, paths, message, ef,
                                          ef_leaves, plans, rand)
        new_params, new_m, new_v, new_prev_update = self._server_update(
            state, paths, qhat)

        new_prev_grad = None
        if prev_grad is not None:
            new_prev_grad = T.unflatten(
                paths, [g.to(o.dtype) for o, g in zip(prev_grad, grads)])

        # metrics: the mean over workers of each worker's value (the JAX
        # package's pmean)
        gn = _worker_norms(grads, W).mean()
        en = _worker_norms(_ef_tensors(new_ef), W).to(gn.device).mean()
        zero = torch.zeros((), device=gn.device)
        new_state = DQState(step=state.step + 1, params=new_params,
                            prev_grad=new_prev_grad,
                            prev_update=new_prev_update, ef=new_ef,
                            m=new_m, v=new_v)
        out_metrics = {"loss": torch.stack(losses).mean(), "grad_norm": gn,
                       "error_norm": en, "staleness_max": zero,
                       "staleness_mean": zero}
        return StepOutput(state=new_state, metrics=out_metrics)

    # ------------------------------------------------------------------ #
    # exchange
    # ------------------------------------------------------------------ #
    def _exchange_one(self, comp, plan, p, e, rand):
        """(q̂, new EF) of one stacked (W, ...) tensor or bucket. One
        worker: (EF-)compression, whatever the strategy."""
        if self.n_workers > 1:
            exch = self.strategy.exchange
            return exch.finish(exch.start(comp, plan, p, e, rand,
                                          self._workers,
                                          self.dq.error_feedback,
                                          self.generator))
        if plan["strategy"] == "exact" or comp.name == "identity":
            return p[0], dict(e)
        e1 = e.get("e1", torch.zeros_like(p))
        _, p_hat, e_new = compress_with_ef_stacked(
            comp, p, e1, rand, self.generator, use_ef=self.dq.error_feedback)
        ne = dict(e)
        if self.dq.error_feedback:
            ne["e1"] = e_new
        return p_hat[0], ne

    def _exchange(self, params_tree, paths, message, ef, ef_leaves, plans,
                  rand, plan_sel=None):
        if self.bucketed:
            return self._exchange_bucketed(params_tree, paths, message, ef,
                                           ef_leaves, rand, plan_sel)
        comp = self.compressor
        qhat, new_ef = [], []
        for i, (p, plan, e) in enumerate(zip(message, plans, ef_leaves)):
            q, ne = self._exchange_one(comp, plan, p, e, rand.get(i))
            qhat.append(q)
            new_ef.append(ne or None)
        return qhat, T.unflatten(paths, new_ef)

    def _exchange_with_participation(self, params_tree, paths, message, ef,
                                     ef_leaves, plans, rand, part):
        """Partial participation: the sitting workers' messages and
        residuals are masked to zero before the exchange (every compressor
        maps 0 to a zero payload), q̂ is rescaled from 1/W to 1/n, and the
        sitting workers fold their message into their residual. Under an
        adaptive family the round's participant count selects the plan,
        on the device."""
        mask, n_part = part
        W = self.n_workers
        msg_in = [m * _bcast(mask, m) for m in message]
        ef_in = [{**e, "e1": e["e1"] * _bcast(mask, e["e1"])}
                 if "e1" in e else e for e in ef_leaves]
        plan_sel = round_count(mask) - 1 if self.adaptive else None
        qhat, new_ef = self._exchange(params_tree, paths, msg_in, ef, ef_in,
                                      plans, rand, plan_sel)
        scale = W / n_part
        qhat = [(q * scale).to(q.dtype) for q in qhat]
        if not self.dq.error_feedback:
            return qhat, new_ef
        # EF merge: participants keep the exchange's residual, the rest
        # accumulate the unsent message on top of their old one
        new_leaf = new_ef["leaf"] if self.bucketed else new_ef
        news = [dict(n) if n else n
                for n in T.flatten_up_to(paths, new_leaf)]
        for m, o, n in zip(message, ef_leaves, news):
            if "e1" in o:
                keep = o["e1"].float() + m
                mk = _bcast(mask, keep)
                n["e1"] = (mk * n["e1"].float()
                           + (1.0 - mk) * keep).to(o["e1"].dtype)
        merged = T.unflatten(paths, news)
        if self.bucketed:
            return qhat, {"leaf": merged, "bucket": new_ef["bucket"]}
        return qhat, merged

    def _exchange_bucketed(self, params_tree, paths, message, ef, ef_leaves,
                           rand, plan_sel=None):
        """Pack the message (and e1) into the flat buckets, (W, size) each,
        exchange each with its planned compressor, unpack q̂ and e1 back
        into leaves. `plan_sel` (a device tensor: participants − 1)
        selects the adaptive family's level counts: each bucket's
        compressor becomes a `TracedQuant` over one element of the
        device table, so no value crosses to the host."""
        dq = self.dq
        ef_dtype = self.ef_dtype
        W = self.n_workers
        exch = self.strategy.exchange
        layout, cplan, family, table = self._comm_full(params_tree)
        if layout.skipped:
            raise ValueError(f"{len(layout.skipped)} leaves bypass the "
                             f"buckets; the port shards no leaf")
        levels = None
        if plan_sel is not None and table is not None:
            levels = table.index_select(0, plan_sel.reshape(1))[0]
            block = C.get(family.base_compressor).per_block
        bucket_ef = ef["bucket"]
        e1_leaves = None
        if dq.error_feedback:
            e1_leaves = [e.get("e1", torch.zeros(l.shape, dtype=ef_dtype,
                                                 device=l.device))
                         for l, e in zip(message, ef_leaves)]
        if levels is None:
            L = self._packed_levels(layout, cplan)
            if L is not None:
                return self._exchange_packed(paths, layout, message,
                                             e1_leaves, bucket_ef, rand, L)
        flats = B.pack(layout, message)
        e1_flats = B.pack(layout, e1_leaves) if dq.error_feedback else None

        out_flats, new_e1_flats, new_bucket_ef = [], [], {}
        for b, assign in zip(layout.buckets, cplan.assignments):
            if levels is not None:
                comp = C.TracedQuant(levels[b.bid:b.bid + 1],
                                     per_block=block)
            else:
                comp = C.get(assign.compressor)
            plan_b = exch.bucket_plan(b.size, W)
            est = {}
            if dq.error_feedback:
                est["e1"] = e1_flats[b.bid]
            if X.plan_has_owner_ef(plan_b):
                est["e2"] = bucket_ef[str(b.bid)]["e2"]
            q, ne = self._exchange_one(comp, plan_b, flats[b.bid], est,
                                       rand.get(b.bid))
            out_flats.append(q)
            if dq.error_feedback:
                new_e1_flats.append(ne.get("e1", est.get("e1")))
            if X.plan_has_owner_ef(plan_b):
                new_bucket_ef[str(b.bid)] = {"e2": ne["e2"].to(ef_dtype)}

        qhat = B.unpack_into(layout, out_flats, [m[0] for m in message])
        new_leaf_ef = [None] * len(message)
        if dq.error_feedback:
            new_e1 = B.unpack_into(layout, new_e1_flats, e1_leaves)
            new_leaf_ef = [{"e1": x} for x in new_e1]
        return qhat, {"leaf": T.unflatten(paths, new_leaf_ef),
                      "bucket": new_bucket_ef}

    def _packed_levels(self, layout, cplan):
        """The level count at which `_exchange_packed` realizes this
        step's exchange, or None: it needs one worker, error feedback, a
        compressing exchange, and every bucket's compressor B1 at one
        static level count (`error_feedback.packed_levels`)."""
        if (self.n_workers != 1 or not self.dq.error_feedback
                or self.strategy.exchange.kind == "exact"):
            return None
        return packed_levels([C.get(a.compressor)
                              for a in cplan.assignments],
                             [b.size for b in layout.buckets])

    def _exchange_packed(self, paths, layout, message, e1_leaves, bucket_ef,
                         rand, levels):
        """One worker, every bucket B1 at `levels`: the message and e1
        packed into one buffer each, the buckets back to back; ONE B1
        launch over all of their rows and one dequantization; q̂ and e1
        unpack from views of the results. Bit-equal to `_exchange_one`
        bucket by bucket (rows are independent and share L). Injected
        draws (`rand[bucket id]`) land on their own bucket's rows; with
        none, one draw covers the whole buffer. One worker leaves the
        owner EF (e2, two_phase) as it was."""
        msg = B.pack_concat(layout, message)            # (Σ size,)
        e1 = B.pack_concat(layout, e1_leaves)
        r = None
        if any(b.bid in rand for b in layout.buckets):
            r = torch.cat([
                rand[b.bid].reshape(-1) if b.bid in rand else torch.rand(
                    (b.size,), generator=self.generator, device=msg.device)
                for b in layout.buckets])
        _, m_hat, e_new = fused_quantize_ef(msg, e1, r, self.generator,
                                            levels=levels)
        qhat = B.unpack_into(layout, B.split_concat(layout, m_hat),
                             [m[0] for m in message])
        new_e1 = B.unpack_into(layout, B.split_concat(layout, e_new, (1,)),
                               e1_leaves)
        return qhat, {"leaf": T.unflatten(paths, [{"e1": x}
                                                  for x in new_e1]),
                      "bucket": dict(bucket_ef)}

    def _server_update(self, state, paths, qhat):
        """Apply q̂ to the parameters (and Adam moments)."""
        dq = self.dq
        eta = dq.lr
        params = T.flatten_up_to(paths, state.params)
        new_m, new_v, new_prev_update = state.m, state.v, state.prev_update
        if dq.optimizer == "omd":
            update = qhat if dq.message == "update" else [eta * q
                                                         for q in qhat]
            new_params = [w - u.to(w.dtype) for w, u in zip(params, update)]
            if dq.extrapolation == "global":
                new_prev_update = T.unflatten(paths, update)
        elif dq.optimizer in ("adam", "oadam"):
            # bias correction counts applied updates (every step here)
            t = torch.tensor(float((state.step + 1)
                                   // self.strategy.schedule.period))
            b1, b2 = dq.beta1, dq.beta2
            m = [b1 * m + (1 - b1) * g
                 for m, g in zip(T.flatten_up_to(paths, state.m), qhat)]
            v = [b2 * v + (1 - b2) * torch.square(g)
                 for v, g in zip(T.flatten_up_to(paths, state.v), qhat)]
            bc1 = (1.0 - torch.tensor(b1) ** t).to(qhat[0].device)
            bc2 = (1.0 - torch.tensor(b2) ** t).to(qhat[0].device)
            direction = self._scale_groups(
                paths, [(mm / bc1) / (torch.sqrt(vv / bc2) + dq.eps)
                        for mm, vv in zip(m, v)])
            if dq.optimizer == "oadam":
                # optimistic Adam: w ← w − η (2 d_t − d_{t−1})
                prev = T.flatten_up_to(paths, state.prev_update)
                new_params = [w - (eta * (2.0 * d - dp)).to(w.dtype)
                              for w, d, dp in zip(params, direction, prev)]
                new_prev_update = T.unflatten(paths, direction)
            else:
                new_params = [w - (eta * d).to(w.dtype)
                              for w, d in zip(params, direction)]
            new_m, new_v = T.unflatten(paths, m), T.unflatten(paths, v)
        elif dq.optimizer == "sgd":
            new_params = [w - (eta * q).to(w.dtype)
                          for w, q in zip(params, qhat)]
        else:
            raise ValueError(dq.optimizer)
        return T.unflatten(paths, new_params), new_m, new_v, new_prev_update
