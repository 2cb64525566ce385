"""DQGAN (paper Algorithm 2), single worker (counterpart of
`repro.core.dqgan`).

    w_{t-1/2} = w_{t-1} - [η F(w_{t-3/2}; ξ_{t-1}) + e_{t-1}]   (omd, local)
    g_t       = F(w_{t-1/2}; ξ_t)
    p_t       = η g_t + e_{t-1};   p̂_t = Q(p_t);   e_t = p_t - p̂_t
    w_t       = w_{t-1} - p̂_t

With one worker the server's average is the worker's own p̂, so the
exchange is (EF-)compression, per leaf or over flat comm buckets, where
`qsgd8_block1024` runs the fused quantize+EF CUDA kernel. The baselines
are configurations: CPOAdam = oadam + identity, CPOAdam-GQ = oadam +
quantizer without EF, DQGAN = omd + quantizer + EF.

State mirrors the JAX package's `DQState`: per-worker leaves (prev_grad,
ef) keep a leading worker axis of size 1, parameters keep the JAX layout
and leaf order. Randomness comes from the trainer's `torch.Generator` on
its device, or from `draws` handed to `step` (the tests replay the JAX
package's draws that way).

Multiple workers, the other schedules, partial participation, fsdp,
overlap and observability are refused at construction, each naming the
ROADMAP slice that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch import tree as T
from repro_torch.comm import CommLedger
from repro_torch.comm import buckets as B
from repro_torch.configs.base import DQConfig
from repro_torch.strategy import Strategy

from . import compressors as C
from . import exchange as X
from .error_feedback import compress_with_ef


class DQState(NamedTuple):
    """Optimizer state; the fields of `repro.core.dqgan.DQState`. Trees are
    nested dicts in the parameters' structure; per-worker trees (prev_grad,
    ef) have a leading axis of size 1. `step` is a Python int."""
    step: int
    params: Any
    prev_grad: Any       # F(w_{t-3/2}; ξ_{t-1}) (omd, local) | None
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
        (s.participation.partial,
         f"participation {s.participation.fraction}",
         "slice 2 (multiple workers, participation)"),
        (s.exchange.fsdp, "parallelism 'fsdp'", "slice 5 (FSDP)"),
        (s.exchange.spmd == "vmap", "spmd 'vmap'",
         "slice 2 (multiple workers, stacked workers)"),
        (s.exchange.overlap, "overlap=True", "slice 3 (schedules, overlap)"),
        (s.compression.adaptive, "an adaptive PlanFamily",
         "slice 2 (multiple workers, PlanFamily)"),
        (s.observability.on or s.observability.spans
         or s.observability.profile,
         "observability (metrics/spans/profile)", "slice 4 (observability)"),
    )
    for hit, what, where in checks:
        if hit:
            return (f"repro_torch does not run {what} yet: it arrives with "
                    f"ROADMAP §A {where}")
    return None


def _global_norm(tensors):
    tensors = [t for t in tensors if t is not None]
    if not tensors:
        return torch.zeros(())
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in tensors))


def _ef_tensors(ef):
    """Every residual tensor of an EF tree (leaf dicts and bucket dicts)."""
    out = []
    for leaf in T.leaves(ef) if isinstance(ef, dict) else []:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
    return out


@dataclasses.dataclass
class DQGAN:
    """Single-worker DQGAN trainer. Build once per (field, strategy,
    device); then `init(params)` and `step(state, batch)`.

    `field_fn(params, batch, z=None, generator=None) -> (grads, metrics)`.
    `dq` carries the optimizer knobs and the strategy (or pass `strategy`
    alone, like the JAX package). `device` is where the generator draws:
    the parameters' device. On CUDA, constructing the trainer turns TF32
    off for matmuls and convolutions (process-wide PyTorch flags)."""

    field_fn: Callable
    dq: Optional[DQConfig] = None
    strategy: Optional[Strategy] = None
    device: Any = "cuda"
    seed: int = 0
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
        self.device = torch.device(self.device)
        if self.device.type == "cuda":
            # the reference computes in float32; cuDNN convolutions would
            # otherwise run in TF32 (about three decimal digits)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(self.seed)

    # ------------------------------------------------------------------ #
    @property
    def n_workers(self) -> int:
        return 1

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
    def ef_dtype(self) -> torch.dtype:
        return getattr(torch, self.strategy.compression.ef_dtype)

    def _comm(self, params):
        """(BucketLayout, CommPlan), derived from leaf shapes, memoized."""
        shapes = T.tree_map(lambda x: tuple(x.shape), params)
        key = tuple(zip(*T.flatten(shapes)))
        hit = self._comm_cache.get(key)
        if hit is None:
            hit = self.strategy.compression.build(shapes, None,
                                                  self.n_workers)
            self._comm_cache[key] = hit
        return hit

    def comm_ledger(self, params) -> CommLedger:
        """Per-step wire cost of this trainer (launch.train's log fields)."""
        strat = self.strategy
        shapes = T.tree_map(lambda x: tuple(x.shape), params)
        if self.bucketed:
            layout, cplan = self._comm(params)
            budget = (int(strat.compression.budget_mb * (1 << 20))
                      if strat.compression.plan == "delta_budget" else 0)
            return CommLedger.from_plan(
                layout, cplan, strat.exchange.kind, self.n_workers,
                strat.compression.compressor, budget_bytes=budget)
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
            prev_grad = tree(lambda x: zeros(x, (1,)))
        if (dq.optimizer == "omd" and dq.extrapolation == "global"
                or dq.optimizer == "oadam"):
            prev_update = tree(zeros)
        if self.uses_adam:
            m, v = tree(zeros), tree(zeros)

        def ef_leaf(x, plan):
            st = {}
            if dq.error_feedback:
                st["e1"] = zeros(x, (1,), ef_dtype)
            if X.plan_has_owner_ef(plan):
                cs = list(x.shape)
                cs[plan["chunk_axis"]] //= self.n_workers
                st["e2"] = torch.zeros((1, *cs), dtype=ef_dtype,
                                       device=x.device)
            return st or None

        ef = T.unflatten(paths, [ef_leaf(x, p) for x, p in zip(leaves, plans)])
        if self.bucketed:
            layout, _ = self._comm(params)
            bucket_ef = {}
            if self.strategy.exchange.owner_ef:
                for b in layout.buckets:
                    bucket_ef[str(b.bid)] = {"e2": torch.zeros(
                        (1, b.size // self.n_workers), dtype=ef_dtype,
                        device=leaves[0].device)}
            ef = {"leaf": ef, "bucket": bucket_ef}
        return DQState(step=0, params=params, prev_grad=prev_grad,
                       prev_update=prev_update, ef=ef, m=m, v=v)

    # ------------------------------------------------------------------ #
    # the step
    # ------------------------------------------------------------------ #
    @torch.no_grad()
    def step(self, state: DQState, batch,
             draws: Optional[Dict[str, Any]] = None) -> StepOutput:
        """One Algorithm-2 iteration.

        `draws` (optional) replaces the generator: {"z": the field's
        latent draw, "rand": {stream: uniform draw}} where a stream is the
        leaf index on the per-leaf path and the bucket id on the bucketed
        path, as the JAX package folds them into its key."""
        dq = self.dq
        eta = dq.lr
        draws = draws or {}
        rand = draws.get("rand", {})
        paths, params = T.flatten(state.params)
        plans = self._plans(state.params)
        prev_grad = ([g[0] for g in T.flatten_up_to(paths, state.prev_grad)]
                     if state.prev_grad is not None else None)
        ef = state.ef
        ef_leaf_tree = ef["leaf"] if self.bucketed else ef
        ef_leaves = [{k: x[0] for k, x in e.items()} if e else {}
                     for e in T.flatten_up_to(paths, ef_leaf_tree)]

        # ---------- extrapolation to w_{t-1/2} ---------------------------- #
        if dq.optimizer == "omd" and dq.extrapolation == "local":
            w_half = []
            for w, g, e in zip(params, prev_grad, ef_leaves):
                upd = eta * g
                if dq.error_feedback and "e1" in e:
                    upd = upd + e["e1"].to(w.dtype)
                w_half.append(w - upd.to(w.dtype))
        elif dq.optimizer == "omd":
            w_half = [w - u.to(w.dtype) for w, u in zip(
                params, T.flatten_up_to(paths, state.prev_update))]
        else:
            w_half = params  # adam/oadam/sgd evaluate at current params

        # ---------- local stochastic field -------------------------------- #
        grads, metrics = self.field_fn(T.unflatten(paths, w_half), batch,
                                       z=draws.get("z"),
                                       generator=self.generator)
        grads = T.flatten_up_to(paths, grads)

        if dq.message == "update" and dq.optimizer == "omd":
            message = [(eta * g).float() for g in grads]
        else:
            message = [g.float() for g in grads]

        # ---------- exchange (one worker: EF-compression) + update -------- #
        if self.bucketed:
            qhat, new_ef = self._exchange_bucketed(state.params, message,
                                                   ef, ef_leaves, rand)
        else:
            qhat, new_ef = self._exchange_leaves(paths, message, ef_leaves,
                                                 plans, rand)
        new_params, new_m, new_v, new_prev_update = self._server_update(
            state, paths, qhat)

        new_prev_grad = None
        if prev_grad is not None:
            new_prev_grad = T.unflatten(
                paths, [g.to(o.dtype)[None] for o, g in zip(prev_grad, grads)])

        gn = _global_norm(grads)
        en = _global_norm(_ef_tensors(new_ef))
        zero = torch.zeros((), device=gn.device)
        new_state = DQState(step=state.step + 1, params=new_params,
                            prev_grad=new_prev_grad,
                            prev_update=new_prev_update, ef=new_ef,
                            m=new_m, v=new_v)
        out_metrics = {"loss": metrics.get("loss", zero), "grad_norm": gn,
                       "error_norm": en, "staleness_max": zero,
                       "staleness_mean": zero}
        return StepOutput(state=new_state, metrics=out_metrics)

    def _single_worker_leaf(self, comp, plan, p, e, rand):
        """One worker's exchange of one tensor or bucket: (p̂, new EF)."""
        if plan["strategy"] == "exact" or comp.name == "identity":
            return p, dict(e)
        e1 = e.get("e1", torch.zeros_like(p))
        _, p_hat, e_new = compress_with_ef(comp, p, e1, rand, self.generator,
                                           use_ef=self.dq.error_feedback)
        ne = dict(e)
        if self.dq.error_feedback:
            ne["e1"] = e_new
        return p_hat, ne

    def _exchange_leaves(self, paths, message, ef_leaves, plans, rand):
        comp = self.compressor
        qhat, new_ef = [], []
        for i, (p, plan, e) in enumerate(zip(message, plans, ef_leaves)):
            q, ne = self._single_worker_leaf(comp, plan, p, e, rand.get(i))
            qhat.append(q)
            new_ef.append({k: x[None] for k, x in ne.items()} or None)
        return qhat, T.unflatten(paths, new_ef)

    def _exchange_bucketed(self, params_tree, message, ef, ef_leaves, rand):
        """Pack the message (and e1) into the flat buckets, EF-compress each
        with its planned compressor, unpack q̂ and e1 back into leaves."""
        dq = self.dq
        ef_dtype = self.ef_dtype
        exch = self.strategy.exchange
        layout, cplan = self._comm(params_tree)
        if layout.skipped:
            raise NotImplementedError(
                "sharded leaves off the bucket path need multiple workers "
                "(ROADMAP §A slice 2)")
        paths = T.flatten(params_tree)[0]
        flats = B.pack(layout, message)
        e1_leaves = e1_flats = None
        if dq.error_feedback:
            e1_leaves = [e.get("e1", torch.zeros(l.shape, dtype=ef_dtype,
                                                 device=l.device))
                         for l, e in zip(message, ef_leaves)]
            e1_flats = B.pack(layout, e1_leaves)
        bucket_ef = ef["bucket"]

        out_flats, new_e1_flats, new_bucket_ef = [], [], {}
        for b, assign in zip(layout.buckets, cplan.assignments):
            plan_b = exch.bucket_plan(b.size, self.n_workers)
            est = {}
            if dq.error_feedback:
                est["e1"] = e1_flats[b.bid]
            if X.plan_has_owner_ef(plan_b):
                est["e2"] = bucket_ef[str(b.bid)]["e2"][0]
            q, ne = self._single_worker_leaf(C.get(assign.compressor), plan_b,
                                             flats[b.bid], est,
                                             rand.get(b.bid))
            out_flats.append(q)
            if dq.error_feedback:
                new_e1_flats.append(ne.get("e1", est.get("e1")))
            if X.plan_has_owner_ef(plan_b):
                new_bucket_ef[str(b.bid)] = {"e2": ne["e2"].to(ef_dtype)[None]}

        qhat = B.unpack_into(layout, out_flats, message)
        new_leaf_ef = [None] * len(message)
        if dq.error_feedback:
            new_e1 = B.unpack_into(layout, new_e1_flats, e1_leaves)
            new_leaf_ef = [{"e1": x[None]} for x in new_e1]
        return qhat, {"leaf": T.unflatten(paths, new_leaf_ef),
                      "bucket": new_bucket_ef}

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
