"""Telemetry collected inside the training step (counterpart of
`repro.obs.metrics`).

A `MetricSpec` describes WHAT the step measures; the three levels form a
lattice::

    off  ⊂  wire (empirical δ + EF residual norms)
         ⊂  full (adds per-bucket message moments + staleness histogram)

`metrics="off"` hands the step a `NullCollector`, whose record methods do
nothing: the step launches no kernel more than without this package.
The enabled levels only read tensors the step has already made (they
draw no random numbers and write no state), so parameters and EF are
bit-equal across off, wire and full.

Every record call takes (L, ...) stacks: the rows of this process's L
workers (all W of them on one device, or a rank's block of them). The
collector sums each quantity over the rows (the JAX package's axis-0
sum of per-worker sums after its vmap), into float32 scalars on the
step's device, with no host sync; the step then sums them over the
ranks (one all_reduce of the packed dict, `core.exchange.
ProcessGroupWorkers.sum_dict`) before `finalize`. Element counts are
per worker and stay Python ints.

Empirical δ is read off quantities the step already holds: the
compression operand m = message + e_prev and the fresh residual
e' = m − Q(m), so δ̂ = 1 − Σ‖e'‖² / Σ‖m‖². The Σ runs over the fleet, so
workers sitting a participation round out (masked to m = 0, e' = 0) drop
out of the ratio instead of biasing it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

_TINY = 1e-30
_KEYS = ("msg_sum", "msg_sq", "op_sq", "err_sq")


# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class MetricSpec:
    """Switchboard of the metric groups. Frozen and hashable."""

    name: str
    moments: bool = False    # per-bucket + aggregate message mean/var
    delta: bool = False      # empirical δ̂ per bucket + aggregate
    ef_norms: bool = False   # ‖e1‖, ‖e2‖ fleet-wide residual norms
    staleness: bool = False  # staleness histogram (delayed schedules)

    @property
    def on(self) -> bool:
        return self.moments or self.delta or self.ef_norms or self.staleness


METRIC_SPECS: Dict[str, MetricSpec] = {
    "off": MetricSpec("off"),
    "wire": MetricSpec("wire", delta=True, ef_norms=True),
    "full": MetricSpec("full", moments=True, delta=True, ef_norms=True,
                       staleness=True),
}


def metric_keys(spec: MetricSpec, n_buckets: int) -> Tuple[str, ...]:
    """The keys of the finalized ``metrics["obs"]`` dict, in order."""
    keys: List[str] = []
    if spec.moments:
        keys += ["msg_mean", "msg_var"]
        if n_buckets:
            keys += ["bucket_mean", "bucket_var"]
    if spec.delta:
        keys += ["delta_hat"]
        if n_buckets:
            keys += ["bucket_delta"]
    if spec.ef_norms:
        keys += ["ef_e1_norm", "ef_e2_norm"]
    if spec.staleness:
        keys += ["staleness_hist"]
    return tuple(keys)


def _sum_sq(x):
    x = x.float()
    return torch.sum(x * x)


# --------------------------------------------------------------------------- #
class NullCollector:
    """The `metrics="off"` collector: every record method does nothing."""

    enabled = False
    n_buckets = 0

    def bucket(self, bid, raw, op, err):
        pass

    def leaf(self, raw, op, err, group=None):
        pass

    def sums(self) -> dict:
        return {}

    def counts(self) -> dict:
        return {"agg": 0, "bucket": []}


class Collector:
    """Accumulates the metric sums of one step.

    `bucket(bid, raw, op, err)` records one comm bucket: ``raw`` the
    packed message, ``op`` the compression operand (raw + e_prev) and
    ``err`` the fresh residual e' = op − Q(op), each an (L, size) stack.
    `leaf(raw, op, err)` records a tensor outside the buckets (the
    per-leaf paths) into the aggregate only. `device` is where the sums
    live; a bucket never recorded (a mid-round local_k step) sums to
    zero."""

    enabled = True

    def __init__(self, spec: MetricSpec, n_buckets: int, device=None):
        self.spec = spec
        self.n_buckets = n_buckets
        self.device = torch.device(device or "cpu")
        self._agg: Dict[str, list] = {k: [] for k in _KEYS}
        self._bkt: Dict[str, list] = {k: [None] * n_buckets for k in _KEYS}
        self._n_agg = 0
        self._n_bkt = [0] * n_buckets

    # ---- record ------------------------------------------------------ #
    def _record(self, raw, op, err) -> dict:
        s = self.spec
        out = {}
        if s.moments:
            r = raw.float()
            out["msg_sum"] = torch.sum(r)
            out["msg_sq"] = torch.sum(r * r)
        if s.delta:
            out["op_sq"] = _sum_sq(op)
            out["err_sq"] = _sum_sq(err)
        for k, v in out.items():
            self._agg[k].append(v)
        if s.moments or s.delta:
            self._n_agg += raw[0].numel()
        return out

    def bucket(self, bid: int, raw, op, err):
        for k, v in self._record(raw, op, err).items():
            self._bkt[k][bid] = v
        self._n_bkt[bid] = raw[0].numel()

    def leaf(self, raw, op, err, group=None):
        """A tensor outside the buckets; `group` (a model group): the
        tensors are this rank's slices of model-sharded ones, whose sums
        are taken over the group and whose count is the global one."""
        out = self._record(raw, op, err)
        if group is not None:
            for v in out.values():
                group.all_reduce(v)
            if out:
                self._n_agg += raw[0].numel() * (group.size - 1)

    # ---- export ------------------------------------------------------ #
    def sums(self) -> dict:
        """The sums over this process's rows: scalar aggregates plus
        (n_buckets,) stacks, each key the JAX collector's."""
        zero = torch.zeros((), device=self.device)
        out = {k: (torch.stack(v).sum() if len(v) > 1 else v[0]) if v
               else zero for k, v in self._agg.items()}
        if self.n_buckets:
            for k, vals in self._bkt.items():
                out["b_" + k] = torch.stack(
                    [zero if v is None else v for v in vals])
        return out

    def counts(self) -> dict:
        return {"agg": self._n_agg, "bucket": list(self._n_bkt)}


def staleness_hist(st, bins: int):
    """Fixed-shape staleness histogram: bin i counts workers at staleness
    i, the last bin is the overflow (a sitting worker's version keeps
    aging past τ under partial participation). `st` is an (L,) vector of
    this process's workers' staleness (or one worker's scalar); the
    caller sums the result over the ranks."""
    idx = torch.clamp(torch.round(st).to(torch.int64), 0, bins - 1)
    # one-hot by comparison: `F.one_hot` checks its indices on the host
    oh = (idx[..., None] == torch.arange(bins, device=idx.device)).to(
        torch.float32)
    if oh.dim() > 1:
        oh = oh.sum(dim=tuple(range(oh.dim() - 1)))
    return oh


def _ef_dicts(tree):
    """The EF dicts ({"e1": .., "e2": ..}) of an EF tree, in order."""
    if isinstance(tree, dict):
        if "e1" in tree or "e2" in tree:
            return [tree]
        return [d for v in tree.values() for d in _ef_dicts(v)]
    if isinstance(tree, (list, tuple)):
        return [d for v in tree for d in _ef_dicts(v)]
    return []


def ef_norms_sq(new_ef, device=None):
    """(Σ‖e1‖², Σ‖e2‖²) over a post-exchange EF tree, this process's rows:
    the per-leaf layout (a tree of {"e1": ..} dicts) and the bucketed
    {"leaf": .., "bucket": ..} layout alike. Zeros where a slot is
    absent."""
    e1 = [d["e1"] for d in _ef_dicts(new_ef) if "e1" in d]
    e2 = [d["e2"] for d in _ef_dicts(new_ef) if "e2" in d]

    def total(ts):
        if not ts:
            return torch.zeros((), device=device)
        out = _sum_sq(ts[0])
        for t in ts[1:]:
            out = out + _sum_sq(t)
        return out
    return total(e1), total(e2)


def finalize(spec: MetricSpec, sums: dict, counts: dict, n_workers: int,
             n_buckets: int) -> dict:
    """Fleet sums → the ``metrics["obs"]`` dict (keys exactly
    `metric_keys(spec, n_buckets)`), float32 tensors on the sums' device.

    `sums` must already be summed over all W workers; `counts` are the
    per-worker element counts, so the fleet denominator is count × W. A
    zero denominator (a mid-round local_k step, an all-masked round)
    gives mean/var 0 and δ̂ 1."""
    out = {}
    W = max(n_workers, 1)
    n_agg = counts["agg"] * W
    if spec.moments:
        mean = sums["msg_sum"] / max(n_agg, 1)
        out["msg_mean"] = mean
        out["msg_var"] = torch.clamp_min(
            sums["msg_sq"] / max(n_agg, 1) - mean * mean, 0.0)
        if n_buckets:
            # the counts made on the device (a copy from the host would
            # wait for the stream)
            dev = sums["b_msg_sum"].device
            nb = torch.stack([torch.full((), float(max(c * W, 1)),
                                         device=dev)
                              for c in counts["bucket"]])
            bmean = sums["b_msg_sum"] / nb
            out["bucket_mean"] = bmean
            out["bucket_var"] = torch.clamp_min(
                sums["b_msg_sq"] / nb - bmean * bmean, 0.0)
    if spec.delta:
        out["delta_hat"] = 1.0 - sums["err_sq"] / torch.clamp_min(
            sums["op_sq"], _TINY)
        if n_buckets:
            out["bucket_delta"] = 1.0 - sums["b_err_sq"] / torch.clamp_min(
                sums["b_op_sq"], _TINY)
    if spec.ef_norms:
        out["ef_e1_norm"] = torch.sqrt(sums["e1_sq"])
        out["ef_e2_norm"] = torch.sqrt(sums["e2_sq"])
    if spec.staleness:
        out["staleness_hist"] = sums["staleness_hist"]
    return out
