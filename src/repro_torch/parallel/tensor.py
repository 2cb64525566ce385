"""Tensor parallelism over the model group of a `launch.mesh.ProcessMesh`:
the collectives GSPMD inserts for the JAX package's 'model' axis,
written out with their backward passes.

The JAX package shards its parameters over 'model' by
`parallel.sharding`'s rules and lets the compiler place every all-reduce
and regather. The port's field runs on each rank's shards, and the
layers (`models.layers`, `models.model`, `models.moe`, `models.gan`) call
the conjugate pairs below where a sharded linear meets the replicated
rest of the model:

    copy_to       identity forward, all-reduce backward: a replicated
                  tensor entering a tensor-parallel region (the input of
                  a column-parallel linear, an expert's token buffer)
    reduce_from   all-reduce forward, identity backward: the partial
                  sums leaving it (a row-parallel output, the combine)
    gather_from   all-gather forward, slice backward: a column-parallel
                  output that feeds anything but its row-parallel partner
    scatter_to    slice forward, all-gather backward: a replicated tensor
                  whose rank-local slice feeds a row-parallel linear

Leaving out a backward collective gives replicated leaves (norm scales,
row-parallel biases, the router) gradients that differ across the model
ranks; the ranks then drift apart from the second step on.

`model_parallel(group)` makes a `ModelGroup` current for the field's
forward and backward; `current()` is None outside it (or with one model
rank), and the layers then run as before. `shards(n)` is the rule of
`parallel.sharding.sanitize_spec`: a dimension of n shards over the
model axis when the axis size divides it. A `MetaModelGroup` (one rank
of a meta mesh) makes each collective's result and counts it, for
`launch.dryrun`.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

# the profiler range around every model-group collective, named
# "<MODEL_GROUP_RANGE>:<the shape of the tensor it sends>": `obs.trace`
# tells them apart from the exchange's (data group) and pairs each with
# its backend record by it
MODEL_GROUP_RANGE = "repro_torch/model_group"


class ModelGroup:
    """The model ranks of one data index: `size` ranks, this one at
    `index`; `group` the `torch.distributed` group. Every collective goes
    through `_collective`, inside a MODEL_GROUP_RANGE profiler range.
    `result` is the tensor each rank sends (the all_reduce's, one part of
    the all_gather): its shape names the range."""

    def __init__(self, group, size: int, index: int):
        self.group, self.size, self.index = group, size, index

    def _collective(self, kind: str, result, fn, *args, **kwargs):
        del kind
        name = ",".join(map(str, result.shape))
        with record_function(f"{MODEL_GROUP_RANGE}:{name}"):
            return fn(*args, group=self.group, **kwargs)

    def all_reduce(self, x, op=dist.ReduceOp.SUM):
        """The sum (or `op`) over the model ranks, in place; returns x."""
        self._collective("all_reduce", x, dist.all_reduce, x, op=op)
        return x

    def all_gather(self, x, dim: int):
        """The ranks' x concatenated along `dim`, in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        self._collective("all_gather", parts[0], dist.all_gather, parts, x)
        parts[self.index] = x
        return torch.cat(parts, dim=dim)

    def slice(self, x, dim: int):
        """This rank's 1/size of x along `dim`."""
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


class MetaModelGroup(ModelGroup):
    """One rank's model group on the meta device: each collective's result
    made, its communication left out, and counted in `collectives` by
    kind with the bytes of its results (as `core.exchange.MetaWorkers`
    counts the exchange's)."""

    def __init__(self, size: int, index: int):
        super().__init__(None, size, index)
        self.collectives = {}

    def _collective(self, kind: str, result, fn, *args, **kwargs):
        if result.device.type != "meta":
            raise ValueError(f"MetaModelGroup: a {kind} buffer is on "
                             f"{result.device}; a meta mesh traces meta "
                             f"tensors only")
        rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        nbytes = result.numel() * result.element_size()
        rec["bytes"] += nbytes * (self.size if kind == "all_gather" else 1)
        return None


def model_group_for(mesh) -> Optional[ModelGroup]:
    """The model group of a `ProcessMesh` (a `MetaModelGroup` on a meta
    mesh), or None with one model rank."""
    if mesh is None or mesh.model == 1:
        return None
    group = getattr(mesh, "_tp_group", None)
    if group is None:   # one a mesh: its field and trainer share it
        group = (MetaModelGroup(mesh.model, mesh.model_index)
                 if mesh.device.type == "meta" else
                 ModelGroup(mesh.model_group, mesh.model, mesh.model_index))
        mesh._tp_group = group
    return group


_CURRENT = [None]


@contextlib.contextmanager
def model_parallel(group: Optional[ModelGroup]):
    """Make `group` current (None: no tensor parallelism) for the block."""
    prev = _CURRENT[0]
    _CURRENT[0] = group
    try:
        yield group
    finally:
        _CURRENT[0] = prev


def current() -> Optional[ModelGroup]:
    """The current model group, or None (none, or one model rank)."""
    g = _CURRENT[0]
    return g if g is not None and g.size > 1 else None


def shards(n: int) -> bool:
    """True when a dimension of n is sharded over the current model axis
    (`sanitize_spec`'s rule: the axis size divides it)."""
    g = current()
    return g is not None and n % g.size == 0


# --------------------------------------------------------------------------- #
# the conjugate pairs
# --------------------------------------------------------------------------- #
class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.slice(g, ctx.dim).contiguous(), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.slice(x, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_gather(g, ctx.dim), None, None


def copy_to(x, group=None):
    group = group or current()
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x, group=None):
    group = group or current()
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x, dim: int = -1, group=None):
    group = group or current()
    return x if group is None else _GatherFrom.apply(x, group,
                                                     dim % x.dim())


def scatter_to(x, dim: int = -1, group=None):
    group = group or current()
    return x if group is None else _ScatterTo.apply(x, group,
                                                    dim % x.dim())


def all_max(x, group=None):
    """The elementwise max over the model ranks, outside autograd (a
    softmax's shift, whose gradient cancels)."""
    group = group or current()
    x = x.detach().clone()
    return x if group is None else group.all_reduce(x, dist.ReduceOp.MAX)
