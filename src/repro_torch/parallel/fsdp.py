"""The fsdp parameter layout's data group (the JAX package's Mode B,
DESIGN.md §4): the collectives XLA inserts where a parameter sharded over
'data' meets the field, written out with their backward passes.

Under the layout a rank of a `launch.mesh.ProcessMesh` (layout "fsdp")
holds its shard of every parameter cut over its data and model indices
(`parallel.sharding`, layout "fsdp"). The field runs on the rank's rows
of its worker's batch and gathers the parameters over the fsdp group
(the data ranks of one (pod, model) index) where it uses them:

    gather_param      all-gather forward, summed reduce-scatter backward:
                      a leaf sharded over 'data', gathered at its use
    replicated_param  identity forward, summed all-reduce backward: a
                      leaf the layout leaves whole over 'data' (norms,
                      row-parallel biases, embed / unembed, the router,
                      conv, scalars)

Each data rank's loss is its share of the worker's (its tokens' sum over
the worker's token count), so the backward's sums over the group give
every rank the gradient of the worker's loss with respect to its shard.

`fsdp_parallel(group, specs)` makes an `FsdpGroup` and the full
parameters' spec tree current for the field; `prepare(params)` passes
the leaves the layout leaves whole through `replicated_param` once, at
the top of the loss, and `gathered(tree, path)` gathers a block's
sharded leaves (a period of the stacked layers, inside its
`torch.utils.checkpoint`, so that the backward's recompute gathers
again and a rank holds one period's gathered weights at a time). Outside
the context, or with one data rank, all three return their input.

Every collective runs inside a `repro_torch/fsdp_group:<shape>` profiler
range, which `obs.trace` counts under group "fsdp", apart from the
exchange's and the model group's. A `MetaFsdpGroup` (one rank of a meta
mesh) makes each collective's result and counts it, for
`launch.dryrun`.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch import tree as T

from . import sharding as shd
from .tensor import MetaModelGroup, ModelGroup

FSDP_GROUP_RANGE = "repro_torch/fsdp_group"


class FsdpGroup(ModelGroup):
    """The data ranks of one (pod, model) index: `size` ranks, this one at
    `index`; every collective inside a FSDP_GROUP_RANGE range."""
    RANGE = FSDP_GROUP_RANGE


class MetaFsdpGroup(MetaModelGroup):
    """One rank's fsdp group on the meta device: each collective's result
    made, its communication left out, counted in `collectives`."""
    RANGE = FSDP_GROUP_RANGE


def fsdp_group_for(mesh) -> Optional[FsdpGroup]:
    """The fsdp group of a Mode-B `ProcessMesh` (a `MetaFsdpGroup` on a
    meta mesh), or None under dp."""
    if mesh is None or not getattr(mesh, "fsdp", False):
        return None
    group = getattr(mesh, "_fsdp_group", None)
    if group is None:   # one a mesh: its field and trainer share it
        group = (MetaFsdpGroup(mesh.data, mesh.data_index)
                 if mesh.device.type == "meta" else
                 FsdpGroup(mesh.fsdp_group, mesh.data, mesh.data_index))
        mesh._fsdp_group = group
    return group


_CURRENT = [None]   # (group, spec tree) or None


@contextlib.contextmanager
def fsdp_parallel(group: Optional[FsdpGroup], specs):
    """Make `group` and the full parameters' `specs` current for the
    block."""
    prev = _CURRENT[0]
    _CURRENT[0] = None if group is None else (group, specs)
    try:
        yield group
    finally:
        _CURRENT[0] = prev


def current() -> Optional[FsdpGroup]:
    """The current fsdp group, or None (none, or one data rank)."""
    c = _CURRENT[0]
    return c[0] if c is not None and c[0].size > 1 else None


def data_size() -> int:
    """The data ranks a worker's batch is split over (1 outside)."""
    g = current()
    return 1 if g is None else g.size


# --------------------------------------------------------------------------- #
# the conjugate pairs
# --------------------------------------------------------------------------- #
class _GatherParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(w, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g, ctx.dim), None, None


class _ReplicatedParam(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.clone()), None


def gather_param(w, dim: int, group=None):
    """The data ranks' shards of a parameter concatenated along `dim`;
    backward: the gradient's sum over the ranks, this rank's slice."""
    group = group or current()
    return w if group is None else _GatherParam.apply(w, group,
                                                      dim % w.dim())


def replicated_param(w, group=None):
    """w; backward: the gradient's sum over the data ranks."""
    group = group or current()
    return w if group is None else _ReplicatedParam.apply(w, group)


def _specs_at(path):
    node = _CURRENT[0][1]
    for k in path:
        node = node[k]
    return node


def prepare(params):
    """`params` with every leaf the layout leaves whole over 'data' passed
    through `replicated_param` (once a step: their gradients sum over the
    group in one all-reduce a leaf); the sharded leaves as they are."""
    if current() is None:
        return params
    paths, leaves = T.flatten(params)
    specs = T.flatten_up_to(paths, _CURRENT[0][1])
    return T.unflatten(paths, [
        replicated_param(x) if shd.data_axis(s) is None else x
        for x, s in zip(leaves, specs)])


def gathered(tree, path, stacked: bool = False):
    """A block's parameters (`tree`, the subtree at `path` of the full
    parameters; one layer of a stacked subtree when `stacked`, whose specs
    lead with the layer axis) with each leaf sharded over 'data' gathered
    whole over the group."""
    if current() is None:
        return tree
    paths, leaves = T.flatten(tree)
    specs = T.flatten_up_to(paths, _specs_at(path))
    out = []
    for x, s in zip(leaves, specs):
        ax = shd.data_axis(s)
        out.append(x if ax is None else gather_param(x, ax - int(stacked)))
    return T.unflatten(paths, out)
