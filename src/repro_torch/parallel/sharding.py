"""Partition rules for every parameter, cache and batch tensor
(counterpart of `repro.parallel.sharding`).

Two layouts:

  "dp"   params replicated over the data axes, tensor-parallel over
         'model'.
  "fsdp" params sharded over 'data' (ZeRO-3 style) and 'model'.

Rules are by parameter path name:
  column-parallel (output dim on 'model'): q k v gate up in_x in_gate z x
      B C dt W_a W_i unembed fc
  row-parallel (input dim on 'model'):     o down out
  expert-parallel (expert dim on 'model'): gate_proj up_proj down_proj
  vocab-sharded:                           embed
  replicated:                              norms, biases of row-parallel,
                                           conv, scalars, router
Stacked layer params (under 'scan') get a leading None for the L axis.

The JAX package's specs are `PartitionSpec`s over a device mesh. Here
nothing allocates or needs a device: a spec is a plain tuple with one
entry per dim (None, an axis name, or a tuple of names), and a mesh is an
ordered {axis: size} dict (`launch.mesh.production_mesh_shape`). Trees
are the port's nested dicts (`repro_torch.tree`), whose keys are the JAX
package's; a list index in a path reads "[i]", as JAX's sequence keys
do. The port's trainer lays its parameters out by these rules over the
'model' axis of its process mesh: `shard_of` cuts a rank's shard of a
leaf under its sanitised spec and `gather_to_full` (a collective over the
model group) puts the leaf back together, both exact; `shard_tree` and
`gather_tree` do so leaf by leaf. `launch.dryrun` uses the same rules for
a rank's parameter bytes and for batch splitting.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from repro_torch import tree as T

Spec = Tuple
Mesh = Dict[str, int]

COL = {"q", "k", "v", "gate", "up", "in_x", "in_gate", "z", "x", "B", "C",
       "dt", "W_a", "W_i", "unembed", "fc"}
ROW = {"o", "down", "out"}
EXPERT = {"gate_proj", "up_proj", "down_proj"}


def _path_names(path) -> Tuple[str, ...]:
    return tuple(f"[{p}]" if isinstance(p, int) else str(p) for p in path)


def _shape(leaf) -> Tuple[int, ...]:
    """A leaf's shape: a tensor's, a shape tuple itself, () for a
    scalar."""
    if isinstance(leaf, tuple):
        return leaf
    return tuple(getattr(leaf, "shape", ()))


def param_spec(path, shape, mode: str) -> Spec:
    """The spec of the parameter at `path` (a `tree` path) of `shape`."""
    names = _path_names(path)
    ndim = len(shape)
    fsdp = mode == "fsdp"

    def lead(spec_tail):
        """Pad with Nones so the spec has one entry per dim."""
        return (None,) * (ndim - len(spec_tail)) + tuple(spec_tail)

    name = names[-1]
    parent = names[-2] if len(names) >= 2 else ""

    # --- embeddings -------------------------------------------------------- #
    if name == "embed":
        return ("model", None)
    if name == "pos":
        return (None, None)
    if parent == "unembed" and name == "w":
        return (None, "model")

    # --- small/replicated -------------------------------------------------- #
    if name in ("scale", "bias", "lam", "A_log", "D", "dt_bias"):
        return lead(())
    if parent in ("conv", "router") or name == "conv":
        return lead(())

    # --- experts ----------------------------------------------------------- #
    if parent in EXPERT or name in EXPERT:
        which = name if name in EXPERT else parent
        if which == "down_proj":  # (E, ff, d)
            return lead(("model", None, "data" if fsdp else None))
        return lead(("model", "data" if fsdp else None, None))  # (E, d, ff)

    # --- linears {w, b} ---------------------------------------------------- #
    if name == "w":
        if parent in COL:
            return lead(("data" if fsdp else None, "model"))
        if parent in ROW:
            return lead(("model", "data" if fsdp else None))
        return lead(())
    if name == "b":
        if parent in COL:
            return lead(("model",))
        return lead(())

    return lead(())


def _axes(entry) -> Tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def sanitize_spec(spec: Spec, shape, mesh: Mesh) -> Spec:
    """Drop any sharded axis that does not evenly divide its dimension."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ent in zip(shape, entries):
        if ent is None:
            out.append(None)
            continue
        n = math.prod(mesh[a] for a in _axes(ent))
        out.append(ent if dim % n == 0 else None)
    return tuple(out)


def param_specs(params, cfg, mode: str, mesh: Optional[Mesh] = None):
    """Spec tree mirroring `params` (tensors, meta tensors or shapes)."""
    del cfg
    paths, leaves = T.flatten(params)
    specs = []
    for path, leaf in zip(paths, leaves):
        shape = _shape(leaf)
        spec = param_spec(path, shape, mode)
        if mesh is not None:
            spec = sanitize_spec(spec, shape, mesh)
        specs.append(spec)
    return T.unflatten(paths, specs)


def local_shape(shape, spec: Spec, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of one device's shard of a tensor of `shape` under `spec`
    (a dimension's axes must divide it: `sanitize_spec` first)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    out = []
    for dim, ent in zip(shape, entries):
        n = 1 if ent is None else math.prod(mesh[a] for a in _axes(ent))
        if dim % n:
            raise ValueError(f"local_shape: {n} shards do not divide dim "
                             f"{dim} of {tuple(shape)} under {spec}")
        out.append(dim // n)
    return tuple(out)


def model_axis(spec: Optional[Spec]) -> Optional[int]:
    """The dimension a spec shards over 'model', or None."""
    for i, ent in enumerate(spec or ()):
        if ent is not None and "model" in _axes(ent):
            return i
    return None


def shard_of(leaf, spec: Optional[Spec], index: int, size: int):
    """Model rank `index` of `size`'s shard of the full `leaf` under its
    (sanitised) spec: a view of its slice, or the leaf itself when the
    spec shards nothing over 'model'."""
    ax = model_axis(spec)
    if ax is None or size == 1:
        return leaf
    n = leaf.shape[ax] // size
    return leaf.narrow(ax, index * n, n)


def gather_to_full(shard, spec: Optional[Spec], group):
    """The full leaf from the model ranks' shards (`shard_of`'s inverse):
    an all-gather over `group` (a `parallel.tensor.ModelGroup`) along the
    spec's 'model' dimension; the shard itself when nothing is sharded.
    The one place a rank holds a whole sharded leaf."""
    ax = model_axis(spec)
    if ax is None or group is None or group.size == 1:
        return shard
    return group.all_gather(shard, ax)


def shard_tree(tree, specs, index: int, size: int, copy: bool = True):
    """Every leaf of `tree` cut to rank `index`'s shard (copies, so the
    full leaves can be freed, unless `copy` is False)."""
    paths, leaves = T.flatten(tree)
    sp = T.flatten_up_to(paths, specs)
    out = []
    for x, s in zip(leaves, sp):
        y = shard_of(x, s, index, size)
        out.append(y.clone() if copy and y is not x else y)
    return T.unflatten(paths, out)


def gather_tree(tree, specs, group):
    """Every leaf of `tree` (a rank's shards) gathered to the full leaf."""
    paths, leaves = T.flatten(tree)
    sp = T.flatten_up_to(paths, specs)
    return T.unflatten(paths, [gather_to_full(x, s, group)
                               for x, s in zip(leaves, sp)])


def global_shape(local, spec: Optional[Spec], size: int):
    """The full shape of a leaf whose rank-local shape is `local`."""
    ax = model_axis(spec)
    out = list(local)
    if ax is not None:
        out[ax] *= size
    return tuple(out)


# --------------------------------------------------------------------------- #
# batches and caches
# --------------------------------------------------------------------------- #
def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh)


def batch_spec(mesh: Mesh, batch_size: int) -> Spec:
    """The batch dim over as many data axes, in order, as divide it (one
    axis by its name, several as a tuple)."""
    n = 1
    chosen = []
    for a in batch_axes(mesh):
        if batch_size % (n * mesh[a]) == 0:
            chosen.append(a)
            n *= mesh[a]
    if not chosen:
        return (None,)
    return (chosen[0] if len(chosen) == 1 else tuple(chosen),)


def cache_spec(path, shape, mesh: Mesh, batch_size: int,
               kv_layout: str = "hd_model") -> Spec:
    """Decode caches: batch over data axes when divisible; KV sharded over
    'model' on head_dim ("hd_model", default) or on the sequence axis
    ("seq_model"). Rest replicated."""
    names = _path_names(path)
    in_scan = "scan" in names
    b_axes = batch_spec(mesh, batch_size)[0]
    model_n = mesh.get("model", 1)
    name = names[-1]
    ndim = len(shape)
    off = 1 if in_scan else 0  # leading stacked-period axis

    def build(entries):
        pad = ndim - off - len(entries)
        return (None,) * off + tuple(entries) + (None,) * pad

    if name == "pos" or ndim - off == 0:
        return (None,) * ndim
    if name in ("k", "v"):                     # (B, S, K, hd)
        seq = shape[off + 1]
        hd = shape[off + 3]
        if kv_layout == "hd_model" and hd % model_n == 0:
            return build([b_axes, None, None, "model"])
        seq_ax = "model" if seq % model_n == 0 else None
        return build([b_axes, seq_ax])
    if name == "h" and ndim - off == 4:        # ssd state (B, H, P, N)
        heads = shape[off + 1]
        return build([b_axes, "model" if heads % model_n == 0 else None])
    if name == "h":                            # rglru state (B, w)
        w = shape[off + 1]
        return build([b_axes, "model" if w % model_n == 0 else None])
    if name == "conv":                         # (B, width-1, C)
        ch = shape[off + 2]
        return build([b_axes, None, "model" if ch % model_n == 0 else None])
    if name == "enc_out":                      # (B, Se, d)
        return build([b_axes, None, None])
    return (None,) * ndim


def cache_specs(caches, mesh: Mesh, batch_size: int,
                kv_layout: str = "hd_model"):
    """Spec tree mirroring `caches` (an empty slot, None, stays None)."""
    paths, leaves = T.flatten(caches)
    return T.unflatten(paths, [
        None if l is None else
        cache_spec(p, _shape(l), mesh, batch_size, kv_layout)
        for p, l in zip(paths, leaves)])
