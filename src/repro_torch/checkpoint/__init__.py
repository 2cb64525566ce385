"""Checkpointing (counterpart of `repro.checkpoint`): any tree of the port
(a `DQState`, a params dict) as a flat dict of numpy arrays in an `.npz`,
or as a `repro-sharded-v1` directory, in the JAX package's layout, so
either package restores what the other saved.

The layout, as `repro.checkpoint` writes it:
  * a leaf's name is the `/`-join of its path: NamedTuple field names,
    dict keys (sorted, as `jax.tree` visits them; bucket ids are the
    string keys "0", "1", ...) and list indices;
  * `None` subtrees have no leaves and are skipped;
  * bfloat16 leaves are stored as uint16 views under `__bf16__<name>`;
  * `__meta__` is the JSON record {"step", "names", **meta} (the run's
    strategy under "strategy");
  * a Python int leaf (the port's `DQState.step`) is a 0-d int32 array,
    as JAX writes its step.
Restoring into the structure of `like` puts each leaf on the device of
the corresponding leaf of `like` (or on `device`), in the saved dtype.

Across processes (a `DQState` whose W workers are spread over the ranks of
a `core.exchange.ProcessGroupWorkers`, each rank holding L rows of the
per-worker fields prev_grad, ef, sched and fsdp): pass the backend as
`workers`. A save gathers the per-worker rows and rank 0 writes exactly
what a one-process save of the same global state writes (a sharded save
then defaults to one shard a rank, as the JAX package defaults to one a
process); a restore reads the file and each rank keeps its own rows.

Across a model axis (a `DQState` whose model-sharded leaves each rank
holds a slice of): pass `shards`, a `ModelShards` (`DQGAN.state_shards`)
saying how each sharded leaf is cut. A save gathers the slices over the
model group first (`parallel.sharding.gather_to_full`), so the file holds
the JAX package's full leaves; a restore slices each rank's part. The
file does not depend on the mesh it was saved from, so a checkpoint
crosses mesh shapes (a (2, 2) save resumes on one process and the other
way round) and packages. Under the fsdp layout a leaf is cut over the
data ranks as well (`ShardedLeaf.data_axis`, gathered over the fsdp
group), and a Mode-B save is the same file again.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _children(tree) -> Optional[List[Tuple[str, Any]]]:
    """(key, subtree) pairs of a tree node in `jax.tree` order, or None
    for a leaf."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return list(zip(tree._fields, tree))
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), x) for i, x in enumerate(tree)]
    return None


def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(name, leaf) of every leaf, `None` subtrees skipped."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, sub in kids:
        out += _paths(sub, f"{prefix}/{k}" if prefix else k)
    return out


def _rebuild(like, leaves):
    """`like`'s structure with its leaves taken in order from the iterator
    `leaves`."""
    if like is None:
        return None
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(x, leaves) for x in like))
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


# the DQState fields whose leaves lead with the worker axis (fsdp: each
# owner's shard rows)
PER_WORKER_FIELDS = ("prev_grad", "ef", "sched", "fsdp")


@dataclasses.dataclass(frozen=True)
class ShardedLeaf:
    """How one sharded leaf is stored: its trailing shape on a rank
    (`local`) and in the file (`full`), the shape `view` (on a rank) that
    its elements are a reshape of, and the dimension `axis` of the view
    the model ranks split (None: none) and `data_axis` the data ranks
    split (the fsdp layout; None: none). For a parameter's shard (or its
    residual e1) the view is its own shape; two_phase's owner residual e2
    is stored, as the JAX package stores it, as its moved chunk reshaped
    to the leaf's axis order, and the view is that chunk."""
    local: Tuple[int, ...]
    full: Tuple[int, ...]
    view: Tuple[int, ...]
    axis: Optional[int]
    data_axis: Optional[int] = None


@dataclasses.dataclass
class ModelShards:
    """The sharded leaves of a tree, {leaf name: ShardedLeaf}, the model
    group (a `parallel.tensor.ModelGroup`) and, under the fsdp layout, the
    fsdp group (a `parallel.fsdp.FsdpGroup`) whose ranks hold them.
    Leading axes beyond the trailing shapes (the worker axis, the delayed
    ring) pass through."""
    leaves: Dict[str, ShardedLeaf]
    group: Any
    data_group: Any = None

    def _cuts(self, sl):
        """[(view dimension, group)] of each cut of the leaf."""
        return [(ax, g) for ax, g in ((sl.axis, self.group),
                                      (sl.data_axis, self.data_group))
                if ax is not None and g is not None and g.size > 1]

    def _full_view(self, sl):
        v = list(sl.view)
        for ax, g in self._cuts(sl):
            v[ax] *= g.size
        return tuple(v)

    def gather(self, tree):
        """`tree` with each sharded leaf gathered to the full leaf (a
        collective: every rank of the groups calls it)."""
        def full(sl, x):
            lead = tuple(x.shape[:x.dim() - len(sl.local)])
            y = x.reshape(lead + sl.view)
            for ax, g in self._cuts(sl):
                y = g.all_gather(y, len(lead) + ax)
            return y.reshape(lead + sl.full)
        return _rebuild(tree, iter(
            full(self.leaves[n], x) if n in self.leaves else x
            for n, x in _paths(tree)))

    def take(self, arr, name):
        """This rank's part of a saved full array."""
        sl = self.leaves.get(name)
        if sl is None:
            return arr
        lead = tuple(arr.shape[:arr.ndim - len(sl.full)])
        out = arr.reshape(lead + self._full_view(sl))
        for ax, g in self._cuts(sl):
            c = sl.view[ax]
            out = np.take(out, range(g.index * c, (g.index + 1) * c),
                          axis=len(lead) + ax)
        return np.ascontiguousarray(out).reshape(lead + sl.local)

    def full_shape(self, name, shape):
        sl = self.leaves.get(name)
        if sl is None:
            return tuple(shape)
        return tuple(shape[:len(shape) - len(sl.local)]) + sl.full


def _spread(workers) -> bool:
    """True when `workers` holds only some of the W workers' rows."""
    return workers is not None and workers.n_local != workers.n


def _per_worker(name: str) -> bool:
    return name.split("/", 1)[0] in PER_WORKER_FIELDS


def gather_workers(state, workers):
    """`state` with every per-worker leaf all-gathered to its W rows (a
    collective: every rank calls it). Identity when one process holds all
    of them."""
    if not _spread(workers):
        return state
    fields = {}
    for f in PER_WORKER_FIELDS:
        sub = getattr(state, f, None)
        if sub is not None:
            fields[f] = _rebuild(sub, iter(workers.all_gather(x)
                                           for _, x in _paths(sub)))
    return state._replace(**fields)


def _take_rows(arr, name, workers):
    """This rank's rows of a saved per-worker array."""
    if not (_spread(workers) and _per_worker(name)):
        return arr
    return arr[workers.offset:workers.offset + workers.n_local]


def _mesh(workers):
    """The process mesh of a worker backend spread over processes, or
    None (one process)."""
    mesh = getattr(workers, "mesh", None)
    return mesh if mesh is not None and mesh.world > 1 else None


def _is_writer(workers) -> bool:
    return _mesh(workers) is None or workers.mesh.rank == 0


def _done(workers):
    if _mesh(workers) is not None:
        workers.mesh.barrier()


def _to_numpy(leaf) -> Tuple[np.ndarray, bool]:
    """(array, is bfloat16) of a leaf; bfloat16 as its uint16 view."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    if isinstance(leaf, (bool, int)):
        return np.asarray(leaf, np.int32), False
    return np.asarray(leaf), False


def _to_leaf(arr: np.ndarray, bf16: bool, like, device):
    """A saved array as the leaf `like` stands for: an int for an int, a
    tensor on `device` (or like's device) otherwise."""
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    if bf16:
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if device is None and isinstance(like, torch.Tensor) \
            and like.device.type != "meta":
        device = like.device
    return t.to(device) if device is not None else t


def _mismatch(path, kind, missing, extra, advice):
    return ValueError(
        f"{kind} {path!r} does not match the requested state structure: "
        f"missing {missing[:5]}{'...' if len(missing) > 5 else ''}"
        + (f", checkpoint-only {extra[:5]}"
           f"{'...' if len(extra) > 5 else ''}" if extra else "")
        + advice)


def save(path: str, tree: Any, step: Optional[int] = None,
         meta: Optional[dict] = None, workers=None,
         shards: Optional[ModelShards] = None) -> None:
    """Save a tree; `meta` entries (e.g. the run's serialized strategy
    under "strategy") go into the archive's __meta__ record and are read
    back with `read_meta`. With `workers` spread over ranks, every rank
    calls it and rank 0 writes the gathered state (`shards`: the
    model-sharded leaves gathered first)."""
    reserved = {"step", "names"} & set(meta or {})
    if reserved:
        raise ValueError(
            f"checkpoint meta keys {sorted(reserved)} are reserved for the "
            f"internal __meta__ record")
    if shards is not None:
        tree = shards.gather(tree)
    tree = gather_workers(tree, workers)
    if _is_writer(workers):
        _write_npz(path, tree, step, meta)
    _done(workers)


def _write_npz(path, tree, step, meta):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    named = _paths(tree)
    arrays = {}
    for name, leaf in named:
        arr, bf16 = _to_numpy(leaf)
        arrays[("__bf16__" if bf16 else "") + name] = arr
    record = {"step": step, "names": [n for n, _ in named], **(meta or {})}
    with open(path, "wb") as f:
        np.savez(f, __meta__=json.dumps(record), **arrays)


def restore(path: str, like: Any, device=None, workers=None,
            shards: Optional[ModelShards] = None) -> Any:
    """Restore into the structure of `like` (whose leaves may be tensors on
    any device, `meta` tensors included, or ints). With `workers` spread
    over ranks, `like` holds this rank's rows and gets them; with
    `shards`, its slices of the model-sharded leaves."""
    with np.load(path, allow_pickle=False) as z:
        data = {}
        for k in z.files:
            if k == "__meta__":
                continue
            if k.startswith("__bf16__"):
                data[k[len("__bf16__"):]] = (z[k], True)
            else:
                data[k] = (z[k], False)
    named = _paths(like)
    want = {n for n, _ in named}
    missing = sorted(want - set(data))
    if missing:
        raise _mismatch(path, "checkpoint", missing, sorted(set(data) - want),
                        " — restore with the same config (schedule/"
                        "comm_plan/optimizer/...) the checkpoint was saved "
                        "under")
    return _rebuild(like, iter(
        _to_leaf(_take_shard(_take_rows(data[n][0], n, workers), n, shards),
                 data[n][1], leaf, device) for n, leaf in named))


def _take_shard(arr, name, shards):
    return arr if shards is None else shards.take(arr, name)


def read_meta(path: str) -> dict:
    """The checkpoint's __meta__ record (step, names, embedded extras)."""
    if is_sharded(path):
        return read_manifest(path)
    with np.load(path, allow_pickle=False) as z:
        if "__meta__" not in z.files:
            raise ValueError(
                f"{path!r} is not a repro checkpoint: no __meta__ record "
                f"in the archive")
        return json.loads(str(z["__meta__"]))


def latest_step(path: str) -> Optional[int]:
    if not os.path.exists(path):
        return None
    return read_meta(path).get("step")


# --------------------------------------------------------------------------- #
# the sharded format: a DIRECTORY of one .npz per shard plus a manifest.
# Leaves whose leading axis divides by the shard count are split along
# axis 0; every other leaf goes whole to one shard, round-robin. Restore
# concatenates the chunks back, whatever the shard count.
# --------------------------------------------------------------------------- #
_MANIFEST = "manifest.json"
_SHARDED_FORMAT = "repro-sharded-v1"


def _shard_file(i: int, n: int) -> str:
    return f"shard-{i:05d}-of-{n:05d}.npz"


def is_sharded(path: str) -> bool:
    """True when `path` is a sharded-checkpoint directory."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, _MANIFEST))


def save_sharded(path: str, tree: Any, step: Optional[int] = None,
                 meta: Optional[dict] = None, n_shards: Optional[int] = None,
                 mesh: Optional[dict] = None, workers=None,
                 shards: Optional[ModelShards] = None) -> None:
    """Save a tree as a sharded-checkpoint directory of `n_shards` files
    (default one a process: 1, or the world size of `workers` spread over
    ranks, whose rank 0 writes the gathered state; `shards`: the
    model-sharded leaves gathered first). `mesh` ({"axis_names",
    "shape"}, or None for one device) is recorded in the manifest for
    provenance."""
    reserved = {"step", "names", "format", "n_shards", "leaves",
                "mesh"} & set(meta or {})
    if reserved:
        raise ValueError(
            f"checkpoint meta keys {sorted(reserved)} are reserved for "
            f"the manifest")
    if shards is not None:
        tree = shards.gather(tree)
    tree = gather_workers(tree, workers)
    if n_shards is None and _mesh(workers) is not None:
        n_shards = workers.mesh.world
    if _is_writer(workers):
        _write_sharded(path, tree, step, meta, n_shards, mesh)
    _done(workers)


def _write_sharded(path, tree, step, meta, n_shards, mesh):
    H = int(n_shards or 1)
    os.makedirs(path, exist_ok=True)
    named = _paths(tree)
    leaves_rec = {}
    shard_data = [dict() for _ in range(H)]
    rr = 0  # round-robin cursor for unsplit leaves
    for name, leaf in named:
        arr, bf16 = _to_numpy(leaf)
        split = arr.ndim >= 1 and arr.shape[0] >= H and arr.shape[0] % H == 0
        rec = {"shape": list(arr.shape),
               "dtype": "bfloat16" if bf16 else str(arr.dtype),
               "split": bool(split), "chunks": []}
        if split:
            c = arr.shape[0] // H
            for i in range(H):
                rec["chunks"].append([i, i * c, c])
                shard_data[i][f"{name}@{i * c}"] = arr[i * c:(i + 1) * c]
        else:
            owner = rr % H
            rr += 1
            rec["chunks"].append([owner, 0,
                                  int(arr.shape[0]) if arr.ndim else 0])
            shard_data[owner][f"{name}@0"] = arr
        leaves_rec[name] = rec
    for i in range(H):
        with open(os.path.join(path, _shard_file(i, H)), "wb") as f:
            np.savez(f, **shard_data[i])
    manifest = {
        "format": _SHARDED_FORMAT,
        "step": step,
        "n_shards": H,
        "names": [n for n, _ in named],
        "leaves": leaves_rec,
        "mesh": mesh,
        **(meta or {}),
    }
    tmp = os.path.join(path, _MANIFEST + ".tmp")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, _MANIFEST))


def read_manifest(path: str) -> dict:
    mf = os.path.join(path, _MANIFEST)
    if not os.path.exists(mf):
        raise ValueError(
            f"{path!r} is not a sharded repro checkpoint: no {_MANIFEST}")
    with open(mf) as f:
        manifest = json.load(f)
    if manifest.get("format") != _SHARDED_FORMAT:
        raise ValueError(
            f"{path!r}: unknown sharded checkpoint format "
            f"{manifest.get('format')!r} (want {_SHARDED_FORMAT!r})")
    return manifest


def restore_sharded(path: str, like: Any, device=None, workers=None,
                    shards: Optional[ModelShards] = None) -> Any:
    """Restore a sharded-checkpoint directory into the structure of
    `like`; the shard count it was saved with does not matter. With
    `workers` spread over ranks, `like` holds this rank's rows and gets
    them; with `shards`, its slices of the model-sharded leaves."""
    manifest = read_manifest(path)
    H = manifest["n_shards"]
    missing_files = [f for f in (_shard_file(i, H) for i in range(H))
                     if not os.path.exists(os.path.join(path, f))]
    if missing_files:
        raise ValueError(
            f"sharded checkpoint {path!r} is incomplete: missing shard "
            f"file(s) {missing_files[:4]}"
            f"{'...' if len(missing_files) > 4 else ''}")
    named = _paths(like)
    recs = manifest["leaves"]
    want = {n for n, _ in named}
    missing = sorted(want - set(recs))
    if missing:
        raise _mismatch(path, "sharded checkpoint", missing,
                        sorted(set(recs) - want),
                        " — restore with the same config the checkpoint was "
                        "saved under")
    def expected(name, leaf):
        shape = tuple(leaf.shape)
        if shards is not None:
            shape = shards.full_shape(name, shape)
        if _spread(workers) and _per_worker(name):
            return (workers.n,) + shape[1:]
        return shape

    bad_shapes = [
        f"{name}: saved {tuple(recs[name]['shape'])} != "
        f"expected {expected(name, leaf)}"
        for name, leaf in named
        if hasattr(leaf, "shape")
        and tuple(recs[name]["shape"]) != expected(name, leaf)]
    if bad_shapes:
        raise ValueError(
            f"sharded checkpoint {path!r} leaf shapes do not match the "
            "requested state:\n  " + "\n  ".join(bad_shapes[:6])
            + ("\n  ..." if len(bad_shapes) > 6 else "")
            + "\n— per-worker state (EF residuals, fsdp shard slots) is "
            "laid out by worker count and cannot reshard across a "
            "different mesh; resume on the saved worker count, or "
            "restore the params subtree only")
    files = {}

    def shard(i):
        if i not in files:
            files[i] = np.load(os.path.join(path, _shard_file(i, H)),
                               allow_pickle=False)
        return files[i]

    out = []
    try:
        for name, leaf in named:
            rec = recs[name]
            parts = [shard(fi)[f"{name}@{start}"]
                     for fi, start, _ in sorted(rec["chunks"],
                                                key=lambda c: c[1])]
            arr = np.concatenate(parts, axis=0) if rec["split"] else parts[0]
            arr = _take_shard(_take_rows(arr.reshape(rec["shape"]), name,
                                         workers), name, shards)
            out.append(_to_leaf(arr, rec["dtype"] == "bfloat16", leaf,
                                device))
    finally:
        for z in files.values():
            z.close()
    return _rebuild(like, iter(out))


# strategy fields that affect neither the DQState layout nor the training
# semantics, so a resume may change them freely: the host-side wall-clock
# model's straggler profile, and the observability knobs.
_HOST_ONLY_FIELDS = ("participation.straggler_profile", "observability.")


def verify_strategy(path: str, strategy: Any) -> None:
    """Fail fast when `path` was saved under a different distribution
    strategy than the resuming run's — a mismatched resume would silently
    reinterpret the DQState.sched slots (accum vs pending ring) and EF
    layout. Raises ValueError with the field-level diff (host-only fields
    like the straggler profile are exempt). Checkpoints without an
    embedded strategy pass with a warning."""
    from repro_torch.strategy import Strategy

    saved_json = read_meta(path).get("strategy")
    if saved_json is None:
        import warnings
        warnings.warn(
            f"checkpoint {path!r} has no embedded strategy; resume "
            f"compatibility cannot be verified", stacklevel=2)
        return
    saved = Strategy.from_json(saved_json)
    lines = [ln for ln in saved.diff(strategy)
             if not ln.startswith(_HOST_ONLY_FIELDS)]
    if lines:
        raise ValueError(
            f"checkpoint {path!r} was saved under a different strategy "
            f"than this run (saved != current):\n  " + "\n  ".join(lines)
            + "\n— resume with the saved strategy, or start a fresh run")
