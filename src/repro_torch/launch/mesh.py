"""The process mesh of the port (counterpart of `repro.launch.mesh`): the
`torch.distributed` process group DQGAN's workers are spread over, as a
(data, model) grid, or, under the `fsdp` parameter layout, a (pod, data,
model) one.

The JAX package lays its devices out as a ('data', 'model') mesh (('pod',
'data', 'model') across pods) and picks the DQGAN worker axes by its
parameter layout (`worker_axes_for`). Here each process is one rank, in
the device order of the JAX package's `make_mesh`.

Layout "dp" (Mode A): rank r sits at data index r // model and model
index r % model. W workers split over the data ranks in contiguous
blocks of L = W / data, data index i holding workers i·L .. i·L + L − 1
(the rows a sharding of the leading worker axis over the data axis
gives); every model rank of a data index holds the same workers. The
exchange group is `data_group` (the ranks of one model index; the whole
world with model 1); `model_group` (the ranks of one data index) carries
the field's tensor-parallel collectives (`parallel.tensor`).

Layout "fsdp" (Mode B): rank r sits at pod r // (data·model), data index
(r // model) % data and model index r % model. The workers are the pods
(W = pods, one a pod), and each rank holds its shard of every parameter
cut over its data and model indices (`parallel.sharding`, layout
"fsdp"). Three groups: the exchange group (the ranks of one (data, model)
index across the pods: `core.exchange.ProcessGroupWorkers`), the fsdp
group (one (pod, model) index across data: the field's parameter
all-gathers and gradient reduce-scatters, `parallel.fsdp`) and the model
group (one (pod, data) index across model).

Backends: `nccl` with one CUDA device a rank (`cuda:LOCAL_RANK`), `gloo`
for the CPU. There is no fallback from one to the other, and none from the
card to the CPU: a CUDA mesh without a CUDA device raises.

`production_mesh_shape` and `worker_axes_for` describe the JAX package's
production meshes for `launch.dryrun`; `meta_mesh` is one rank of a
world of them on the meta device, for a traced step.

The JAX module's XLA overlap flags (`OVERLAP_XLA_FLAGS`,
`enable_overlap_flags`) have no torch counterpart: the port overlaps the
delayed schedule's exchange with the field by issuing it on a second CUDA
stream (`core.dqgan`), which needs no process-wide setting.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
LAYOUTS = ("dp", "fsdp")


def _backend(device_type: str) -> str:
    if device_type not in BACKENDS:
        raise ValueError(f"ProcessMesh: no backend for device type "
                         f"{device_type!r}; have {sorted(BACKENDS)}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ProcessMesh: a CUDA mesh needs a CUDA device "
                           "(pass device_type='cpu' for gloo on the CPU)")
    return BACKENDS[device_type]


@dataclasses.dataclass
class ProcessMesh:
    """One rank's view of the default process group: `rank` of `world`
    and its `device`. Build it with `from_env` under `torchrun`, or `init`
    with a store or an init method; `close` destroys the group it made."""

    rank: int
    world: int
    device: torch.device
    backend: str
    model: int = 1
    data_group: object = None     # None: the default group
    model_group: object = None    # None with model 1
    layout: str = "dp"
    pods: int = 1
    fsdp_group: object = None     # fsdp: one (pod, model) index's ranks
    exchange_group: object = None  # fsdp: one (data, model) index's ranks

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"ProcessMesh: layout {self.layout!r} is not "
                             f"one of {LAYOUTS}")
        if self.pods > 1 and self.layout != "fsdp":
            raise ValueError("ProcessMesh: a pod axis needs the fsdp layout "
                             "(under dp every data rank of every pod is a "
                             "worker: fold the pods into the data axis)")
        n = self.model * self.pods
        if self.model < 1 or self.pods < 1 or self.world % n:
            raise ValueError(f"ProcessMesh: {self.pods} pod(s) of a model "
                             f"axis of {self.model} do not divide "
                             f"{self.world} ranks")

    @property
    def fsdp(self) -> bool:
        """True under the fsdp parameter layout (Mode B)."""
        return self.layout == "fsdp"

    @property
    def data(self) -> int:
        """The size of the data axis (world / (pods · model))."""
        return self.world // (self.model * self.pods)

    @property
    def pod_index(self) -> int:
        return self.rank // (self.data * self.model)

    @property
    def data_index(self) -> int:
        return (self.rank // self.model) % self.data

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def n_exchange(self) -> int:
        """The ranks the workers spread over: the data ranks under dp, the
        pods under fsdp."""
        return self.pods if self.fsdp else self.data

    @property
    def exchange_index(self) -> int:
        return self.pod_index if self.fsdp else self.data_index

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as `parallel.sharding` reads a mesh."""
        if self.pods > 1:
            return {"pod": self.pods, "data": self.data, "model": self.model}
        return {"data": self.data, "model": self.model}

    @classmethod
    def init(cls, rank: int, world: int, *, device_type: str = "cuda",
             local_rank: Optional[int] = None, store=None,
             init_method: Optional[str] = None,
             timeout_s: float = 300.0, model: int = 1,
             backend: Optional[str] = None, layout: str = "dp",
             pods: int = 1) -> "ProcessMesh":
        """Join (or form) the default process group: `store` (e.g.
        `dist.HashStore()` for one process, a `FileStore`) or
        `init_method` (`file://...`, `env://`, `tcp://localhost:...`).
        `model` > 1 gives the mesh a model axis of that size and builds
        its data and model groups; `layout="fsdp"` the Mode-B mesh of
        `pods` pods and its three groups. `backend` overrides the device
        type's
        (gloo over CUDA tensors, where ranks share one card: NCCL takes
        one rank a device)."""
        backend = backend or _backend(device_type)
        if device_type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ProcessMesh: a CUDA mesh needs a CUDA "
                               "device")
        local = rank if local_rank is None else local_rank
        if device_type == "cuda":
            device = torch.device("cuda", local)
            torch.cuda.set_device(device)
        else:
            device = torch.device("cpu")
        kw = dict(backend=backend, rank=rank, world_size=world,
                  timeout=datetime.timedelta(seconds=timeout_s))
        if store is not None:
            kw["store"] = store
        else:
            kw["init_method"] = init_method or "env://"
        if device_type == "cuda" and backend == "nccl":
            kw["device_id"] = device
        dist.init_process_group(**kw)
        mesh = cls(rank=rank, world=world, device=device, backend=backend,
                   model=model, layout=layout, pods=pods)
        if mesh.fsdp and world > 1:
            mesh._build_fsdp_groups()
        elif model > 1:
            mesh._build_groups()
        return mesh

    def _build_fsdp_groups(self) -> None:
        """The exchange, fsdp and model groups of a Mode-B mesh (`groups`);
        every rank makes every group, in one order."""
        mine = {}
        for kind, members in groups(self.pods, self.data, self.model):
            g = dist.new_group(members)
            if self.rank in members:
                mine[kind] = g
        self.exchange_group = mine["exchange"]
        self.fsdp_group = mine["fsdp"]
        self.model_group = mine["model"]

    def _build_groups(self) -> None:
        """The data groups (one a model index) and the model groups (one a
        data index); every rank makes every group, in one order."""
        M, D = self.model, self.data
        for j in range(M):
            g = dist.new_group([i * M + j for i in range(D)])
            if j == self.model_index:
                self.data_group = g
        for i in range(D):
            g = dist.new_group([i * M + j for j in range(M)])
            if i == self.data_index:
                self.model_group = g

    @classmethod
    def from_env(cls, device_type: str = "cuda", model: int = 1
                 ) -> "ProcessMesh":
        """The mesh `torchrun` describes (RANK, WORLD_SIZE, LOCAL_RANK,
        MASTER_ADDR/MASTER_PORT), with a model axis of `model`."""
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"ProcessMesh.from_env: {missing} not set "
                               f"(launch with torchrun)")
        return cls.init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                        device_type=device_type,
                        local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                        init_method="env://", model=model)

    def rows(self, n_workers: int) -> Tuple[int, int]:
        """(offset, L): this rank's block of the W workers, those of its
        data index (its pod under fsdp, where W is the pod count). Refuses
        a W the exchange ranks do not divide."""
        D = self.n_exchange
        if self.fsdp and n_workers != D:
            raise ValueError(f"ProcessMesh: under the fsdp layout the "
                             f"workers are the {D} pod(s), not {n_workers}")
        if n_workers < D or n_workers % D:
            raise ValueError(f"ProcessMesh: {n_workers} workers do not split "
                             f"over {D} data ranks")
        n_local = n_workers // D
        return self.exchange_index * n_local, n_local

    @property
    def exchange(self):
        """The process group the exchange runs over (None: the default
        group)."""
        return self.exchange_group if self.fsdp else self.data_group

    def describe(self) -> Optional[dict]:
        """The mesh as the JAX package's checkpoints record it
        ({"axis_names", "shape"}), or None for one process."""
        if self.world == 1:
            return None
        if self.fsdp:
            return {"axis_names": ["pod", "data", "model"],
                    "shape": [self.pods, self.data, self.model]}
        return {"axis_names": ["data", "model"],
                "shape": [self.data, self.model]}

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def groups(pods: int, data: int, model: int):
    """[(kind, member ranks)] of every group of a Mode-B mesh, in the order
    every rank makes them: "exchange" (one (data, model) index across the
    pods), "fsdp" (one (pod, model) index across data), "model" (one (pod,
    data) index across model). Rank (p, i, j) is p·data·model + i·model +
    j, the device order of the JAX package's make_mesh."""
    def rank(p, i, j):
        return (p * data + i) * model + j
    out = [("exchange", [rank(p, i, j) for p in range(pods)])
           for i in range(data) for j in range(model)]
    out += [("fsdp", [rank(p, i, j) for i in range(data)])
            for p in range(pods) for j in range(model)]
    out += [("model", [rank(p, i, j) for j in range(model)])
            for p in range(pods) for i in range(data)]
    return out


def meta_mesh(world: int, rank: int = 0, model: int = 1, layout: str = "dp",
              pods: int = 1) -> ProcessMesh:
    """Rank `rank` of `world` on the meta device, with a model axis of
    `model` (and, under layout "fsdp", `pods` pods) and no process group:
    a trainer over it runs one rank's step
    on meta tensors, its collectives' results made and their
    communication left out (`core.exchange.MetaWorkers`,
    `parallel.tensor.MetaModelGroup`). What `launch.dryrun` traces."""
    if not 0 <= rank < world:
        raise ValueError(f"meta_mesh: rank {rank} is not one of {world}")
    return ProcessMesh(rank=rank, world=world, device=torch.device("meta"),
                       backend="meta", model=model, layout=layout, pods=pods)


# --------------------------------------------------------------------------- #
# the JAX package's production meshes, as {axis: size}
# --------------------------------------------------------------------------- #
def production_mesh_shape(multi_pod: bool = False,
                          override: str = "") -> Dict[str, int]:
    """The JAX package's production mesh as an ordered {axis: size} dict:
    one pod (16, 16) ('data', 'model') = 256 devices; two pods (2, 16,
    16) ('pod', 'data', 'model') = 512. `override` ("64,4" / "2,32,8")
    re-splits the same devices across the axes. The port's ranks take the
    same grid: `launch.dryrun` traces one rank of it, its 'model' axis
    sharding the parameters and the workers over 'pod' × 'data'."""
    if override:
        shape = tuple(int(x) for x in override.split(","))
        assert len(shape) in (2, 3)
        axes = (("pod",) if len(shape) == 3 else ()) + ("data", "model")
        expected = 512 if multi_pod else 256
        assert (len(shape) == 3) == multi_pod
        assert math.prod(shape) == expected, (shape, expected)
    else:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def worker_axes_for(layout: str, multi_pod: bool) -> Tuple[str, ...]:
    """The JAX package's DQGAN worker axes by parameter layout:
    dp -> every data-parallel rank is a worker; fsdp -> each pod is."""
    if layout == "dp":
        return ("pod", "data") if multi_pod else ("data",)
    if layout == "fsdp":
        return ("pod",) if multi_pod else ()
    raise ValueError(layout)
