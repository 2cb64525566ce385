"""The process mesh of the port (counterpart of `repro.launch.mesh`): the
`torch.distributed` process group DQGAN's workers are spread over, as a
(data, model) grid.

The JAX package lays its devices out as a ('data', 'model') mesh: its
workers along `data` under `shard_map`, tensor parallelism along
`model`. Here each process is one rank, and rank r sits at data index
r // model and model index r % model (the device order of the JAX
package's `make_mesh((data, model))`). W workers split over the data
ranks in contiguous blocks of L = W / data, data index i holding workers
i·L .. i·L + L − 1 (the rows a sharding of the leading worker axis over
the data axis gives); every model rank of a data index holds the same
workers. `data_group` (the ranks of one model index) carries the
exchange (`core.exchange.ProcessGroupWorkers`), `model_group` (the ranks
of one data index) the field's tensor-parallel collectives
(`parallel.tensor`). With model 1 the data group is the whole world.

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

    def __post_init__(self):
        if self.model < 1 or self.world % self.model:
            raise ValueError(f"ProcessMesh: a model axis of {self.model} "
                             f"does not divide {self.world} ranks")

    @property
    def data(self) -> int:
        """The size of the data axis (world / model)."""
        return self.world // self.model

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    @property
    def shape(self) -> Dict[str, int]:
        """{axis: size}, as `parallel.sharding` reads a mesh."""
        return {"data": self.data, "model": self.model}

    @classmethod
    def init(cls, rank: int, world: int, *, device_type: str = "cuda",
             local_rank: Optional[int] = None, store=None,
             init_method: Optional[str] = None,
             timeout_s: float = 300.0, model: int = 1,
             backend: Optional[str] = None) -> "ProcessMesh":
        """Join (or form) the default process group: `store` (e.g.
        `dist.HashStore()` for one process, a `FileStore`) or
        `init_method` (`file://...`, `env://`, `tcp://localhost:...`).
        `model` > 1 gives the mesh a model axis of that size and builds
        its data and model groups. `backend` overrides the device type's
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
                   model=model)
        if model > 1:
            mesh._build_groups()
        return mesh

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
        data index. Refuses a W the data axis does not divide."""
        D = self.data
        if n_workers < D or n_workers % D:
            raise ValueError(f"ProcessMesh: {n_workers} workers do not split "
                             f"over {D} data ranks")
        n_local = n_workers // D
        return self.data_index * n_local, n_local

    def describe(self) -> Optional[dict]:
        """The mesh as the JAX package's checkpoints record it
        ({"axis_names", "shape"}), or None for one process."""
        if self.world == 1:
            return None
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


def meta_mesh(world: int, rank: int = 0, model: int = 1) -> ProcessMesh:
    """Rank `rank` of `world` on the meta device, with a model axis of
    `model` and no process group: a trainer over it runs one rank's step
    on meta tensors, its collectives' results made and their
    communication left out (`core.exchange.MetaWorkers`,
    `parallel.tensor.MetaModelGroup`). What `launch.dryrun` traces."""
    if not 0 <= rank < world:
        raise ValueError(f"meta_mesh: rank {rank} is not one of {world}")
    return ProcessMesh(rank=rank, world=world, device=torch.device("meta"),
                       backend="meta", model=model)


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
