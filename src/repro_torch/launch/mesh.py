"""The process mesh of the port (counterpart of `repro.launch.mesh`): the
`torch.distributed` process group DQGAN's workers are spread over.

The JAX package lays its workers out along a `data` mesh axis of devices
and runs them under `shard_map`. Here each process of a group is one rank;
W workers split over the `world` ranks in contiguous blocks of
L = W / world, rank r holding workers r·L .. r·L + L − 1 (the rows a
sharding of the leading worker axis over the ranks gives, as the JAX
package shards it over `worker_axes`). `core.exchange.ProcessGroupWorkers`
runs the collectives over the group.

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

    @classmethod
    def init(cls, rank: int, world: int, *, device_type: str = "cuda",
             local_rank: Optional[int] = None, store=None,
             init_method: Optional[str] = None,
             timeout_s: float = 300.0) -> "ProcessMesh":
        """Join (or form) the default process group: `store` (e.g.
        `dist.HashStore()` for one process, a `FileStore`) or
        `init_method` (`file://...`, `env://`, `tcp://localhost:...`)."""
        backend = _backend(device_type)
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
        if device_type == "cuda":
            kw["device_id"] = device
        dist.init_process_group(**kw)
        return cls(rank=rank, world=world, device=device, backend=backend)

    @classmethod
    def from_env(cls, device_type: str = "cuda") -> "ProcessMesh":
        """The mesh `torchrun` describes (RANK, WORLD_SIZE, LOCAL_RANK,
        MASTER_ADDR/MASTER_PORT)."""
        missing = [k for k in ("RANK", "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(f"ProcessMesh.from_env: {missing} not set "
                               f"(launch with torchrun)")
        return cls.init(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                        device_type=device_type,
                        local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                        init_method="env://")

    def rows(self, n_workers: int) -> Tuple[int, int]:
        """(offset, L): this rank's block of the W workers. Refuses a W the
        world size does not divide."""
        if n_workers < self.world or n_workers % self.world:
            raise ValueError(f"ProcessMesh: {n_workers} workers do not split "
                             f"over {self.world} ranks")
        n_local = n_workers // self.world
        return self.rank * n_local, n_local

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def close(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def meta_mesh(world: int, rank: int = 0) -> ProcessMesh:
    """Rank `rank` of `world` on the meta device, with no process group:
    a trainer over it runs one rank's step on meta tensors, its
    collectives' results made and their communication left out
    (`core.exchange.MetaWorkers`). What `launch.dryrun` traces."""
    if not 0 <= rank < world:
        raise ValueError(f"meta_mesh: rank {rank} is not one of {world}")
    return ProcessMesh(rank=rank, world=world, device=torch.device("meta"),
                       backend="meta")


# --------------------------------------------------------------------------- #
# the JAX package's production meshes, as {axis: size}
# --------------------------------------------------------------------------- #
def production_mesh_shape(multi_pod: bool = False,
                          override: str = "") -> Dict[str, int]:
    """The JAX package's production mesh as an ordered {axis: size} dict:
    one pod (16, 16) ('data', 'model') = 256 devices; two pods (2, 16,
    16) ('pod', 'data', 'model') = 512. `override` ("64,4" / "2,32,8")
    re-splits the same devices across the axes. The port spreads its
    workers over ranks and has no 'model' axis: `launch.dryrun` uses the
    mesh for its device count, batch split and the reference layout's
    per-device parameter bytes."""
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
