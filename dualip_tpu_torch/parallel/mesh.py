"""The entity mesh of a sharded solve on ``torch.distributed``
(``dualip_tpu/parallel/mesh.py``).

The JAX package runs one program over a 1-D ``jax.sharding.Mesh``: tiles
shard along the entity axis, duals replicate, and XLA inserts one all-reduce
of the (m,) gradient and two scalars per iteration.  Here the same layout runs
as one process per rank: rank d holds the entity shard the JAX package places
on device d, every rank holds the whole dual, and each evaluation does one
``all_reduce`` of one flat buffer.  NCCL carries it between GPUs, gloo on the
CPU (and for several ranks that share one card, which NCCL refuses).

Launching: ``torchrun --nproc-per-node=G script.py`` with the script calling
``initialize_multihost("env://")`` (NCCL, one process per GPU), or
``parallel/launch.py::run_ranks`` (spawned ranks, the CPU tests' way).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Union

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0

LAUNCH_HINT = (
    "launch one process per rank and initialise the process group first: "
    "`torchrun --nproc-per-node=<ranks> script.py` with the script calling "
    "dualip_tpu_torch.parallel.initialize_multihost('env://'), or "
    "dualip_tpu_torch.parallel.run_ranks(fn, world_size, ...)"
)


@dataclass(frozen=True)
class EntityMesh:
    """One rank's view of the 1-D entity mesh: its process group (``None``
    is the default group), its rank and the world size in that group, and
    the device its shard and its copy of the dual live on."""

    group: object
    rank: int
    world_size: int
    device: torch.device

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; every rank gets the same bits."""
        dist.all_reduce(t, group=self.group)
        return t

    def backend(self) -> str:
        """The group's backend (``"nccl"``, ``"gloo"``)."""
        return str(dist.get_backend(self.group))

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``t`` (same shape on all), in rank order."""
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(out, t, group=self.group)
        return out

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def is_rank_zero() -> bool:
    """True outside a process group and on its rank 0: where MLflow logs and
    checkpoints are written."""
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _rank_device(rank: int) -> torch.device:
    """``cuda:{LOCAL_RANK}`` (the rank in the default group when unset);
    raises when that device is absent."""
    idx = int(os.environ.get("LOCAL_RANK", rank))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if idx >= count:
        raise RuntimeError(
            f"rank {rank} takes cuda:{idx} (LOCAL_RANK), but this host has {count} CUDA device(s); "
            "pass device= (e.g. 'cpu', or one card that several gloo ranks share) to choose another")
    return torch.device("cuda", idx)


def default_mesh(
    n_devices: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    group=None,
) -> EntityMesh:
    """The mesh over the initialised default group (or ``group``), whose world
    size must be ``n_devices`` when given.  The rank's device is ``device``
    when given, else ``cuda:{LOCAL_RANK}``, which must exist (no wrap-around,
    no fall back to the CPU)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a sharded solve needs an initialised torch.distributed process group: {LAUNCH_HINT}")
    world = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"requested {n_devices} ranks but the process group has {world}")
    rank = dist.get_rank(group)
    dev = _rank_device(dist.get_rank()) if device is None else torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)  # NCCL's barrier and object collectives use the current device
    return EntityMesh(group=group, rank=rank, world_size=world, device=dev)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    backend: Optional[str] = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Initialise the default process group; a no-op without an address or
    when a group is already initialised (as the JAX package's).

    ``coordinator_address``: ``"env://"`` (torchrun's variables), a URL, or
    ``host:port`` (``tcp://`` is added).  ``world_size``/``rank`` default to
    ``WORLD_SIZE``/``RANK``.  The backend follows ``device`` (NCCL for cuda,
    gloo for cpu) unless named.  ``timeout_s`` bounds every collective, so a
    rank whose peer died fails instead of waiting for ever."""
    if coordinator_address is None or dist.is_initialized():
        return
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kw = {}
    if url != "env://":
        kw = dict(world_size=int(os.environ["WORLD_SIZE"] if world_size is None else world_size),
                  rank=int(os.environ["RANK"] if rank is None else rank))
    dist.init_process_group(backend, init_method=url, timeout=datetime.timedelta(seconds=timeout_s), **kw)
