"""Multi-process runs — one process per device.

Port of :mod:`deap_tpu.parallel.multihost`. The JAX package forms its
runtime mesh with ``jax.distributed``; the port forms a
``torch.distributed`` process group, one rank a device: ``nccl`` on
cards (each rank on ``cuda:<local rank>``), ``gloo`` on the CPU. Every
rank then runs the same program, and the meshes and plans of
:mod:`deap_tpu_torch.parallel` span the group.

Run one process per device, e.g. ``torchrun --nproc-per-node=4
script.py`` with, in ``script.py``::

    parallel.initialize()                  # reads torchrun's variables
    plan = parallel.ShardingPlan.for_population()
    ... the same program on every rank ...

or, without a launcher, ``initialize("127.0.0.1:29500", 4, rank,
device="cpu")`` in each of four processes.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch

from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.parallel.mesh import Mesh, _world, population_mesh

__all__ = [
    "initialize",
    "is_distributed",
    "global_population_mesh",
    "process_count",
    "process_index",
]

#: the launcher variables (torchrun's) that say a process is one of many
_CLUSTER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def _cluster_env() -> bool:
    return any(os.environ.get(k) for k in _CLUSTER_VARS)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: DeviceLike = None,
               timeout_s: Optional[float] = None) -> None:
    """Join (or form) the process group.

    With no arguments and no launcher environment (``MASTER_ADDR``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``) this is a no-op, so the same
    ``main()`` runs alone or under ``torchrun``. Otherwise it wraps
    ``torch.distributed.init_process_group``: ``coordinator_address``
    (``"host:port"``, rank 0's TCP store) or the launcher's
    ``MASTER_ADDR``/``MASTER_PORT``; ``num_processes`` and
    ``process_id`` or ``WORLD_SIZE``/``RANK``. On the card (the default
    ``device``) the backend is ``nccl``, after
    ``torch.cuda.set_device(local rank)``; with ``device="cpu"`` it is
    ``gloo``. A group already formed is left as it is."""
    import torch.distributed as dist
    if (coordinator_address is None and num_processes is None
            and process_id is None and not _cluster_env()):
        return
    if dist.is_initialized():
        return
    dev = resolve_device(device)
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    rank = int(process_id if process_id is not None
               else os.environ.get("RANK", 0))
    init = ("env://" if coordinator_address is None
            else f"tcp://{coordinator_address}")
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        kwargs["device_id"] = torch.device("cuda", local)
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank, **kwargs)


def is_distributed() -> bool:
    """Whether this process is one of several ranks."""
    return _world()[0] > 1


def process_count() -> int:
    """The process group's world size (1 with no group)."""
    return _world()[0]


def process_index() -> int:
    """This process's rank (0 with no group)."""
    return _world()[1]


def global_population_mesh(axis_names: Sequence[str] = ("pop",),
                           shape: Optional[Sequence[int]] = None,
                           device: DeviceLike = None) -> Mesh:
    """A mesh over every rank of the process group:
    :func:`~deap_tpu_torch.parallel.population_mesh` with its default
    device count, spelled separately so multi-process intent is explicit
    in user code."""
    return population_mesh(None, axis_names, shape, device=device)
