"""Device meshes, population placement and the plan-mode selection.

Port of :mod:`deap_tpu.parallel.mesh`. PyTorch runs one process per
device, so a mesh of W devices is W ranks of a ``torch.distributed``
process group, each rank on its own device (``cuda:<local rank>`` on
cards, the CPU under ``gloo``), laid out as a
:class:`torch.distributed.device_mesh.DeviceMesh` with named axes:

- ``"pop"``    — data-parallel population sharding;
- ``"island"`` — one block of demes per rank, migration over a ring;
- ``"genome"`` — the feature axis of very large genomes.

A one-device mesh needs no process group. A mesh of several devices
needs an initialised group of that world size
(:func:`deap_tpu_torch.parallel.initialize`); without one it raises,
and never quietly builds one device. The default device count is the
world size (1 with no group). A one-device mesh inside an initialised
group still carries a ``DeviceMesh``, so collectives over it run
through the group's backend.

:func:`sharding_mode` keeps the JAX package's name ``'pjit'`` for the
plan's global formulation, the only one the port has (it needs
``torch.distributed`` and ``DeviceMesh``, which the port requires).
:func:`sharding_fallback` journals every place a plan consumer runs
replicated work, once per (where, reason).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.core.population import Population
from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.support.profiling import span

__all__ = ["Mesh", "population_mesh", "shard_population", "sharding_mode",
           "sharding_fallback"]


# ------------------------------------------------- plan-mode selection ----

def sharding_mode() -> str:
    """``'pjit'``: the plan's global formulation runs (the loops compute
    the same bits on any rank count, the plan splits their per-row
    work). The JAX name is kept so journal rows and ``describe()``
    compare."""
    return "pjit"


_FALLBACK_SEEN: set = set()


def sharding_fallback(where: str, reason: str, **ctx) -> None:
    """Journal a ``sharding_fallback`` event: a plan consumer runs
    work replicated on every rank. Deduplicated per (where, reason);
    the first occurrence always lands in every open journal."""
    key = (where, reason)
    if key in _FALLBACK_SEEN:
        return
    _FALLBACK_SEEN.add(key)
    from deap_tpu_torch.telemetry.journal import broadcast
    broadcast("sharding_fallback", where=where, reason=reason,
              mode=sharding_mode(), **ctx)


# ---------------------------------------------------------------- mesh ----

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of devices with named axes, as one process sees it:
    ``devices`` lists each rank's device in row-major order of
    ``shape``, ``rank`` is this process's index among them and
    ``device_mesh`` the ``DeviceMesh`` of an initialised process group
    (``None`` for a one-device mesh without a group)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    rank: int = 0
    device_mesh: Any = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @property
    def device(self) -> torch.device:
        """This process's device."""
        return self.devices[self.rank]

    @property
    def size(self) -> int:
        return len(self.devices)

    def axis_size(self, axis: str) -> int:
        return self.shape[self._axis(axis)]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        i = self._axis(axis)
        stride = math.prod(self.shape[i + 1:])
        return (self.rank // stride) % self.shape[i]

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (``None``
        without a ``DeviceMesh``)."""
        self._axis(axis)
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def _axis(self, axis: str) -> int:
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        return self.axis_names.index(axis)


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _visible(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def population_mesh(n_devices: Optional[int] = None,
                    axis_names: Sequence[str] = ("pop",),
                    shape: Optional[Sequence[int]] = None,
                    device: DeviceLike = None) -> Mesh:
    """A mesh over ``n_devices`` ranks (default: the process group's
    world size, 1 with no group) on the card, or on the CPU with
    ``device="cpu"``: a 1-D ``("pop",)`` mesh unless ``axis_names`` and
    ``shape`` say otherwise. A mesh of several devices needs an
    initialised process group of that world size
    (:func:`deap_tpu_torch.parallel.initialize`)."""
    dev = resolve_device(device)
    if _visible(dev) < 1:
        raise ValueError(f"no device for a mesh on {dev}")
    world, rank = _world()
    count = world if n_devices is None else int(n_devices)
    if count < 1:
        raise ValueError(f"a mesh needs at least one device, got {count}")
    if count > 1 and world == 1:
        raise ValueError(
            f"a mesh of {count} devices needs a process group of {count} "
            f"ranks, one a device: call deap_tpu_torch.parallel.initialize "
            f"first (or run under torchrun)")
    if count > 1 and count != world:
        raise ValueError(f"a mesh of {count} devices in a process group of "
                         f"{world} ranks: the port's meshes span the group")
    axis_names = tuple(axis_names)
    shape = ((count,) + (1,) * (len(axis_names) - 1) if shape is None
             else tuple(int(s) for s in shape))
    if len(shape) != len(axis_names) or math.prod(shape) != count:
        raise ValueError(f"a mesh of {count} devices has no shape {shape} "
                         f"over {axis_names}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if count == 1 and (world > 1 or not _group_backed()):
        return Mesh((dev,), axis_names, shape)
    from torch.distributed.device_mesh import DeviceMesh
    dm = DeviceMesh(dev.type, torch.arange(count).reshape(shape),
                    mesh_dim_names=axis_names)
    if dev.type == "cuda":
        local = torch.cuda.device_count()
        devices = tuple(torch.device("cuda", r % local)
                        for r in range(count))
        devices = devices[:rank] + (dev,) + devices[rank + 1:]
    else:
        devices = (dev,) * count
    return Mesh(devices, axis_names, shape, rank, dm)


def _group_backed() -> bool:
    """A process group of one rank is initialised: its one-device meshes
    carry a ``DeviceMesh`` so their collectives run through it."""
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def _block(n: int, parts: int, index: int) -> Tuple[int, int]:
    if n % parts:
        raise ValueError(f"{n} rows do not split into {parts} equal blocks")
    size = n // parts
    return index * size, (index + 1) * size


def shard_population(pop: Population, mesh: Mesh,
                     axis: str = "pop") -> Population:
    """``pop`` placed on the mesh with its individual axis sharded over
    ``axis``: every leaf (genomes, fitness, valid, extras) on this rank's
    device, cut to this rank's block of rows along ``axis`` (the whole
    population on a one-device axis). The rows must split evenly."""
    size = mesh.axis_size(axis)
    lo, hi = _block(pop.size, size, mesh.axis_index(axis))
    with span("mesh/reshard"):
        if (lo, hi) != (0, pop.size):
            cut = lambda a: a[lo:hi]
            pop = pop.replace(genomes=pytree.tree_map(cut, pop.genomes),
                              fitness=cut(pop.fitness), valid=cut(pop.valid),
                              extras=pytree.tree_map(cut, pop.extras))
        return pop.to(mesh.device)
