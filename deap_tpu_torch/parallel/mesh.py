"""Device mesh and population placement, on one device.

Port of what ``bench_suite.py``'s cart-pole configuration calls of
:mod:`deap_tpu.parallel.mesh`: :func:`population_mesh` and
:func:`shard_population`. The JAX package shards the population over a
``jax.sharding.Mesh`` and lets XLA insert the collectives; the port runs
on one card, so a mesh here is one device and placing a population on it
moves every leaf there. A mesh of more than one device raises
``NotImplementedError``: sharding over several cards (``DeviceMesh``,
``torch.distributed``) is the rest of ``parallel``, still to port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from deap_tpu_torch.core.population import Population
from deap_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["Mesh", "population_mesh", "shard_population"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A mesh of devices with named axes (``devices`` in row-major order
    of ``shape``). The port's meshes hold one device."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def device(self) -> torch.device:
        """The mesh's one device."""
        return self.devices[0]


def _visible(device: torch.device) -> int:
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1


def population_mesh(n_devices: Optional[int] = None,
                    axis_names: Sequence[str] = ("pop",),
                    shape: Optional[Sequence[int]] = None,
                    device: DeviceLike = None) -> Mesh:
    """A mesh over the first ``n_devices`` visible devices (all by
    default) of the card (or of the CPU with ``device="cpu"``), a 1-D
    ``("pop",)`` mesh unless ``axis_names`` and ``shape`` say otherwise.
    Raises ``NotImplementedError`` for more than one device."""
    dev = resolve_device(device)
    count = _visible(dev) if n_devices is None else int(n_devices)
    if count > 1:
        raise NotImplementedError(
            f"a mesh of {count} devices: the port shards over one device "
            f"only; several cards come with the rest of parallel (ROADMAP "
            f"A12)")
    if count < 1 or _visible(dev) < 1:
        raise ValueError(f"no device for a mesh on {dev}")
    axis_names = tuple(axis_names)
    shape = (1,) * len(axis_names) if shape is None else tuple(
        int(s) for s in shape)
    if len(shape) != len(axis_names) or any(s != 1 for s in shape):
        raise ValueError(f"a one-device mesh has shape (1, ...) over "
                         f"{axis_names}, got {shape}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh((dev,), axis_names, shape)


def shard_population(pop: Population, mesh: Mesh,
                     axis: str = "pop") -> Population:
    """``pop`` with every leaf (genomes, fitness, valid, extras) on the
    mesh's device, its individual axis "sharded" over ``axis``: on one
    device, the whole population."""
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh has no axis {axis!r}: {mesh.axis_names}")
    return pop.to(mesh.device)
