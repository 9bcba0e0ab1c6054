"""Population as a struct of tensors.

Port of :mod:`deap_tpu.core.population`. The whole population is one
frozen dataclass of tensors sharing a leading population axis:

- ``genomes``: a ``[n, L]`` tensor, or a dict/tuple of such tensors;
- ``fitness``: ``f32[n, nobj]`` raw objective values;
- ``valid``: ``bool[n]`` — "fitness was not deleted"; loops re-evaluate
  exactly the invalid rows;
- ``extras``: per-individual auxiliary tensors;
- ``spec``: the :class:`FitnessSpec` weights.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device


@dataclasses.dataclass(frozen=True)
class Population:
    genomes: Any
    fitness: torch.Tensor
    valid: torch.Tensor
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spec: FitnessSpec = FitnessSpec((1.0,))

    @property
    def size(self) -> int:
        return self.fitness.shape[0]

    @property
    def nobj(self) -> int:
        return self.fitness.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.fitness.device

    @property
    def wvalues(self) -> torch.Tensor:
        """Weighted values; invalid rows are -inf in every objective, so
        they sort last and never dominate."""
        w = self.fitness * self.spec.warray(self.device)
        return torch.where(self.valid[:, None], w, -torch.inf)

    def replace(self, **changes) -> "Population":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "Population":
        move = lambda a: a.to(device)
        return self.replace(genomes=pytree.tree_map(move, self.genomes),
                            fitness=move(self.fitness),
                            valid=move(self.valid),
                            extras=pytree.tree_map(move, self.extras))

    def with_fitness(self, values: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> "Population":
        """Assign raw objective values; ``mask`` limits the rows updated.
        Updated rows become valid."""
        values = values.to(self.fitness.dtype)
        if values.ndim == 1:
            values = values[:, None]
        if mask is None:
            return self.replace(fitness=values,
                                valid=torch.ones_like(self.valid))
        fit = torch.where(mask[:, None], values, self.fitness)
        return self.replace(fitness=fit, valid=self.valid | mask)

    def invalidate(self, mask: torch.Tensor) -> "Population":
        """Mark rows for re-evaluation."""
        return self.replace(valid=self.valid & ~mask)


def init_population(generator: torch.Generator, n: int,
                    init_genome: Callable[[torch.Generator, int], Any],
                    spec: FitnessSpec,
                    extras_init: Optional[Dict[str, Callable]] = None,
                    device: DeviceLike = None) -> Population:
    """An ``n``-individual population from a batched initialiser
    ``init_genome(generator, n) -> [n, ...]`` (see :mod:`ops.init`),
    drawn on ``device`` — the card unless ``device="cpu"``."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    genomes = init_genome(generator, n)
    extras = {name: fn(generator, n)
              for name, fn in (extras_init or {}).items()}
    return Population(
        genomes=genomes,
        fitness=torch.zeros((n, spec.nobj), dtype=torch.float32, device=dev),
        valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        extras=extras,
        spec=spec,
    )


def gather(pop: Population, idx: torch.Tensor) -> Population:
    """Select individuals by index — the functional ``toolbox.clone``."""
    take = lambda a: a[idx]
    return pop.replace(
        genomes=pytree.tree_map(take, pop.genomes),
        fitness=take(pop.fitness),
        valid=take(pop.valid),
        extras=pytree.tree_map(take, pop.extras),
    )


def concat(pops: Sequence[Population]) -> Population:
    """Concatenate populations along the individual axis."""
    cat = lambda *xs: torch.cat(xs, dim=0)
    first = pops[0]
    return first.replace(
        genomes=pytree.tree_map(cat, *[p.genomes for p in pops]),
        fitness=cat(*[p.fitness for p in pops]),
        valid=cat(*[p.valid for p in pops]),
        extras=pytree.tree_map(cat, *[p.extras for p in pops]),
    )
