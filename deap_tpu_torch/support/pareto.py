"""ParetoArchive — a capacity-bounded non-dominated archive on the device.

Port of :mod:`deap_tpu.support.pareto`: the archive keeps every
individual no other seen so far dominates, dropping members that become
dominated. Shapes are static, so it has a fixed capacity and an overflow
drops the lexicographically worst members.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.core.fitness import FitnessSpec, dominates, lex_sort_desc
from deap_tpu_torch.core.population import Population
from deap_tpu_torch.support.hof import duplicate_mask


@dataclasses.dataclass(frozen=True)
class ParetoArchive:
    genomes: Any
    fitness: torch.Tensor  # [capacity, nobj]
    filled: torch.Tensor   # [capacity] bool
    spec: FitnessSpec = FitnessSpec((1.0,))

    @property
    def capacity(self) -> int:
        return self.filled.shape[0]


def pareto_init(capacity: int, pop: Population) -> ParetoArchive:
    """An empty archive shaped like ``capacity`` copies of one
    individual."""
    zeros = lambda a: torch.zeros((capacity,) + tuple(a.shape[1:]),
                                  dtype=a.dtype, device=a.device)
    return ParetoArchive(
        genomes=pytree.tree_map(zeros, pop.genomes),
        fitness=torch.zeros((capacity, pop.nobj), dtype=pop.fitness.dtype,
                            device=pop.device),
        filled=torch.zeros(capacity, dtype=torch.bool, device=pop.device),
        spec=pop.spec,
    )


def nondominated_mask(w: torch.Tensor, valid: Optional[torch.Tensor] = None,
                      chunk: int = 512) -> torch.Tensor:
    """``bool[n]``: valid rows no valid row dominates, computed a chunk of
    rows at a time so memory is O(chunk · n · nobj)."""
    n = w.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=w.device)
    out = torch.empty(n, dtype=torch.bool, device=w.device)
    for s in range(0, n, chunk):
        dom = dominates(w[None, :, :], w[s:s + chunk, None, :]) & valid
        out[s:s + chunk] = valid[s:s + chunk] & ~dom.any(1)
    return out


def pareto_update(archive: ParetoArchive, pop: Population,
                  dedup: bool = True) -> ParetoArchive:
    """Merge a population into the archive: the pool (archive and
    population) is cut to its non-dominated rows, deduplicated on genome
    equality, lex-sorted best first and truncated at capacity."""
    cap = archive.capacity
    cat = lambda a, b: torch.cat([a, b], dim=0)
    all_g = pytree.tree_map(cat, archive.genomes, pop.genomes)
    all_f = cat(archive.fitness, pop.fitness)
    all_valid = cat(archive.filled, pop.valid)

    w = all_f * archive.spec.warray(all_f.device)
    w = torch.where(all_valid[:, None], w, -torch.inf)
    nd = nondominated_mask(w, all_valid)
    if dedup:
        nd = nd & ~duplicate_mask(all_g, w, all_valid)

    order = lex_sort_desc(torch.where(nd[:, None], w, -torch.inf))[:cap]
    take = lambda a: a[order]
    return ParetoArchive(
        genomes=pytree.tree_map(take, all_g),
        fitness=take(all_f),
        filled=take(nd),
        spec=archive.spec,
    )
