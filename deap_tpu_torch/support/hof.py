"""HallOfFame — fixed-capacity best-ever archive, resident on the device.

Port of :mod:`deap_tpu.support.hof`: the population's rows are merged
with the archive, lex-sorted best-first with a genome hash as the last
tie-key, exact duplicates dropped, and the result truncated — static
shapes, no pairwise matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.core.fitness import FitnessSpec, lexsort
from deap_tpu_torch.core.population import Population


@dataclasses.dataclass(frozen=True)
class HallOfFame:
    genomes: Any
    fitness: torch.Tensor  # [k, nobj]
    filled: torch.Tensor   # [k] bool
    spec: FitnessSpec = FitnessSpec((1.0,))

    @property
    def maxsize(self) -> int:
        return self.filled.shape[0]

    @property
    def wvalues(self) -> torch.Tensor:
        w = self.fitness * self.spec.warray(self.fitness.device)
        return torch.where(self.filled[:, None], w, -torch.inf)


def hof_init(maxsize: int, pop: Population) -> HallOfFame:
    """Empty archive shaped like ``maxsize`` copies of one individual."""
    zeros = lambda a: torch.zeros((maxsize,) + tuple(a.shape[1:]),
                                  dtype=a.dtype, device=a.device)
    return HallOfFame(
        genomes=pytree.tree_map(zeros, pop.genomes),
        fitness=torch.zeros((maxsize, pop.nobj), dtype=pop.fitness.dtype,
                            device=pop.device),
        filled=torch.zeros(maxsize, dtype=torch.bool, device=pop.device),
        spec=pop.spec,
    )


_HASH_MULT = -1640531527  # 0x9E3779B9 as int32


def _genome_hash(genomes) -> torch.Tensor:
    """int32 hash per row with wrap-around arithmetic. Equal genomes hash
    equal; used only as a sort tie-key so duplicates land adjacent."""
    leaves = pytree.tree_leaves(genomes)
    n = leaves[0].shape[0]
    dev = leaves[0].device
    h = torch.zeros(n, dtype=torch.int32, device=dev)
    for leaf in leaves:
        flat = leaf.reshape(n, -1)
        if flat.dtype.is_floating_point:
            ints = flat.to(torch.float32).view(torch.int32)
        else:
            ints = flat.to(torch.int32)
        mult = (torch.arange(flat.shape[1], dtype=torch.int32, device=dev)
                * _HASH_MULT + 97)
        h = h * 31 + (ints * mult).sum(-1, dtype=torch.int32)
    return h


def _adjacent_dup(sorted_w, sorted_h, sorted_genomes, sorted_valid):
    """dup[i]: row i is an exact-genome duplicate of row i-1 in the
    (wvalues, hash) order, where all copies of a genome are adjacent."""
    same = (sorted_w[1:] == sorted_w[:-1]).all(-1)
    same &= sorted_h[1:] == sorted_h[:-1]
    for leaf in pytree.tree_leaves(sorted_genomes):
        flat = leaf.reshape(leaf.shape[0], -1)
        same &= (flat[1:] == flat[:-1]).all(-1)
    same &= sorted_valid[1:] & sorted_valid[:-1]
    return torch.cat([torch.zeros(1, dtype=torch.bool, device=same.device),
                      same])


def _hof_order(w: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    # jnp.lexsort keys (hash, -w[nobj-1], ..., -w[0]): w[0] primary
    return lexsort([h] + [-w[:, j] for j in range(w.shape[1] - 1, -1, -1)])


def duplicate_mask(genomes, w: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """bool[n] in the original order: the row duplicates an earlier (in
    (w, hash) order) valid row."""
    h = _genome_hash(genomes)
    order = _hof_order(w, h)
    sg = pytree.tree_map(lambda a: a[order], genomes)
    dup_sorted = _adjacent_dup(w[order], h[order], sg, valid[order])
    out = torch.zeros_like(valid)
    out[order] = dup_sorted
    return out


def hof_update(hof: HallOfFame, pop: Population,
               dedup: bool = True) -> HallOfFame:
    """Merge a population into the archive: pool = archive ∪ population,
    sorted best-first (hash as last tie-key), deduplicated on exact
    genome equality, truncated to ``maxsize``."""
    k = hof.maxsize
    cat = lambda a, b: torch.cat([a, b], dim=0)
    all_g = pytree.tree_map(cat, hof.genomes, pop.genomes)
    all_f = cat(hof.fitness, pop.fitness)
    all_valid = cat(hof.filled, pop.valid)

    w = all_f * hof.spec.warray(all_f.device)
    w = torch.where(all_valid[:, None], w, -torch.inf)
    h = _genome_hash(all_g)
    order = _hof_order(w, h)
    # index_select: a row gather without advanced indexing's overhead
    take = lambda a: a.index_select(0, order)
    all_g = pytree.tree_map(take, all_g)
    all_f, all_valid, w, h = take(all_f), take(all_valid), take(w), take(h)

    keep = all_valid
    if dedup:
        keep = keep & ~_adjacent_dup(w, h, all_g, all_valid)

    perm = torch.sort((~keep).to(torch.uint8), stable=True).indices[:k]
    return HallOfFame(
        genomes=pytree.tree_map(lambda a: a[perm], all_g),
        fitness=all_f[perm],
        filled=keep[perm],
        spec=hof.spec,
    )


def hof_best(hof: HallOfFame):
    """Best genome + fitness (the reference's ``hof[0]``)."""
    return pytree.tree_map(lambda a: a[0], hof.genomes), hof.fitness[0]
