"""Genealogy tracking — the lineage counterpart of ``tools.History``.

Port of :mod:`deap_tpu.support.history`. Ids live on the device as an
int32 tensor beside the population: each generation, selection gives an
index tensor into the previous population, and :func:`lineage_step`
turns it into fresh child ids plus an ``int32[n, max_parents]``
parent-id record, all as tensor operations. The host-side
:class:`History` accumulates those records into the genealogy dict the
reference exposes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from deap_tpu_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class Lineage:
    """Device-resident lineage state.

    - ``ids``: int32[n] — the current population's individual ids.
    - ``next_id``: int32 scalar — the next unassigned id (ids start at 1,
      like the reference's ``index`` counter).
    """

    ids: torch.Tensor
    next_id: torch.Tensor


def lineage_init(n: int, device: DeviceLike = None) -> Lineage:
    """Ids 1..n for the founding population, on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    return Lineage(ids=torch.arange(1, n + 1, dtype=torch.int32, device=dev),
                   next_id=torch.tensor(n + 1, dtype=torch.int32, device=dev))


def lineage_step(lineage: Lineage, parent_idx: torch.Tensor
                 ) -> Tuple[Lineage, torch.Tensor]:
    """Advance one generation.

    ``parent_idx``: ``[n_children, max_parents]`` indices into the
    previous population (a 1-D tensor: one parent a child). Returns the
    new lineage (fresh consecutive ids for every child) and the
    ``int32[n_children, max_parents]`` parent-id record for
    :meth:`History.record`."""
    parent_idx = torch.as_tensor(parent_idx, device=lineage.ids.device).to(
        torch.int64)
    if parent_idx.ndim == 1:
        parent_idx = parent_idx[:, None]
    n_children = parent_idx.shape[0]
    parent_ids = lineage.ids[parent_idx]
    child_ids = lineage.next_id + torch.arange(
        n_children, dtype=torch.int32, device=lineage.ids.device)
    return (Lineage(ids=child_ids, next_id=lineage.next_id + n_children),
            parent_ids)


def pair_parents(sel_idx: torch.Tensor, cx_mask: torch.Tensor
                 ) -> torch.Tensor:
    """The varAnd parent-index matrix from a selection index vector:
    pairs (0,1), (2,3), ... cross where ``cx_mask`` (bool[n // 2]) says
    so. Children that crossed get both pair members as parents; the
    others their own slot twice."""
    sel_idx = torch.as_tensor(sel_idx).to(torch.int32)
    cx_mask = torch.as_tensor(cx_mask, device=sel_idx.device)
    n = sel_idx.shape[0]
    ar = torch.arange(n, dtype=torch.int32, device=sel_idx.device)
    partner = ar ^ 1
    partner = torch.where(partner < n, partner, ar)
    # an odd trailing individual has no pair, hence never crosses
    crossed = torch.zeros(n, dtype=torch.bool, device=sel_idx.device)
    crossed[: 2 * cx_mask.shape[0]] = cx_mask.repeat_interleave(2)[:n]
    other = torch.where(crossed, sel_idx[partner.long()], sel_idx)
    return torch.stack([sel_idx, other], dim=1)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class History:
    """Host-side genealogy accumulator.

    ``genealogy_tree`` maps child id → tuple of parent ids;
    ``genealogy_history`` maps generation → array of child ids born that
    generation. Feed it the per-generation ``parent_ids`` records of
    :func:`lineage_step` (a whole stacked ``[gens, n, p]`` record through
    :meth:`record_scan`).
    """

    def __init__(self) -> None:
        self.genealogy_tree: Dict[int, Tuple[int, ...]] = {}
        self.genealogy_history: Dict[int, np.ndarray] = {}
        self._next_id = 1
        self._gen = 0

    def found(self, n: int) -> None:
        """Register the founding population (ids 1..n, no parents)."""
        ids = np.arange(self._next_id, self._next_id + n)
        for i in ids:
            self.genealogy_tree[int(i)] = ()
        self.genealogy_history[self._gen] = ids
        self._next_id += n

    def record(self, parent_ids) -> None:
        """Record one generation: row i of ``parent_ids`` lists the
        parent ids of that generation's i-th child (1-D: one parent a
        child)."""
        parent_ids = _host(parent_ids)
        if parent_ids.ndim == 1:
            parent_ids = parent_ids[:, None]
        n = parent_ids.shape[0]
        self._gen += 1
        ids = np.arange(self._next_id, self._next_id + n)
        for i, row in zip(ids, parent_ids):
            uniq = tuple(dict.fromkeys(int(p) for p in row))
            self.genealogy_tree[int(i)] = uniq
        self.genealogy_history[self._gen] = ids
        self._next_id += n

    def record_scan(self, stacked_parent_ids) -> None:
        """Record a whole run: ``[gens, n, max_parents]``."""
        for gen_rec in _host(stacked_parent_ids):
            self.record(gen_rec)

    def get_genealogy(self, ind_id: int, max_depth: float = float("inf")
                      ) -> Dict[int, Tuple[int, ...]]:
        """Ancestor subgraph of ``ind_id`` up to ``max_depth``
        generations: a breadth-first walk with a visited set, so a shared
        ancestor is expanded once, at its shallowest depth."""
        out: Dict[int, Tuple[int, ...]] = {}
        seen = {int(ind_id)}
        frontier = [int(ind_id)]
        depth = 0
        while frontier and depth < max_depth:
            nxt: List[int] = []
            for cid in frontier:
                parents = self.genealogy_tree.get(cid, ())
                if parents:
                    out[cid] = parents
                    for p in parents:
                        if p not in seen:
                            seen.add(p)
                            nxt.append(p)
            frontier = nxt
            depth += 1
        return out
