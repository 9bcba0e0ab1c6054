"""Tournament selection — batched, index-returning.

Port of the tournament part of :mod:`deap_tpu.ops.selection`. Operators
take weighted fitness ``w: f32[n, nobj]`` and return ``int64[k]``
indices; callers materialise the selection with
:func:`deap_tpu_torch.core.population.gather`.
"""

from __future__ import annotations

import torch

from deap_tpu_torch.core.fitness import lex_gt, lex_sort_desc


def _tournament_winners(w: torch.Tensor,
                        aspirants: torch.Tensor) -> torch.Tensor:
    """Lexicographic-best aspirant per row; ties go to the earliest
    drawn, like Python's ``max``."""
    best = aspirants[..., 0]
    for j in range(1, aspirants.shape[-1]):
        cand = aspirants[..., j]
        best = torch.where(lex_gt(w[cand], w[best]), cand, best)
    return best


def tournament_aspirants(generator: torch.Generator, n: int, k: int,
                         tournsize: int) -> torch.Tensor:
    """The aspirant draw: ``int64[k, tournsize]`` uniform in ``[0, n)``."""
    return torch.randint(0, n, (k, tournsize), generator=generator,
                         device=generator.device)


def sel_tournament(generator: torch.Generator, w: torch.Tensor, k: int,
                   tournsize: int) -> torch.Tensor:
    """``k`` tournaments of ``tournsize`` uniform aspirants."""
    aspirants = tournament_aspirants(generator, w.shape[0], k, tournsize)
    return _tournament_winners(w, aspirants)


def sel_tournament_sorted(generator: torch.Generator, w: torch.Tensor,
                          k: int, tournsize: int) -> torch.Tensor:
    """Tournament selection via ranks: the winner of ``tournsize`` uniform
    draws is ``order[min(ranks)]`` with ``order`` the stable best-first
    sort. Same winner distribution as :func:`sel_tournament`; ties break
    by population index instead of draw order."""
    order = lex_sort_desc(w)
    ranks = torch.randint(0, w.shape[0], (tournsize, k), generator=generator,
                          device=generator.device)
    return order[ranks.amin(0)]
