"""Fitness semantics as batched tensor functions.

Port of :mod:`deap_tpu.core.fitness`. Fitness is a ``f32[n, nobj]`` tensor
of raw objective values plus a static weights tuple; every comparison
helper takes *weighted* values, so maximisation is uniform "bigger is
better" (the reference's ``wvalues``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _weights_on(weights: Tuple[float, ...],
                device: torch.device) -> torch.Tensor:
    return torch.tensor(weights, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class FitnessSpec:
    """Objective weights: negative minimises, positive maximises."""

    weights: Tuple[float, ...]

    def __init__(self, weights: Sequence[float]):
        object.__setattr__(self, "weights", tuple(float(w) for w in weights))

    @property
    def nobj(self) -> int:
        return len(self.weights)

    def warray(self, device=None) -> torch.Tensor:
        """The weights as float32 on ``device``, made once a device and
        shared (read-only): a tensor made from host data on the card
        waits for it, and every generation weighs its values."""
        return _weights_on(self.weights, torch.device(
            "cpu" if device is None else device))

    def wvalues(self, values: torch.Tensor) -> torch.Tensor:
        """Weighted values: ``values * weights``."""
        values = values.to(torch.float32)
        return values * self.warray(values.device)


def wvalues(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted values ``values * weights``, the helpers' "bigger is
    better" form."""
    return values * weights


def dominates(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Pareto dominance of weighted values ``wa`` over ``wb``: no worse in
    every objective, strictly better in one. Broadcasts over leading
    axes."""
    return (wa >= wb).all(-1) & (wa > wb).any(-1)


def lex_gt(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Lexicographic ``wa > wb``: the first differing objective decides."""
    wa, wb = torch.broadcast_tensors(wa, wb)
    neq = wa != wb
    first = neq.to(torch.uint8).argmax(-1, keepdim=True)
    a = wa.gather(-1, first)[..., 0]
    b = wb.gather(-1, first)[..., 0]
    return neq.any(-1) & (a > b)


def lex_ge(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    return ~lex_gt(wb, wa)


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """``jnp.lexsort``: ascending, stable, the LAST key primary — one
    stable sort per key, least significant first."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def lex_sort_desc(w: torch.Tensor) -> torch.Tensor:
    """Indices sorting rows of ``w`` lexicographically descending,
    objective 0 primary. Stable."""
    return lexsort([-w[:, j] for j in range(w.shape[-1] - 1, -1, -1)])


def lex_best_index(w: torch.Tensor,
                   valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Index of the lexicographically largest row."""
    if valid is not None:
        w = torch.where(valid[:, None], w, -torch.inf)
    return lex_sort_desc(w)[0]
