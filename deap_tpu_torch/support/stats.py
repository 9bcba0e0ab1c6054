"""Statistics / MultiStatistics — per-generation reductions on the device.

Port of :mod:`deap_tpu.support.stats`. ``Statistics(key)`` extracts a
tensor from the whole :class:`Population` (default: the raw fitness) and
registered reducers run over the population axis; ``MultiStatistics``
holds named chapters of them.

The mean is the sum times the float32 reciprocal of ``n``, as the JAX
package's compiled loops compute it, so on integer-valued fitness (exact
sums) ``avg`` agrees bit for bit; ``std`` and sums of fractional values
may differ in the last bits, since XLA picks its own summation order.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch


def _default_key(pop):
    return pop.fitness


def mean0(x: torch.Tensor) -> torch.Tensor:
    recip = torch.tensor(1.0 / x.shape[0], dtype=x.dtype).item()
    return x.sum(0) * recip


def std0(x: torch.Tensor) -> torch.Tensor:
    """Population standard deviation (no Bessel correction)."""
    return torch.std(x, dim=0, correction=0)


def min0(x: torch.Tensor) -> torch.Tensor:
    return x.amin(0)


def max0(x: torch.Tensor) -> torch.Tensor:
    return x.amax(0)


class Statistics:
    """``Statistics(key)`` + ``register(name, fn)`` → ``compile(pop)``."""

    def __init__(self, key: Callable = _default_key):
        self.key = key
        self.functions: Dict[str, Callable] = {}
        self.fields = []

    def register(self, name: str, function: Callable, *args, **kwargs) -> None:
        self.functions[name] = lambda x: function(x, *args, **kwargs)
        self.fields.append(name)

    def compile(self, pop) -> Dict[str, torch.Tensor]:
        data = self.key(pop)
        return {name: fn(data) for name, fn in self.functions.items()}


class MultiStatistics(dict):
    """Named chapters of :class:`Statistics`: ``compile`` returns one dict
    a chapter, which :class:`~deap_tpu_torch.support.logbook.Logbook`
    records as chapters."""

    def __init__(self, **chapters: Statistics):
        super().__init__(chapters)

    @property
    def fields(self):
        return sorted(self.keys())

    def register(self, name: str, function: Callable, *args, **kwargs) -> None:
        for stats in self.values():
            stats.register(name, function, *args, **kwargs)

    def compile(self, pop) -> Dict[str, Dict[str, torch.Tensor]]:
        return {chapter: stats.compile(pop) for chapter, stats in self.items()}


def fitness_stats() -> Statistics:
    """The conventional avg/std/min/max fitness block, over the
    population axis."""
    stats = Statistics(lambda pop: pop.fitness[:, 0] if pop.nobj == 1
                       else pop.fitness)
    stats.register("avg", mean0)
    stats.register("std", std0)
    stats.register("min", min0)
    stats.register("max", max0)
    return stats
