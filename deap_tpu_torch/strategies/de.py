"""Differential Evolution — DE/rand/1/bin, one batched step a generation.

Port of :mod:`deap_tpu.strategies.de`: three donors drawn with
replacement, binomial crossover with one forced coordinate, and greedy
replacement on a strict lexicographic gain. :meth:`DifferentialEvolution.
step_from_draws` takes the draws; :meth:`DifferentialEvolution.step`
draws them from a ``torch.Generator``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from deap_tpu_torch.core.fitness import FitnessSpec, lex_gt
from deap_tpu_torch.core.population import Population
from deap_tpu_torch.device import check_generator

__all__ = ["DifferentialEvolution"]


class DifferentialEvolution:
    """DE/rand/1/bin (Storn & Price).

    :param evaluate: batched objective ``genomes [n, d] -> values``.
    :param F: differential weight.
    :param CR: crossover probability.
    :param spec: fitness weights (default single-objective minimisation).

    Donors a, b, c are drawn with replacement (they may include the
    agent), one random coordinate always crosses over, and the trial
    replaces the agent only if strictly better.
    """

    def __init__(self, evaluate: Callable, F: float = 1.0, CR: float = 0.25,
                 spec: FitnessSpec = FitnessSpec((-1.0,))):
        self.evaluate = evaluate
        self.F = F
        self.CR = CR
        self.spec = spec

    @staticmethod
    def draws(generator: torch.Generator, n: int, d: int):
        """``abc [3, n]`` donor indices, ``cross_u [n, d]`` uniforms and
        ``forced [n]`` coordinates."""
        dev = generator.device
        abc = torch.randint(0, n, (3, n), generator=generator, device=dev)
        cross_u = torch.rand((n, d), generator=generator, device=dev)
        forced = torch.randint(0, d, (n,), generator=generator, device=dev)
        return abc, cross_u, forced

    def step_from_draws(self, pop: Population, abc: torch.Tensor,
                        cross_u: torch.Tensor,
                        forced: torch.Tensor) -> Population:
        """One generation for every agent at once, on given draws."""
        g = pop.genomes
        d = g.shape[1]
        abc = abc.long()
        mutant = g[abc[0]] + self.F * (g[abc[1]] - g[abc[2]])
        cols = torch.arange(d, device=g.device)
        cross = (cross_u < self.CR) | (cols[None, :] == forced[:, None])
        trial = torch.where(cross, mutant, g)
        values = self.evaluate(trial)
        values = values[:, None] if values.ndim == 1 else values
        better = lex_gt(self.spec.wvalues(values), pop.wvalues)
        return pop.replace(
            genomes=torch.where(better[:, None], trial, g),
            fitness=torch.where(better[:, None], values.to(pop.fitness.dtype),
                                pop.fitness),
            valid=torch.ones_like(pop.valid))

    def step(self, generator: torch.Generator,
             pop: Population) -> Population:
        n, d = pop.genomes.shape
        return self.step_from_draws(pop, *self.draws(generator, n, d))

    def run(self, generator: torch.Generator, pop: Population, ngen: int,
            ) -> Tuple[Population, torch.Tensor]:
        """Evaluate the population, then ``ngen`` generations; returns the
        final population and each generation's best weighted fitness
        (``[ngen]``, stacked on the device at the end)."""
        check_generator(generator, pop.device)
        pop = pop.with_fitness(self.evaluate(pop.genomes))
        traj = []
        for _ in range(ngen):
            pop = self.step(generator, pop)
            traj.append(pop.wvalues[:, 0].max())
        empty = torch.zeros(0, device=pop.device)
        return pop, torch.stack(traj) if traj else empty
