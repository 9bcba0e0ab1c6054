"""HARM-GP bloat control (Gardner, Gagné & Parizeau 2015).

Port of :mod:`deap_tpu.gp.harm`. Each generation (1) models the natural
size distribution by breeding a large trial population, (2) smooths its
size histogram with the kernel 0.4/0.2/0.2/0.1/0.1 at offsets 0/±1/±2,
(3) picks a cutoff size from the sizes of the fittest (1 − rho) tail,
(4) shapes a target distribution that decays exponentially past the
cutoff with half-life ``alpha·size + beta``, and (5) keeps the trial
individuals accepted with probability target/natural of their size,
accepted ones first, by a top-k over uniform scores plus 2 for accepted.

The cutoff and the histogram are host scalars (one copy a generation),
so the loop runs on the host around batched tensor steps. The draws of a
generation come apart from its arithmetic: :func:`trial_offspring_core`
and :func:`harm_select` take them, as the tests hand them the JAX
package's.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.algorithms import _host, evaluate_invalid
from deap_tpu_torch.core.population import Population, gather
from deap_tpu_torch.device import check_generator
from deap_tpu_torch.gp.tree import _f32
from deap_tpu_torch.support.hof import hof_update
from deap_tpu_torch.support.logbook import Logbook

_KERNEL = ((0, 0.4), (-1, 0.2), (1, 0.2), (-2, 0.1), (2, 0.1))


def trial_offspring_core(pop: Population, idx: torch.Tensor,
                         u: torch.Tensor, c1, m1, cxpb: float,
                         mutpb: float) -> Population:
    """The trial children on their draws: parents ``gather(pop,
    idx[:n])``; child ``t`` is the crossover child ``c1[t]`` where ``u[t]
    < cxpb``, the mutant ``m1[t]`` where ``cxpb <= u[t] < cxpb + mutpb``,
    else a copy of its parent that keeps its valid fitness."""
    n = u.shape[0]
    p1 = gather(pop, idx[:n])
    is_cx = u < _f32(cxpb)
    is_mut = (u >= _f32(cxpb)) & (u < _f32(cxpb + mutpb))

    def mix(cx_leaf, mut_leaf, rep_leaf):
        shape = (-1,) + (1,) * (cx_leaf.ndim - 1)
        return torch.where(is_cx.reshape(shape), cx_leaf, torch.where(
            is_mut.reshape(shape), mut_leaf, rep_leaf))

    genomes = pytree.tree_map(mix, c1, m1, p1.genomes)
    return p1.replace(genomes=genomes).invalidate(is_cx | is_mut)


def _trial_offspring(generator: torch.Generator, pop: Population, toolbox,
                     n: int, cxpb: float, mutpb: float) -> Population:
    """``n`` trial children the way the reference's ``_genpop`` breeds
    them: parents by ``toolbox.select``; each child a crossover child
    (probability ``cxpb``), a mutant (``mutpb``) or a copy."""
    u = torch.rand(n, generator=generator, device=generator.device)
    idx = toolbox.select(generator, pop.wvalues, 2 * n)
    p1 = gather(pop, idx[:n])
    p2 = gather(pop, idx[n:])
    c1, _ = toolbox.mate(generator, p1.genomes, p2.genomes)
    m1 = toolbox.mutate(generator, p1.genomes)
    return trial_offspring_core(pop, idx, u, c1, m1, cxpb, mutpb)


def _kde_hist(sizes: torch.Tensor, max_size: int) -> torch.Tensor:
    """Kernel-smoothed size histogram ``f32[max_size + 3]``: each size
    adds 0.4 at itself, 0.2 at ±1 and 0.1 at ±2 (bins below 0 dropped).
    Summed on the host in float32, one offset after another and each in
    the sizes' order (the JAX package's five scatter-adds), so the card's
    histogram is the CPU's."""
    s = sizes.detach().cpu().numpy().astype(np.int64)
    hist = np.zeros(max_size + 3, np.float32)
    for off, w in _KERNEL:
        b = s + off
        ok = b >= 0
        np.add.at(hist, np.where(ok, b, 0),
                  np.where(ok, np.float32(w), np.float32(0.0)))
    return torch.from_numpy(hist).to(sizes.device)


def harm_select(natural: Population, n: int, max_size: int, alpha: float,
                beta: float, gamma: float, rho: float, mincutoff: int,
                accept_u: torch.Tensor, pick_u: torch.Tensor
                ) -> Tuple[torch.Tensor, int, torch.Tensor]:
    """One generation's choice among the trial population on its draws
    ``accept_u``, ``pick_u`` (``f32[nbrindsmodel]`` each): ``(take
    int64[n], cutoff size, acceptance probability per trial child)``."""
    dev = natural.device
    nbr = natural.size
    sizes = natural.genomes["length"].to(torch.int64)
    naturalhist = _kde_hist(sizes, max_size) * _f32(n / nbr)
    # the cutoff from the fittest tail: ascending fitness (invalid rows
    # first), the sizes from index n·rho − 1 on
    fit_key = torch.where(natural.valid, natural.wvalues.sum(-1), -torch.inf)
    order = torch.argsort(fit_key, stable=True)
    tail = sizes[order][int(n * rho - 1):]
    cutoffsize = max(mincutoff, int(tail.min()))
    bins = torch.arange(max_size + 3, dtype=torch.float32, device=dev)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    halflife = bins * _f32(alpha) + _f32(beta)
    targetfunc = (f32(gamma * n * math.log(2)) / halflife) * torch.exp(
        (bins - cutoffsize) * _f32(-math.log(2)) / halflife)
    targethist = torch.where(bins <= cutoffsize, naturalhist, targetfunc)
    probhist = torch.where(naturalhist > 0, targethist / naturalhist,
                           targethist)
    probs = probhist[sizes.clamp(0, max_size + 2)].clamp(0.0, 1.0)
    accept = accept_u < probs
    score = pick_u + accept.to(torch.float32) * 2.0
    # ties (u + 2 rounds to 2^-22) keep the lower index first, as top_k
    take = torch.sort(score, descending=True, stable=True).indices[:n]
    return take, cutoffsize, probs


def harm(generator: torch.Generator, pop: Population, toolbox, cxpb: float,
         mutpb: float, ngen: int, alpha: float = 0.05, beta: float = 10.0,
         gamma: float = 0.25, rho: float = 0.9, nbrindsmodel: int = -1,
         mincutoff: int = 20, stats=None, halloffame=None,
         verbose: bool = False) -> Tuple[Population, Logbook, Optional[object]]:
    """Run a HARM-GP evolution (recommended alpha 0.05, beta 10, gamma
    0.25, rho 0.9). Genomes are prefix trees; their ``length`` is the size
    measure. The toolbox is batched (:mod:`deap_tpu_torch.algorithms`);
    ``halloffame`` is a :class:`~deap_tpu_torch.support.hof.HallOfFame`
    or ``None``. Runs on ``generator``'s device, where ``pop`` must
    be."""
    check_generator(generator, pop.device)
    n = pop.size
    if nbrindsmodel == -1:
        nbrindsmodel = max(2000, n)
    max_size = int(pop.genomes["nodes"].shape[-1])
    nevals0 = int((~pop.valid).sum())
    pop = evaluate_invalid(pop, toolbox.evaluate)
    hof = halloffame
    if hof is not None:
        hof = hof_update(hof, pop)
    logbook = Logbook()
    logbook.header = ["gen", "nevals"] + (list(stats.fields) if stats
                                          else [])
    logbook.record(gen=0, nevals=nevals0,
                   **_host(stats.compile(pop) if stats else {}))
    if verbose:
        print(logbook.stream)
    dev = generator.device
    for gen in range(1, ngen + 1):
        natural = _trial_offspring(generator, pop, toolbox, nbrindsmodel,
                                   cxpb, mutpb)
        accept_u = torch.rand(nbrindsmodel, generator=generator, device=dev)
        pick_u = torch.rand(nbrindsmodel, generator=generator, device=dev)
        take, _, _ = harm_select(natural, n, max_size, alpha, beta, gamma,
                                 rho, mincutoff, accept_u, pick_u)
        offspring = gather(natural, take)
        nevals = int((~offspring.valid).sum())
        pop = evaluate_invalid(offspring, toolbox.evaluate)
        if hof is not None:
            hof = hof_update(hof, pop)
        logbook.record(gen=gen, nevals=nevals,
                       **_host(stats.compile(pop) if stats else {}))
        if verbose:
            print(logbook.stream)
    return pop, logbook, hof
