"""``var_or`` through K1 on the card, and the (μ + λ) / (μ, λ) loops.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root (the shapes and
inputs are ``chip_smoke.py``'s ``k1_var_or_shapes`` and
``var_or_k1_inputs``):

    python -m pytest tests/test_torch_var_or_cuda.py -m cuda -q --noconftest

Tolerance: bitwise. K1 on ``var_or_masks`` (λ children of N rows,
partners drawn apart from the source rows, crossover and mutation rows
exclusive) equals its plain version; each loop gives the same
population, hall of fame and logbook with ``fused='kernel'``,
``'plain'`` and ``False`` from one seed; ``fused='auto'`` on a CUDA bool
population launches K1.
"""

import pytest
import torch

from chip_smoke import (CXPB, MUTPB, _onemax_toolbox, k1_var_or_shapes,
                        var_or_k1_inputs)
from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels, variation
from deap_tpu_torch.support.stats import fitness_stats

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("kind", ["flip", "add", "set"])
def test_k1_on_var_or_masks_equals_plain(card, kind):
    cases = [c for c in k1_var_or_shapes() if c[3] == kind]
    assert len(cases) == 20
    for seed, (lam, N, dtype, _) in enumerate(cases):
        args = var_or_k1_inputs(torch, card, seed, lam, N, dtype, kind)
        before = kernels.fused_variation.launches
        got = kernels.fused_variation(*args, mut_kind=kind)
        want = variation.apply_variation(*args, kind).to(dtype)
        torch.cuda.synchronize()
        assert kernels.fused_variation.launches == before + 1
        assert _same(got, want), (lam, N)


@pytest.mark.parametrize("loop, mu, lam", [
    (algorithms.ea_mu_plus_lambda, 1001, 1001),
    (algorithms.ea_mu_comma_lambda, 257, 1001)])
def test_loops_equal_across_fused_modes(card, loop, mu, lam):
    tb = _onemax_toolbox(Toolbox, ops)
    runs = []
    for fused in ("kernel", "plain", False):
        g = make_generator(5, card)
        pop = init_population(g, mu, ops.bernoulli_genome(100),
                              FitnessSpec((1.0,)), device=card)
        before = kernels.fused_variation.launches
        runs.append(loop(g, pop, tb, mu, lam, CXPB, MUTPB, 5,
                         stats=fitness_stats(), halloffame_size=2,
                         fused=fused, device=card))
        assert (kernels.fused_variation.launches - before
                == (5 if fused == "kernel" else 0))
    pop, logbook, hof = runs[0]
    for other_pop, other_logbook, other_hof in runs[1:]:
        for name in ("genomes", "fitness", "valid"):
            assert _same(getattr(pop, name), getattr(other_pop, name))
        for name in ("genomes", "fitness", "filled"):
            assert _same(getattr(hof, name), getattr(other_hof, name))
        assert list(logbook) == list(other_logbook)


def test_var_or_auto_on_a_card_population_launches_k1(card):
    tb = _onemax_toolbox(Toolbox, ops)
    pop = init_population(make_generator(9, card), 300,
                          ops.bernoulli_genome(64), FitnessSpec((1.0,)),
                          device=card)
    pop = algorithms.evaluate_invalid(pop, tb.evaluate)
    before = kernels.fused_variation.launches
    off = algorithms.var_or(make_generator(10, card), pop, tb, 700, 0.5, 0.3)
    torch.cuda.synchronize()
    assert kernels.fused_variation.launches == before + 1
    want = algorithms.var_or(make_generator(10, card), pop, tb, 700, 0.5,
                             0.3, fused=False)
    for name in ("genomes", "fitness", "valid"):
        assert _same(getattr(off, name), getattr(want, name))
