"""The island step's variation through K1 on the card.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root:

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda -q --noconftest

Tolerance: bitwise. The batched island generation (tournament selection)
launches K1 once a generation over every deme; the per-deme pass (any
other selection) launches it once a deme a generation through
``var_and``'s fused plane. Each equals the same epoch with the unfused
composition, generator end state included.
"""

import pytest
import torch

from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
from deap_tpu_torch import parallel
from deap_tpu_torch.core.population import concat
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels
from deap_tpu_torch.parallel import island

pytestmark = pytest.mark.cuda

CXPB, MUTPB, INDPB = 0.5, 0.2, 0.05
N_ISLANDS, DEME, L, FREQ, MIG_K = 4, 50, 64, 2, 3


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _toolbox(select, **kwargs):
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=INDPB)
    tb.register("select", select, **kwargs)
    return tb


def _demes(card, tb):
    pops = parallel.island_init(make_generator(0, card), N_ISLANDS, DEME,
                                ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                                device=card)
    return island._stack_demes(algorithms.evaluate_invalid(
        island._flatten_demes(pops), tb.evaluate), N_ISLANDS)


def _unfused_epoch(generator, pops, tb):
    """One epoch deme by deme with the unfused composition."""
    for _ in range(FREQ):
        demes = []
        for d in range(N_ISLANDS):
            deme = island._flatten_demes(island._slice_demes(pops, d, d + 1))
            idx = tb.select(generator, deme.wvalues, deme.size)
            off = algorithms.var_and(generator, deme, tb, CXPB, MUTPB,
                                     fused=False, sel_idx=idx)
            demes.append(algorithms.evaluate_invalid(off, tb.evaluate))
        pops = island._stack_demes(concat(demes), N_ISLANDS)
    return parallel.mig_ring(generator, pops, MIG_K)


def _same(a, b):
    for name in ("genomes", "fitness", "valid"):
        x, y = getattr(a, name), getattr(b, name)
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("select, kwargs", [
    (ops.sel_best, {}), (ops.sel_roulette, {}), (ops.sel_random, {})])
def test_per_deme_pass_launches_k1_per_deme(card, select, kwargs):
    tb = _toolbox(select, **kwargs)
    pops = _demes(card, tb)
    g = make_generator(1, card)
    before = kernels.fused_variation.launches
    got = parallel.make_island_step(tb, CXPB, MUTPB, FREQ, MIG_K)(g, pops)
    torch.cuda.synchronize()
    assert kernels.fused_variation.launches - before == FREQ * N_ISLANDS
    w = make_generator(1, card)
    want = _unfused_epoch(w, pops, tb)
    _same(got, want)
    assert torch.equal(g.get_state(), w.get_state())


def test_batched_pass_launches_k1_once_a_generation(card):
    tb = _toolbox(ops.sel_tournament, tournsize=3)
    pops = _demes(card, tb)
    g = make_generator(1, card)
    before = kernels.fused_variation.launches
    got = parallel.make_island_step(tb, CXPB, MUTPB, FREQ, MIG_K)(g, pops)
    torch.cuda.synchronize()
    assert kernels.fused_variation.launches - before == FREQ
    vplan = ops.variation.resolve_plan(tb)
    w = make_generator(1, card)
    want = pops
    for _ in range(FREQ):
        asp, masks = island.island_draws(w, N_ISLANDS, DEME, L, 3, CXPB,
                                         MUTPB, vplan, torch.bool)
        want = island.island_generation(want, asp, masks, tb,
                                        vplan.mut_kind, "plain")
    want = parallel.mig_ring(w, want, MIG_K)
    _same(got, want)
    assert torch.equal(g.get_state(), w.get_state())
