"""J5 (``csrc/cartpole_rollout.cu``), the cart-pole configuration and K1's
set kind on the card.

- J5's ``sinf``, ``cosf`` and saturated ``tanhf`` equal ``torch.sin``,
  ``torch.cos`` and ``cartpole.tanh_sat`` on the card bit for bit, and its
  division (``__fdiv_rn``'s fast path where its range check lets it)
  equals torch's division: every float32 over the total mass, random
  pairs (``chip_smoke.j5_division_check``).
- J5 equals its plain version run on the card, bit for bit, at P 1, 3,
  33, 1001 and 10,000 by E 1, 3 and 5 by ``max_steps`` 10, 200 and 500
  (genomes at sigma 0.5 and 3), at hidden widths 1-64 (P 257 at six of
  them; P 33, E 3, 200 steps at every one: the unrolled instance,
  ``cartpole.J5_UNROLLED_HIDDEN``, and the runtime-width one), on a
  balancing genome whose every episode reaches the cap, on 10,000
  perturbations of it whose every episode reaches the cap (the launch
  set by issue, not by one episode's chain), and on NaN and infinite
  genes and on NaN, infinite, huge, tiny and zero starts; it raises on
  the shapes it cannot take; ``launches`` counts one a call; its clocks
  are counted only where asked for.
- One generation of ``bench_suite.py``'s ``cartpole_neuro_pop10k`` (pop
  10k) through J5 equals the same generation evaluated by J5's plain
  version on the card; the one-device mesh holds the card.
- ``var_and(fused='auto')`` with ``mut_uniform_int`` launches K1's set
  kind once and equals the unfused composition.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root (the file
imports ``chip_smoke``):

    python -m pytest tests/test_torch_cartpole_cuda.py -m cuda -q --noconftest

Tolerance: bitwise.
"""

import math

import pytest
import torch

import chip_smoke
from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops, parallel
from deap_tpu_torch.benchmarks import cartpole
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels
from deap_tpu_torch.support.stats import mean0

pytestmark = pytest.mark.cuda

_, NPARAM = cartpole.mlp_policy((4, 16, 2))
# NaN, infinite, huge, tiny and zero starts
ODD_STARTS = [[0.0, 0.0, 0.0, 0.0], [-0.0, -0.0, -0.0, -0.0],
              [0.01, 0.0, 0.0, 1e20], [0.0, 1e-40, 1e-30, 0.0],
              [math.nan, 0.0, 0.01, 0.0], [0.0, 0.0, math.nan, 0.0],
              [0.0, math.inf, 0.0, 0.0], [0.0, 0.0, 0.0, -math.inf],
              [3e38, 0.0, 0.0, 0.0], [0.0, 0.0, 0.2, 3e38],
              [0.01, -0.02, 0.03, 1e-38], [1e-45, 0.0, -1e-45, 1e18]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _j5_and_plain(genomes, starts, max_steps, sizes=(4, 16, 2)):
    got = cartpole.cartpole_rollout(genomes, starts, max_steps, sizes)
    want = cartpole.cartpole_rollout_plain(genomes, starts, max_steps, sizes)
    torch.cuda.synchronize()
    return got, want


def test_j5_transcendentals_equal_torch(card):
    g = make_generator(0, card)
    x = torch.cat([torch.randn(1 << 20, generator=g, device=card) * s
                   for s in (0.01, 0.2, 2.0, 8.0, 1e3, 1e6)] + [
        torch.randint(-2 ** 31, 2 ** 31, (1 << 20,), generator=g,
                      device=card, dtype=torch.int32).view(torch.float32)])
    s, c, t = cartpole.cartpole_math(x)
    assert _same(s, torch.sin(x))
    assert _same(c, torch.cos(x))
    assert _same(t, cartpole.tanh_sat(x))


def test_j5_division_equals_torch(card):
    assert chip_smoke.j5_division_check(torch, card) == 2 ** 32 + 2 ** 29


@pytest.mark.parametrize("max_steps", [10, 200, 500])
@pytest.mark.parametrize("E", [1, 3, 5])
@pytest.mark.parametrize("P", [1, 3, 33, 1001, 10_000])
def test_j5_equals_plain(card, P, E, max_steps):
    g = make_generator(P * 7 + E, card)
    for sigma in (0.5, 3.0):
        genomes = torch.randn((P, NPARAM), generator=g, device=card) * sigma
        starts = cartpole.initial_state(g, E)
        got, want = _j5_and_plain(genomes, starts, max_steps)
        assert got.shape == (P, E) and _same(got, want), sigma
        assert float(got.max()) <= max_steps and float(got.min()) >= 1


@pytest.mark.parametrize("H", [1, 2, 7, 16, 33, 64])
def test_j5_hidden_widths(card, H):
    g = make_generator(H, card)
    genomes = torch.randn((257, 7 * H + 2), generator=g, device=card)
    starts = cartpole.initial_state(g, 3)
    got, want = _j5_and_plain(genomes, starts, 200, (4, H, 2))
    assert _same(got, want)


@pytest.mark.parametrize("H", range(1, cartpole.J5_MAX_HIDDEN + 1))
def test_j5_every_hidden_width(card, H):
    g = make_generator(1000 + H, card)
    for sigma in (0.5, 3.0):
        genomes = torch.randn((33, 7 * H + 2), generator=g,
                              device=card) * sigma
        starts = cartpole.initial_state(g, 3)
        got, want = _j5_and_plain(genomes, starts, 200, (4, H, 2))
        assert _same(got, want), sigma


def test_j5_population_all_at_the_cap(card):
    g = make_generator(8, card)
    genomes = chip_smoke.j5_capped_population(torch, card, g)
    starts = cartpole.initial_state(g, 3)
    got, want = _j5_and_plain(genomes, starts, 500)
    assert _same(got, want) and bool((got == 500).all())


def test_j5_balancing_genome_reaches_the_cap(card):
    bal = chip_smoke.balancing_genome(torch, card)
    starts = cartpole.initial_state(make_generator(1, card), 64)
    got, want = _j5_and_plain(bal[None].repeat(5, 1), starts, 500)
    assert _same(got, want) and bool((got == 500).all())


@pytest.mark.parametrize("H", cartpole.J5_UNROLLED_HIDDEN + (7,))
def test_j5_odd_starts(card, H):
    # NaN, infinite, huge, tiny and zero states: the physics leaves the
    # fast division's range and J5 divides through __fdiv_rn
    starts = torch.tensor(ODD_STARTS, device=card)
    genomes = torch.randn((5, 7 * H + 2), generator=make_generator(H, card),
                          device=card)
    for max_steps in (1, 3, 200):
        got, want = _j5_and_plain(genomes, starts, max_steps, (4, H, 2))
        assert _same(got, want), max_steps


def test_j5_nan_and_infinite_genes(card):
    g = make_generator(2, card)
    genomes = torch.randn((64, NPARAM), generator=g, device=card)
    for row, col, v in ((0, 0, math.nan), (1, 100, math.inf),
                        (2, 112, -math.inf), (3, 64, math.inf),
                        (4, 81, math.nan), (5, 113, math.nan)):
        genomes[row, col] = v
    genomes[6] = math.nan
    genomes[7] = math.inf
    starts = cartpole.initial_state(g, 3)
    for max_steps in (1, 50, 500):
        got, want = _j5_and_plain(genomes, starts, max_steps)
        assert _same(got, want), max_steps


def test_j5_shapes_it_cannot_take_raise(card):
    g = make_generator(3, card)
    starts = cartpole.initial_state(g, 3)
    with pytest.raises(ValueError, match=r"\(4, H, 2\)"):
        cartpole.cartpole_rollout(torch.zeros((4, 7 * 65 + 2), device=card),
                                  starts, 10, (4, 65, 2))
    with pytest.raises(ValueError, match=r"\(4, H, 2\)"):
        cartpole.cartpole_rollout(torch.zeros((4, 162), device=card), starts,
                                  10, (4, 8, 8, 2))
    with pytest.raises(ValueError, match="float32"):
        cartpole.cartpole_rollout(torch.zeros((4, NPARAM), device=card,
                                              dtype=torch.float64), starts,
                                  10)
    with pytest.raises(ValueError, match="one card"):
        cartpole.cartpole_rollout(torch.zeros((4, NPARAM), device=card),
                                  starts.cpu(), 10)
    # a policy of other sizes on the card raises through rollout_population
    policy, n = cartpole.mlp_policy((4, 8, 3, 2))
    with pytest.raises(ValueError, match=r"\(4, H, 2\)"):
        cartpole.rollout_population(policy, torch.zeros((2, n), device=card),
                                    starts, 10)


def test_j5_counts_launches_and_clocks(card):
    g = make_generator(4, card)
    genomes = torch.randn((9, NPARAM), generator=g, device=card)
    starts = cartpole.initial_state(g, 2)
    before = cartpole.cartpole_rollout.launches
    clocks = torch.zeros(18, dtype=torch.int64, device=card)
    out = cartpole.cartpole_rollout(genomes, starts, 100, clocks=clocks)
    assert cartpole.cartpole_rollout.launches == before + 1
    assert bool((clocks > 0).all())
    assert _same(out, cartpole.cartpole_rollout(genomes, starts, 100))
    empty = cartpole.cartpole_rollout(genomes[:0], starts, 100)
    assert empty.shape == (0, 2)
    zero = cartpole.cartpole_rollout(genomes, starts, 0)
    assert bool((zero == 0).all())


def test_one_configuration_generation_equals_plain_evaluation(card):
    g, starts, tb, pop = chip_smoke.cartpole_start(card, 17)
    plain_tb = chip_smoke.cartpole_toolbox(starts)
    plain_tb.register("evaluate", lambda x: mean0(
        cartpole.cartpole_rollout_plain(x, starts, chip_smoke.CP_STEPS).T))
    state = g.get_state()
    before = (cartpole.cartpole_rollout.launches,
              kernels.fused_variation.launches)
    got = chip_smoke.cartpole_generation(g, pop, tb)
    assert cartpole.cartpole_rollout.launches == before[0] + 1
    assert kernels.fused_variation.launches == before[1]
    g.set_state(state)
    want = chip_smoke.cartpole_generation(g, pop, plain_tb)
    torch.cuda.synchronize()
    assert _same(got.genomes, want.genomes)
    assert _same(got.fitness, want.fitness)
    assert pop.genomes.device.type == "cuda"


def test_one_device_mesh_on_the_card(card):
    if torch.cuda.device_count() > 1:
        with pytest.raises(NotImplementedError, match="A12"):
            parallel.population_mesh()
        return
    mesh = parallel.population_mesh()
    assert mesh.device.type == "cuda"
    pop = init_population(make_generator(0, "cpu"), 8, ops.normal_genome(4),
                          FitnessSpec((1.0,)), device="cpu")
    placed = parallel.shard_population(pop, mesh)
    assert placed.genomes.device.type == "cuda"
    assert torch.equal(placed.genomes.cpu(), pop.genomes)


@pytest.mark.parametrize("n,L", [(1, 5), (1001, 33), (100_000, 100)])
def test_var_and_with_uniform_int_launches_k1_set_kind(card, n, L):
    tb = Toolbox()
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_uniform_int, low=-3, up=9, indpb=0.1)
    pop = init_population(make_generator(5, card), n,
                          ops.randint_genome(L, -3, 9), FitnessSpec((1.0,)),
                          device=card)
    pop = pop.replace(genomes=pop.genomes.to(torch.float32))
    pop = pop.with_fitness(torch.zeros((n, 1), device=card))
    sel = torch.randint(0, n, (n,), generator=make_generator(6, card),
                        device=card)
    before = kernels.fused_variation.launches
    got = algorithms.var_and(make_generator(7, card), pop, tb, 0.5, 0.2,
                             fused="auto", sel_idx=sel)
    assert kernels.fused_variation.launches == before + 1
    want = algorithms.var_and(make_generator(7, card), pop, tb, 0.5, 0.2,
                              fused=False, sel_idx=sel)
    assert _same(got.genomes, want.genomes)
    assert torch.equal(got.valid, want.valid)
