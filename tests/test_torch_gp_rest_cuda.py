"""K9's codes 13-15 (``lt``, ``eq``, ``lf``) and J2 (``csrc/ant_rollout.cu``)
on the card.

- K9 evaluates typed ``spam_set`` populations (``lt``, ``eq`` live, on
  integer data so that ``eq`` holds often, NaN and infinity among the
  points) and semantic offspring (``lf`` live) bit for bit like its plain
  version run on the card, in one launch an evaluation.
- J2 equals its plain version (eaten and steps) and the native simulator
  on random trees and their crossover children, at widths 16, 33, 80 and
  256 (its largest), populations 1, 31 and 4096, and the move budgets 0,
  1, 543 and 600; its traced launch gives the same, at most as many
  iterations as steps, and a table equal to
  ``chip_smoke.ant_walk_table``'s. It
  equals its plain version on random ids and lengths and on generated
  trees whose root never closes (its stack walk) at widths 1-256,
  at step bounds inside the prog runs it folds, and, with the native
  simulator, on the population ``examples/gp/ant.py``'s program leaves
  after 10 generations at pop 4096 (``chip_smoke.ant_evolved``); Koza's
  solution eats 89.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root (the file
imports ``chip_smoke``):

    python -m pytest tests/test_torch_gp_rest_cuda.py -m cuda -q --noconftest

Tolerance: bitwise.
"""

import numpy as np
import pytest
import torch

from chip_smoke import ant_walk_table
from deap_tpu_torch import gp
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.gp import ant
from deap_tpu_torch.native import ant_binding
from deap_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda

KOZA_SOLUTION = (
    "if_food_ahead(move_forward, prog3(turn_left, "
    "prog2(if_food_ahead(move_forward, turn_right), "
    "prog2(turn_right, prog2(turn_left, turn_right))), "
    "prog2(if_food_ahead(move_forward, turn_left), move_forward)))"
)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def _kernel_and_plain(pset, ml, trees, X):
    """The grouped interpreter through K9, and through its plain version
    on the card."""
    interp = gp.make_batch_interpreter(pset, ml, mode="grouped")
    plain = gp.make_batch_interpreter(pset, ml, mode="grouped")
    plain.grouped_dispatch = (
        lambda *a, levels, **k: kernels.gp_grouped_dispatch_plain(*a, **k))
    before = kernels.gp_grouped_dispatch.launches
    got = interp(trees, X)
    want = plain(trees, X)
    torch.cuda.synchronize()
    assert kernels.gp_grouped_dispatch.launches == before + 1
    return got, want, interp


@pytest.mark.parametrize("n,ml,P", [(1, 16, 1), (37, 24, 7), (4096, 64, 256)])
def test_k9_lt_eq_on_typed_trees_equal_plain(card, n, ml, P):
    pset = gp.spam_set(4)
    g = make_generator(n + ml, card)
    trees = gp.make_generator_typed(pset, ml, 1, 4)(g, n)
    X = torch.floor(torch.rand((P, 4), generator=g, device=card) * 4)
    if P > 4:
        X[0, 0], X[1, 1], X[2, 2] = float("nan"), float("inf"), -0.0
    got, want, interp = _kernel_and_plain(pset, ml, trees, X)
    assert _same(got, want)
    if n > 1:
        assert {"lt", "eq"} <= {pset.primitives[b].name
                                for b in interp.mask}


@pytest.mark.parametrize("n,P", [(64, 13), (1024, 256)])
def test_k9_lf_on_semantic_offspring_equal_plain(card, n, P):
    pset = gp.add_semantic_primitives(gp.math_set(1))
    g = make_generator(n, card)
    parents = gp.gen_half_and_half(pset, 16, 1, 3)(g, n)
    expr = gp.make_generator(pset, 8, 0, 2, "full")
    kids = gp.make_mut_semantic(pset, expr, 64)(g, parents)
    a, b = gp.make_cx_semantic(pset, expr, 64)(g, parents, parents.copy())
    trees = {k: torch.cat([kids[k], a[k], b[k]]) for k in kids}
    X = (torch.rand((P, 1), generator=g, device=card) - 0.5) * 80
    got, want, interp = _kernel_and_plain(pset, 64, trees, X)
    assert _same(got, want)
    assert "lf" in {pset.primitives[b].name for b in interp.mask}


def _ant_trees(card, seed, n, width):
    pset = ant.ant_pset()
    g = make_generator(seed, card)
    trees = gp.gen_half_and_half(pset, width, 1,
                                 max(1, min(5, width // 4)))(g, n)
    half = n // 2
    if half:
        kids, _ = gp.make_cx_one_point(pset)(
            g, {k: v[:half] for k, v in trees.items()},
            {k: v[half:2 * half] for k, v in trees.items()})
        for k in trees:
            trees[k][:half] = kids[k]
    return trees


@pytest.mark.parametrize("n,width,moves", [
    (1, 16, 543), (31, 33, 1), (31, 33, 0), (4096, 80, 543),
    (4096, 80, 600), (257, 256, 543)])
def test_j2_equals_plain_and_native(card, n, width, moves):
    trail, start = ant.parse_trail()
    t = torch.as_tensor(trail, device=card)
    trees = _ant_trees(card, n + width, n, width)
    max_steps = moves * width + width
    before = ant.ant_rollout.launches
    eaten, steps = ant.ant_rollout(trees["nodes"], trees["length"], t, start,
                                   moves, max_steps)
    want = ant.ant_rollout_plain(trees["nodes"], trees["length"], t, start,
                                 moves, max_steps)
    torch.cuda.synchronize()
    assert ant.ant_rollout.launches == before + 1
    assert _same(eaten, want[0]) and _same(steps, want[1])
    native = ant_binding.ant_eval(trees["nodes"], trees["length"], trail,
                                  start, max_moves=moves)
    assert np.array_equal(eaten.cpu().numpy(), native)
    if moves == 0:
        assert int(steps.max()) == 0 and int(eaten.max()) == 0
    # the walk's table equals its Python build: every tree complete
    table = _traced(trees, t, start, moves, max_steps, eaten, steps)
    assert bool((table[:, -1, 1] == 1).all())


def _traced(trees, t, start, moves, max_steps, eaten, steps):
    """J2's traced launch: the same eaten and steps, iterations at most
    the steps, and its table equal to ``chip_smoke.ant_walk_table``'s."""
    e, s, iters, table = ant.ant_rollout_traced(
        trees["nodes"], trees["length"], t, start, moves, max_steps)
    assert _same(e, eaten) and _same(s, steps)
    assert bool((iters <= s).all())
    table = table.cpu()
    assert np.array_equal(table.numpy(),
                          ant_walk_table(trees["nodes"].cpu().numpy()))
    return table


@pytest.mark.parametrize("width", [1, 3, 17, 80, 256])
def test_j2_equals_plain_on_incomplete_trees(card, width):
    # random ids and lengths, and generated trees with a prog3 at every
    # slot from their last node on (a root that never closes): the stack
    # walk, and the counter walk on the random roots that close
    trail, start = ant.parse_trail()
    t = torch.as_tensor(trail, device=card)
    g = make_generator(width, card)
    n = 1024
    nodes = torch.randint(0, 6, (n, width), generator=g, device=card,
                          dtype=torch.int32)
    length = torch.randint(-1, width + 2, (n,), generator=g, device=card,
                           dtype=torch.int32)
    trees = _ant_trees(card, 3 * width, n // 2, width)
    tail = (torch.arange(width, device=card)
            >= trees["length"][:, None] - 1)
    nodes[:n // 2] = torch.where(tail, ant.PROG3, trees["nodes"])
    broken = {"nodes": nodes, "length": length}
    for moves, max_steps in ((543, 3000), (1, 50), (0, 10)):
        eaten, steps = ant.ant_rollout(nodes, length, t, start, moves,
                                       max_steps)
        want = ant.ant_rollout_plain(nodes, length, t, start, moves,
                                     max_steps)
        assert _same(eaten, want[0]) and _same(steps, want[1])
        table = _traced(broken, t, start, moves, max_steps, eaten, steps)
        assert int(table[:n // 2, -1, 1].sum()) == 0


@pytest.mark.parametrize("width", [16, 80, 256])
def test_j2_max_steps_inside_a_prog_run(card, width):
    trail, start = ant.parse_trail()
    t = torch.as_tensor(trail, device=card)
    trees = _ant_trees(card, 5 * width, 512, width)
    for max_steps in (*range(0, 12), 17, 33, 100, 1001):
        eaten, steps = ant.ant_rollout(trees["nodes"], trees["length"], t,
                                       start, 543, max_steps)
        want = ant.ant_rollout_plain(trees["nodes"], trees["length"], t,
                                     start, 543, max_steps)
        assert _same(eaten, want[0]) and _same(steps, want[1]), max_steps
        assert int(steps.max()) <= max_steps


def test_j2_equals_plain_and_native_on_an_evolved_population(card):
    # examples/gp/ant.py's program for 10 generations at pop 4096, width
    # 80 (its evaluations through J2), then J2 on the population it left
    from chip_smoke import ANT_ML, ANT_MOVES, ant_evolved
    trail, start = ant.parse_trail()
    t = torch.as_tensor(trail, device=card)
    pop, _, _ = ant_evolved(make_generator(9, card), trail, start)
    trees = {k: v.to(torch.int32) for k, v in pop.genomes.items()}
    max_steps = ANT_MOVES * ANT_ML + ANT_ML
    eaten, steps = ant.ant_rollout(trees["nodes"], trees["length"], t, start,
                                   ANT_MOVES, max_steps)
    want = ant.ant_rollout_plain(trees["nodes"], trees["length"], t, start,
                                 ANT_MOVES, max_steps)
    assert _same(eaten, want[0]) and _same(steps, want[1])
    native = ant_binding.ant_eval(trees["nodes"], trees["length"], trail,
                                  start, max_moves=ANT_MOVES)
    assert np.array_equal(eaten.cpu().numpy(), native)
    assert np.array_equal(pop.fitness[:, 0].cpu().numpy(),
                          native.astype(np.float32))
    _traced(trees, t, start, ANT_MOVES, max_steps, eaten, steps)


def test_j2_koza_solution_eats_89(card):
    trail, start = ant.parse_trail()
    pset = ant.ant_pset()
    genome = gp.from_string(KOZA_SOLUTION, pset, 80, device=card)
    evaluate = ant.make_ant_evaluator(pset, 80, trail, start, max_moves=543)
    before = ant.ant_rollout.launches
    assert evaluate(genome).tolist() == [89.0]
    assert ant.ant_rollout.launches == before + 1
