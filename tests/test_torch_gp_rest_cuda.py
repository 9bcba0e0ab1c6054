"""K9's codes 13-15 (``lt``, ``eq``, ``lf``) and J2 (``csrc/ant_rollout.cu``)
on the card.

- K9 evaluates typed ``spam_set`` populations (``lt``, ``eq`` live, on
  integer data so that ``eq`` holds often, NaN and infinity among the
  points) and semantic offspring (``lf`` live) bit for bit like its plain
  version run on the card, in one launch an evaluation.
- J2 equals its plain version (eaten and steps) and the native simulator
  on random trees and their crossover children, at widths 16, 33, 80 and
  256 (its largest), populations 1, 31 and 4096, and the move budgets 0,
  1, 543 and 600; Koza's solution eats 89.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root:

    python -m pytest tests/test_torch_gp_rest_cuda.py -m cuda -q --noconftest

Tolerance: bitwise.
"""

import numpy as np
import pytest
import torch

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
    trees = gp.gen_half_and_half(pset, width, 1, min(5, width // 4))(g, n)
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


def test_j2_koza_solution_eats_89(card):
    trail, start = ant.parse_trail()
    pset = ant.ant_pset()
    genome = gp.from_string(KOZA_SOLUTION, pset, 80, device=card)
    evaluate = ant.make_ant_evaluator(pset, 80, trail, start, max_moves=543)
    before = ant.ant_rollout.launches
    assert evaluate(genome).tolist() == [89.0]
    assert ant.ant_rollout.launches == before + 1
