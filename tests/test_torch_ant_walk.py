"""J2's walk without a stack (``csrc/ant_rollout.cu``) on the CPU.

- ``chip_smoke.walk_ends`` (J2's right-to-left ends pass) equals the JAX
  evaluator's ``deap_tpu/gp/tree.py::subtree_end`` at every slot, and the
  plain version's ends (``gp/ant.py::_walk_ends_all``): over the whole
  width, 1 where a subtree does not close, the length unread; on complete
  trees and on random ids of the set.
- ``chip_smoke.ant_walk_table`` (the Python build of J2's successor
  table, which the smoke holds the kernel's against) and
  ``chip_smoke.ant_walk_replay`` (its walk in the kernel's order: each
  prog run folded in with a clip at ``max_steps``, the jumps from an if's
  second child to the if's end, the restart at the root, the stack walk
  for a root that does not close) equal ``ant_rollout_plain`` and the
  JAX evaluator bit for bit: on the
  trees the JAX package's generator and one-point crossover make, at
  widths 1-256 and 0, 1 and 543 moves, and on random ids with random
  lengths (mostly the stack walk). An iteration is one if or one action:
  the replay's iterations never exceed its steps, and equal them on the
  stack walk.
- Hand-made trees: one action, nested ifs whose second child ends where
  the parent ends (a jump that lands on another jump, then the restart),
  Koza's solution (89 pieces), and ``max_steps`` at every step of a tree
  whose prog runs are long, so that the bound falls inside a fold.

The JAX package's ``arity_table`` calls ``jax.core.trace_state_clean``
(moved by jax 0.9); the fixture aliases it in this test process only.
"""

import functools

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu.gp import ant as jant
from deap_tpu.gp import tree as jtree
from chip_smoke import ant_walk_replay, ant_walk_table, walk_ends
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.gp import ant as tant

MOVES = 543
KOZA_SOLUTION = (
    "if_food_ahead(move_forward, prog3(turn_left, "
    "prog2(if_food_ahead(move_forward, turn_right), "
    "prog2(turn_right, prog2(turn_left, turn_right))), "
    "prog2(if_food_ahead(move_forward, turn_left), move_forward)))"
)


@pytest.fixture(autouse=True)
def _trace_state_shim(monkeypatch):
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)


def _jax_trees(seed, n, width):
    """n trees of the JAX package's generator and n of its one-point
    crossover of them (their padding holds copies of other nodes)."""
    jps = jant.ant_pset()
    keys = jax.random.split(jax.random.key(seed), 2 * n)
    gen = jgp.make_generator(jps, width, 1, max(1, min(5, width // 4)))
    pop = jax.vmap(gen)(keys)
    cx = jax.vmap(jgp.make_cx_one_point(jps))(
        keys[:n], {k: v[:n] for k, v in pop.items()},
        {k: v[n:] for k, v in pop.items()})[0]
    return {k: np.concatenate([np.asarray(pop[k][:n]), np.asarray(cx[k])])
            for k in pop}


@functools.lru_cache(maxsize=None)
def _jax_eval(width, moves):
    trail, start = tant.parse_trail()
    return jax.jit(jax.vmap(jant.make_ant_evaluator(
        jant.ant_pset(), width, trail, start, max_moves=moves)))


def _walk(nodes, length, moves, max_steps, jax_too=True):
    """The replay of every tree against the plain version and,
    ``jax_too``, the JAX evaluator; returns the replay's eaten, steps,
    iterations and the trees' table."""
    trail, start = tant.parse_trail()
    nodes = torch.as_tensor(np.asarray(nodes), dtype=torch.int32)
    length = torch.as_tensor(np.asarray(length), dtype=torch.int32)
    grid = torch.from_numpy(trail)
    runs = torch.tensor([ant_walk_replay(row, trail, start, moves, max_steps)
                         for row in nodes.tolist()],
                        dtype=torch.int32).reshape(-1, 3)
    eaten, steps, iters = runs[:, 0], runs[:, 1], runs[:, 2]
    table = torch.from_numpy(ant_walk_table(nodes.numpy()))
    want = tant.ant_rollout_plain(nodes, length, grid, start, moves,
                                  max_steps)
    assert eaten.numpy().tobytes() == want[0].numpy().tobytes()
    assert steps.numpy().tobytes() == want[1].numpy().tobytes()
    assert bool((iters <= steps).all())
    stack = table[:, -1, 1] == 0
    assert torch.equal(iters[stack], steps[stack])
    if jax_too:
        width = nodes.shape[1]
        assert max_steps == moves * width + width
        got = np.asarray(_jax_eval(width, moves)(
            {"nodes": jnp.asarray(nodes.numpy()),
             "length": jnp.asarray(length.numpy())}))
        assert np.array_equal(eaten.numpy().astype(np.float32), got)
    return eaten, steps, iters, table


def _random_trees(rng, n, width):
    """Random ids of the set and lengths from -1 to width + 1: many of
    their roots never close."""
    nodes = rng.integers(0, 6, (n, width)).astype(np.int32)
    length = rng.integers(-1, width + 2, n).astype(np.int32)
    return nodes, length


@pytest.mark.parametrize("width", [1, 2, 3, 7, 16, 40])
def test_walk_ends_equal_the_jax_subtree_end(width):
    rng = np.random.default_rng(width)
    nodes, _ = _random_trees(rng, 64, width)
    trees = _jax_trees(width, 8, width)
    nodes = np.concatenate([nodes, trees["nodes"]])
    arity = jnp.asarray(jant.ant_pset().arity_table())
    want = np.asarray(jax.jit(jax.vmap(lambda row: jax.vmap(
        lambda i: jtree.subtree_end(row, arity, i))(jnp.arange(width))))(
            jnp.asarray(nodes)))
    plain = tant._walk_ends_all(torch.from_numpy(nodes).long()).numpy()
    assert np.array_equal(plain, want)
    complete = 0
    for row, w in zip(nodes, want):
        ends, ok = walk_ends(row)
        assert ends == w.tolist()
        complete += ok
    # the generated and crossover trees, and random roots that close
    assert 16 <= complete < len(nodes)
    # a generated tree's length is its root's end
    assert [walk_ends(r)[0][0] for r in trees["nodes"]] == \
        trees["length"].tolist()


@pytest.mark.parametrize("width", [1, 2, 7, 33, 64, 80, 256])
def test_walk_equals_plain_and_jax_on_generated_trees(width):
    trees = _jax_trees(100 + width, 8, width)
    for moves in (0, 1, MOVES):
        max_steps = moves * width + width
        eaten, steps, iters, table = _walk(trees["nodes"], trees["length"],
                                           moves, max_steps)
        assert bool((table[:, -1, 1] == 1).all())    # all complete
        if moves == 0:
            assert int(steps.max()) == 0 and int(iters.max()) == 0
    # at 543 moves the folds save steps: fewer iterations than steps (at
    # widths 1 and 2 every tree is one action)
    assert int(iters.sum()) < int(steps.sum()) or width < 3


def test_roots_that_never_close_take_the_stack_walk():
    rng = np.random.default_rng(7)
    for width in (1, 2, 5, 17, 40):
        nodes, length = _random_trees(rng, 32, width)
        if width >= 3:  # generated trees, a prog3 from their last node on
            trees = _jax_trees(200 + width, 4, width)
            tail = np.arange(width) >= trees["length"][:, None] - 1
            nodes = np.concatenate([nodes, np.where(
                tail, tant.PROG3, trees["nodes"]).astype(np.int32)])
            length = np.concatenate([length, trees["length"]])
        for moves in (0, 1, 25):
            _, _, _, table = _walk(nodes, length, moves,
                                   moves * width + width,
                                   jax_too=moves == 25)
        complete = [walk_ends(r)[1] for r in nodes]
        assert table[:, -1, 1].tolist() == [int(c) for c in complete]
        assert not all(complete)
        if width >= 3:
            assert not any(complete[-8:])


def test_max_steps_inside_a_prog_run():
    pset = tant.ant_pset()
    tree = tgp.from_string(
        "prog3(prog2(prog3(prog2(turn_left, move_forward), move_forward, "
        "prog2(prog2(turn_right, move_forward), move_forward)), "
        "prog3(move_forward, turn_left, move_forward)), prog2(prog3("
        "move_forward, move_forward, turn_right), move_forward), "
        "if_food_ahead(move_forward, prog2(turn_left, move_forward)))",
        pset, 40, device="cpu")
    _, _, _, table = _walk(tree["nodes"], tree["length"], MOVES, 10,
                           jax_too=False)
    start = int(table[0, -1, 0])
    assert start >> 8 == 4               # the root's run of four progs
    for max_steps in range(0, 80):
        _walk(tree["nodes"], tree["length"], MOVES, max_steps,
              jax_too=False)
        _walk(tree["nodes"], tree["length"], 7, max_steps, jax_too=False)


def test_jumps_restart_and_one_action_trees():
    pset = tant.ant_pset()
    trees = ["move_forward", "turn_left",
             "if_food_ahead(if_food_ahead(move_forward, turn_left), "
             "turn_right)",
             "prog2(if_food_ahead(if_food_ahead(move_forward, turn_left), "
             "turn_right), move_forward)",
             "if_food_ahead(move_forward, if_food_ahead(turn_left, "
             "if_food_ahead(turn_right, move_forward)))",
             "prog3(if_food_ahead(prog2(move_forward, move_forward), "
             "turn_left), prog2(if_food_ahead(turn_right, move_forward), "
             "turn_left), if_food_ahead(move_forward, turn_right))",
             KOZA_SOLUTION]
    width = 24
    genomes = [tgp.from_string(t, pset, width, device="cpu") for t in trees]
    nodes = torch.cat([g["nodes"] for g in genomes])
    length = torch.cat([g["length"] for g in genomes])
    for moves in (1, 2, 5, MOVES):
        eaten, steps, iters, table = _walk(nodes, length, moves,
                                           moves * width + width)
    assert eaten[-1] == 89
    # one action: a step and an iteration a move, the root again each time
    assert steps[:2].tolist() == iters[:2].tolist() == [MOVES, MOVES]
    # if(if(move, left), right): the move's next slot is the inner if's
    # second child, which jumps to its end, the outer if's second child,
    # which jumps to the root's end, which restarts at the root
    t = table[2]
    move, left, right = 1 << 16, 2 << 16, 3 << 16
    assert t[:5].tolist() == [[1, 4], [2, 3], [move, 0], [left, 0],
                              [right, 0]]
    assert t[-1].tolist() == [0, 1] and not t[5:-1].any()


def test_traced_launch_is_card_only():
    # the iterations and the table come from J2's launch; on CPU tensors
    # there is no kernel, and the replay lives in chip_smoke.py
    trail, start = tant.parse_trail()
    tree = tgp.from_string(KOZA_SOLUTION, tant.ant_pset(), 24, device="cpu")
    with pytest.raises(ValueError, match="no kernel"):
        tant.ant_rollout_traced(tree["nodes"], tree["length"],
                                torch.from_numpy(trail), start, MOVES,
                                MOVES * 25)
