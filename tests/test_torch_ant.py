"""The artificial ant: the port's evaluator (J2's plain version on the
CPU), the port's native simulator and the JAX package's evaluator agree
bit for bit (food eaten is integer arithmetic), and Koza's solution eats
all 89 pieces of the Santa Fe trail in 543 moves.

Trees come from the JAX package's generator on numpy-seeded keys, and
from one-point crossover of those (children whose padding holds copies
of other nodes). The JAX package's ``arity_table`` calls
``jax.core.trace_state_clean`` (moved by jax 0.9); the fixture aliases it
in this test process only.
"""

import pathlib
import subprocess
import sys
import textwrap

import jax
import jax._src.core
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu.gp import ant as jant
from deap_tpu.gp import string as jstring
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import gp_genomes_from_arrays
from deap_tpu_torch.gp import ant as tant
from deap_tpu_torch.native import ant_binding

ROOT = pathlib.Path(__file__).resolve().parent.parent
WIDTH, N, MOVES = 64, 64, 543
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


def _jax_trees(seed, n=N):
    jps = jant.ant_pset()
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    keys = jax.random.split(jax.random.key(base), 2 * n)
    gen = jgp.make_generator(jps, WIDTH, 1, 5)
    pop = jax.vmap(gen)(keys)
    # crossover children: slots past the length hold copies of nodes
    cx = jax.vmap(jgp.make_cx_one_point(jps))(
        keys[:n], {k: v[:n] for k, v in pop.items()},
        {k: v[n:] for k, v in pop.items()})[0]
    return {k: np.concatenate([np.asarray(pop[k][:n]), np.asarray(cx[k])])
            for k in pop}


def test_trail_and_vocabulary_match_the_jax_package():
    assert tant.SANTA_FE_TRAIL == jant.SANTA_FE_TRAIL
    grid, start = tant.parse_trail()
    jgrid, jstart = jant.parse_trail()
    assert np.array_equal(grid, jgrid) and start == jstart
    assert grid.sum() == 89 and start == (0, 0)
    assert tant.ant_pset().arity_list() == np.asarray(
        jant.ant_pset().arity_table()).tolist()


def test_koza_solution_eats_89_everywhere():
    trail, start = tant.parse_trail()
    tps = tant.ant_pset()
    genome = tgp.from_string(KOZA_SOLUTION, tps, WIDTH, device="cpu")
    evaluate = tant.make_ant_evaluator(tps, WIDTH, trail, start,
                                       max_moves=MOVES)
    assert evaluate(genome).tolist() == [89.0]
    assert ant_binding.ant_eval(genome["nodes"], genome["length"], trail,
                                start, max_moves=MOVES).tolist() == [89]
    jps = jant.ant_pset()
    jgenome = jstring.from_string(KOZA_SOLUTION, jps, WIDTH)
    jeval = jant.make_ant_evaluator(jps, WIDTH, trail, start,
                                    max_moves=MOVES)
    assert float(jeval(jgenome)) == 89.0


def test_random_trees_agree_bitwise_with_jax_and_native():
    trail, start = tant.parse_trail()
    trees = _jax_trees(1)
    jeval = jant.make_ant_evaluator(jant.ant_pset(), WIDTH, trail, start,
                                    max_moves=MOVES)
    want = np.asarray(jax.vmap(jeval)(trees))
    evaluate = tant.make_ant_evaluator(tant.ant_pset(), WIDTH, trail, start,
                                       max_moves=MOVES)
    got = evaluate(gp_genomes_from_arrays(trees, "cpu")).numpy()
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
    native = ant_binding.ant_eval(trees["nodes"], trees["length"], trail,
                                  start, max_moves=MOVES)
    assert np.array_equal(native, want.astype(np.int32))
    # the trees differ: some eat nothing, some eat a lot
    assert want.min() == 0 and want.max() >= 10


def test_rollout_steps_and_budget():
    """Steps stop at the move budget or the step bound; a tree of one
    action spends exactly its moves, one a step."""
    trail, start = tant.parse_trail()
    tps = tant.ant_pset()
    one = tgp.from_string("move_forward", tps, 8, device="cpu")
    t = torch.from_numpy(trail)
    eaten, steps = tant.ant_rollout(one["nodes"], one["length"], t, start,
                                    max_moves=40, max_steps=10_000)
    # east along row 0: cells 1-3 hold food, then 28 empty cells, then
    # the torus wraps
    assert eaten.tolist() == [3] and steps.tolist() == [40]
    eaten, steps = tant.ant_rollout(one["nodes"], one["length"], t, start,
                                    max_moves=40, max_steps=7)
    assert eaten.tolist() == [3] and steps.tolist() == [7]
    # prog3 of three actions: 4 steps for each 3 moves
    three = tgp.from_string("prog3(turn_left, turn_right, move_forward)",
                            tps, 8, device="cpu")
    _, steps = tant.ant_rollout(three["nodes"], three["length"], t, start,
                                max_moves=30, max_steps=10_000)
    assert steps.tolist() == [40]


def test_pack_trail_bits():
    trail, _ = tant.parse_trail()
    rng = np.random.default_rng(2)
    for grid in (trail, rng.random((5, 70)) < 0.3):
        words = tant.pack_trail(torch.from_numpy(grid)).numpy()
        assert words.shape == (grid.shape[0], -(-grid.shape[1] // 32))
        bits = (words.view(np.uint32)[:, :, None]
                >> np.arange(32, dtype=np.uint32)) & 1
        back = bits.reshape(grid.shape[0], -1)[:, :grid.shape[1]]
        assert np.array_equal(back.astype(bool), grid)


def test_evaluator_refuses_other_sets_and_the_card_needs_a_card():
    trail, start = tant.parse_trail()
    with pytest.raises(ValueError):
        tant.make_ant_evaluator(tgp.math_set(1), WIDTH, trail, start)
    meta = torch.zeros((2, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tant.ant_rollout(meta, torch.ones(2, dtype=torch.int32,
                                          device="meta"),
                         torch.from_numpy(trail), start, 10, 100)


def test_native_library_is_keyed_on_its_source():
    target = ant_binding._target()
    ant_binding.library()
    assert target.exists() and target.parent == ant_binding.BUILD_DIR
    assert target.name.startswith("libant-") and target.suffix == ".so"


def test_the_rest_of_gp_imports_without_jax():
    """The new GP modules and the native simulator's loader stand alone:
    importing and running them loads neither jax nor the JAX package."""
    script = textwrap.dedent("""
        import sys
        import torch
        from deap_tpu_torch import gp
        from deap_tpu_torch.gp import adf, ant, harm, semantic, typed
        from deap_tpu_torch.native import ant_binding
        trail, start = ant.parse_trail()
        pset = ant.ant_pset()
        trees = gp.gen_half_and_half(pset, 32, 1, 3)(
            torch.Generator().manual_seed(0), 8)
        evaluate = ant.make_ant_evaluator(pset, 32, trail, start, 50)
        assert evaluate(trees).tolist() == ant_binding.ant_eval(
            trees["nodes"], trees["length"], trail, start, 50).tolist()
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
