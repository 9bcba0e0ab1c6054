"""The port's multi-objective modules held against the JAX package's, on
the CPU: the same numpy inputs through both.

- Every ``nd_rank`` engine (matrix, tiled, staircase, sweep, dc with
  either cross step) with ``max_rank``, ``cover_k``, ``fallback`` and
  ``return_peels``; crowding distances; the auto dispatch rule.
  Tolerance: bitwise.

The selections are held in tests/test_torch_mo_select.py; the operators,
benchmarks, metrics and the Pareto archive in tests/test_torch_mo_ops.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import mo as jmo
from deap_tpu.mo import emo as jemo
from deap_tpu.mo import ndsort as jnd
from deap_tpu_torch import mo as tmo
from deap_tpu_torch.mo import emo as temo


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def fitness_cases(seed, nobj, sizes=(1, 2, 37, 96, 201), trials=6):
    """Integer grids (tie planes), normals, sign-mixed grids, with a third
    of the rows duplicated and a few rows of -inf."""
    rng = np.random.default_rng(seed)
    for trial in range(trials):
        n = sizes[trial % len(sizes)]
        kind = trial % 3
        if kind == 0:
            w = rng.integers(0, 4, (n, nobj)).astype(np.float32)
        elif kind == 1:
            w = rng.normal(size=(n, nobj)).astype(np.float32)
        else:
            signs = rng.choice([-1.0, 1.0], nobj).astype(np.float32)
            w = rng.integers(0, 3, (n, nobj)).astype(np.float32) * signs
        if n > 4:
            w[rng.integers(0, n, n // 3)] = w[rng.integers(0, n, n // 3)]
            w[rng.random(n) < 0.05] = -np.inf
        yield w


ENGINES = {2: ("matrix", "tiled", "staircase"),
           3: ("matrix", "tiled", "sweep", "dc"),
           4: ("matrix", "tiled", "dc"),
           5: ("matrix", "dc")}


@pytest.mark.parametrize("nobj", [2, 3, 4, 5])
def test_nd_rank_engines_equal_jax(nobj):
    """Each engine on every tie structure; the budget, cover and
    fallback options on the last (sign-mixed, 96 rows) case: every eager
    JAX call re-traces its loops, so the option grid stays on one case."""
    cases = list(fitness_cases(nobj, nobj, sizes=(2, 37, 96), trials=3))
    for ci, w in enumerate(cases):
        J, W = jnp.asarray(w), T(w)
        options = [dict()]
        if ci == len(cases) - 1:
            options += [dict(max_rank=2), dict(max_rank=2, fallback="count"),
                        dict(cover_k=w.shape[0] // 3)]
        for impl in ENGINES[nobj]:
            # cover_k only stops the peeling engines
            for kw in [o for o in options
                       if "cover_k" not in o or impl in ("matrix", "tiled")]:
                want, wp = jmo.nd_rank(J, impl=impl, return_peels=True, **kw)
                got, gp = tmo.nd_rank(W, impl=impl, return_peels=True, **kw)
                assert_bitwise(got, want)
                assert gp == int(wp), (impl, kw)


@pytest.mark.parametrize("cross", ["xla", "pallas"])
def test_prefix_blocks_and_cross_steps_equal_jax(cross):
    """The port's cross step (K8's plain version on the CPU) against each
    of the JAX package's, the Pallas one in interpret mode."""
    for w in fitness_cases(11, 4, sizes=(100, 77)):
        want = jnd.nd_rank_prefix(jnp.asarray(w), block=32, cross=cross,
                                  interpret=cross == "pallas" or None)
        assert_bitwise(tmo.nd_rank_prefix(T(w), block=32), want)


def test_sweep_matches_jax_on_a_larger_population():
    rng = np.random.default_rng(12)
    w = rng.normal(size=(700, 3)).astype(np.float32)
    w[rng.integers(0, 700, 150)] = w[rng.integers(0, 700, 150)]
    assert_bitwise(tmo.nd_rank_sweep3(T(w)), jnd.nd_rank_sweep3(
        jnp.asarray(w)))
    # and the auto engine on the CPU (dc at this size) agrees
    assert_bitwise(tmo.nd_rank(T(w)), jmo.nd_rank(jnp.asarray(w)))


@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_tiny_populations(n):
    w = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    for fn in (tmo.nd_rank_sweep3, lambda x: tmo.nd_rank_prefix(x, block=4),
               lambda x: tmo.nd_rank(x, impl="matrix"),
               lambda x: tmo.nd_rank(x, impl="tiled")):
        got = fn(T(w))
        assert got.shape == (n,)
        if n:
            assert_bitwise(got, jmo.nd_rank(jnp.asarray(w), impl="matrix"))


def test_engine_contracts_raise():
    with pytest.raises(ValueError, match="nobj"):
        tmo.nd_rank_staircase(torch.zeros((8, 3)))
    with pytest.raises(ValueError, match="nobj"):
        tmo.nd_rank_sweep3(torch.zeros((8, 2)))
    with pytest.raises(ValueError, match="impl"):
        tmo.nd_rank(torch.zeros((8, 2)), impl="tilted")
    with pytest.raises(ValueError, match="fallback"):
        tmo.nd_rank(torch.zeros((8, 2)), fallback="guess")
    with pytest.raises(ValueError, match="nd"):
        tmo.sel_nsga2(None, torch.zeros((8, 2)), 4, nd="tilted")


def test_auto_dispatch_follows_the_jax_rule():
    """The same thresholds; 'cuda' takes the place the JAX rule gives
    the TPU, and the CPU picks what the JAX package picks on its CPU."""
    for nobj in (1, 2, 3, 4, 6):
        for n in (1, 63, 64, 511, 512, 8191, 8192, 16383, 16384, 100_000):
            for ours, theirs in (("cpu", "cpu"), ("cuda", "tpu")):
                assert temo._nd_static_auto(n, nobj, ours) == \
                    jemo._nd_static_auto(n, nobj, theirs), (n, nobj, ours)
    assert temo._nd_static_auto(50_000, 3, "cuda") == "tiled"
    assert temo._nd_static_auto(100_000, 2, "cuda") == "staircase"


def test_crowding_distances_equal_jax():
    for nobj in (2, 3, 5):
        for w in fitness_cases(20 + nobj, nobj, sizes=(2, 37, 201)):
            # the port's ranks (held to JAX's above), and the same ranks
            # with every row past front 1 at the budget sentinel
            ranks = tmo.nd_rank(T(w), impl="matrix").numpy()
            sentinel = np.where(ranks >= 2, w.shape[0], ranks)
            for r in (ranks, sentinel.astype(np.int32)):
                want = jmo.crowding_distances(jnp.asarray(w), jnp.asarray(r))
                assert_bitwise(tmo.crowding_distances(T(w), T(r)), want)
