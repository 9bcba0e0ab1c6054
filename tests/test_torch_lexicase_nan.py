"""The lexicase family on values that hold NaN and inf, bitwise against
the JAX package on injected draws.

A NaN among a pick's survivors makes the case's best NaN, so no row
survives it (under automatic ε an inf makes the MAD NaN, with the same
end). The JAX package then searches an all-NaN cumulative and picks row
0; the port must pick row 0 too, never the out-of-range row n.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops import selection as jsel
from deap_tpu_torch import ops
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import selection as tsel

NAMES = ("lexicase", "epsilon_lexicase", "automatic_epsilon_lexicase")
EPSILON = 0.5
K = 32


def _extra(name):
    return (EPSILON,) if name == "epsilon_lexicase" else ()


def _survive(name):
    return {"lexicase": tsel._survive_exact,
            "epsilon_lexicase": tsel._survive_epsilon(EPSILON),
            "automatic_epsilon_lexicase": tsel._survive_automatic}[name]


def _lexicase_draws(key, k, ncases):
    """The JAX scaffold's draws of each pick: its case order and the
    uniform of its final choice."""
    def one(kk):
        kp, kc = jax.random.split(kk)
        return (jax.random.permutation(kp, ncases),
                jax.random.uniform(kc, (), dtype=jnp.float32))
    return jax.vmap(one)(jax.random.split(key, k))


@functools.lru_cache(maxsize=None)
def _jax_run(name, k):
    """``(key, values, weights) -> (picks, draws)``, jitted once a
    selection (a compile a shape)."""
    sel = getattr(jsel, f"sel_{name}")
    return jax.jit(lambda kk, v, w: (
        sel(kk, v, w, k, *_extra(name)), _lexicase_draws(kk, k, v.shape[1])))


def _both(name, values, weights, k, seed):
    """(JAX picks, port picks) of ``sel_<name>`` on the JAX draws."""
    want, (orders, u) = _jax_run(name, k)(
        jax.random.key(seed), jnp.asarray(values), jnp.asarray(weights))
    got = tsel._lexicase(torch.from_numpy(values), weights,
                         torch.from_numpy(np.array(orders)).long(),
                         torch.from_numpy(np.array(u)), _survive(name))
    return np.asarray(want).astype(np.int64), got.numpy()


@pytest.mark.parametrize("name", NAMES)
def test_smallest_case_picks_row_zero(name):
    """``[[nan], [0]]`` minimised (``[[inf], [0]]`` under automatic ε):
    every pick's mask empties on the one case."""
    cell = np.inf if name == "automatic_epsilon_lexicase" else np.nan
    values = np.array([[cell], [0.0]], np.float32)
    weights = np.array([-1.0], np.float32)
    want, got = _both(name, values, weights, 4, 0)
    assert want.tolist() == [0, 0, 0, 0]
    assert got.tolist() == [0, 0, 0, 0]
    out = getattr(ops, f"sel_{name}")(make_generator(1, "cpu"),
                                      torch.from_numpy(values), weights, 4,
                                      *_extra(name))
    assert out.tolist() == [0, 0, 0, 0]


#: the grid's (n, cases): n 2-39 by 1-7 cases
SHAPES = ((2, 1), (3, 7), (5, 2), (8, 3), (13, 4), (17, 5), (24, 6),
          (31, 7), (37, 2), (39, 3))


def _grid():
    """40 seeded cases, 4 on each of ``SHAPES``: integer-valued errors
    with a fraction added on every third case, up to 3 NaN cells, and an
    inf in every third case."""
    rng = np.random.default_rng(26)
    for case in range(40):
        n, ncases = SHAPES[case % len(SHAPES)]
        values = rng.integers(0, 4, (n, ncases)).astype(np.float32)
        values[:, ::3] += rng.uniform(0, 1, values[:, ::3].shape).astype(
            np.float32)
        for _ in range(rng.integers(0, 4)):
            values[rng.integers(n), rng.integers(ncases)] = np.nan
        if case % 3 == 0:
            values[rng.integers(n), rng.integers(ncases)] = rng.choice(
                [np.inf, -np.inf])
        weights = np.where(rng.uniform(size=ncases) < 0.5, 1.0,
                           -1.0).astype(np.float32)
        yield case, values, weights


@pytest.mark.parametrize("name", NAMES)
def test_nan_and_inf_grid_bitwise(name):
    emptied = 0
    for case, values, weights in _grid():
        want, got = _both(name, values, weights, K, 100 + case)
        n = values.shape[0]
        assert got.tolist() == want.tolist(), (case, values, weights)
        assert 0 <= got.min() and got.max() < n
        emptied += int((got == 0).sum())
    assert emptied > 0  # the grid reaches emptied masks
