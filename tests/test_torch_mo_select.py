"""The port's multi-objective selections held against the JAX package's,
on the CPU: ``sel_nsga2`` with each ``nd`` engine and a peel budget,
``sel_tournament_dcd`` and ``sel_spea2_stream`` with the JAX package's
permutations, coins and tie-break uniforms injected. Tolerance: bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import mo as jmo
from deap_tpu_torch import mo as tmo
from deap_tpu_torch.mo import emo as temo

ENGINES = {2: ("matrix", "tiled", "staircase"),
           3: ("matrix", "tiled", "sweep", "dc")}


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


@pytest.mark.parametrize("nobj", [2, 3])
def test_sel_nsga2_equals_jax_for_every_engine(nobj):
    rng = np.random.default_rng(30 + nobj)
    w = rng.integers(0, 6, (240, nobj)).astype(np.float32)
    w[rng.integers(0, 240, 60)] = w[rng.integers(0, 240, 60)]
    J, W = jnp.asarray(w), T(w)
    for nd in ("standard",) + ENGINES[nobj]:
        for k, budget in ((100, None), (37, 2)):
            want = jmo.sel_nsga2(None, J, k, nd=nd, peel_budget=budget)
            got = tmo.sel_nsga2(None, W, k, nd=nd, peel_budget=budget)
            assert_bitwise(got, want)


@pytest.mark.parametrize("n,k", [(64, 64), (37, 20), (50, 121)])
def test_sel_tournament_dcd_with_injected_draws_equals_jax(n, k):
    rng = np.random.default_rng(n)
    w = rng.integers(0, 5, (n, 3)).astype(np.float32)
    w[rng.integers(0, n, n // 4)] = w[rng.integers(0, n, n // 4)]
    key = jax.random.key(n + k)
    k1, k2, kc = jax.random.split(key, 3)
    p1 = jax.random.permutation(k1, n)
    p2 = jax.random.permutation(k2, n)
    coin = jax.random.bernoulli(kc, 0.5, (k,))
    for budget in (None, 2):
        want = jmo.sel_tournament_dcd(key, jnp.asarray(w), k,
                                      peel_budget=budget)
        got = temo._dcd_winners(T(w), k, T(p1), T(p2), T(coin),
                                peel_budget=budget)
        assert_bitwise(got, want)


def test_sel_tournament_dcd_draws_and_winners():
    from deap_tpu_torch.device import make_generator
    w = torch.tensor([[0.0, 0.0]] + [[-5.0, -5.0]] * 7)
    idx = tmo.sel_tournament_dcd(make_generator(0, "cpu"), w, 8)
    assert idx.shape == (8,)
    # row 0 dominates everyone: wherever it was drawn, it won
    p1, p2, coin = tmo.dcd_draws(make_generator(0, "cpu"), 8, 8)
    assert sorted(p1.tolist()) == list(range(8)) and coin.dtype == torch.bool
    assert int((idx == 0).sum()) >= 1


@pytest.mark.parametrize("n,k,cand", [(300, 60, None), (300, 60, 90),
                                      (257, 200, 100)])
def test_sel_spea2_stream_with_injected_uniforms_equals_jax(n, k, cand):
    rng = np.random.default_rng(k)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[: n // 5] = rng.integers(0, 3, (n // 5, 3))  # a tied corner
    key = jax.random.key(k)
    u = jax.random.uniform(key, (n,))
    want = jmo.sel_spea2_stream(key, jnp.asarray(w), k, candidates=cand)
    got = temo._spea2_stream_pick(T(w), k, T(u), candidates=cand)
    assert_bitwise(got, want)
