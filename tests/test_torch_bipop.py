"""BIPOP-CMA-ES (``strategies.bipop``) against the JAX package's, on the
CPU.

The two packages draw different numbers, so a whole run is held to the
JAX package's gate (sphere, dim 5, best below 1e-8), and the parts are
held to the JAX run itself: ``_restart_plan``, fed the uniforms the JAX
key chain gives each restart (``jax.random.split(key, 4)``, as the JAX
function splits it) and the budgets the JAX run spent, gives each of its
logbooks' λ (``evals``) and regime, in both regimes; each stopping
criterion fires on a state made for it, and only there.
"""

import math
from collections import deque

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import strategies as jstrategies
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.strategies import bipop, bipop_cmaes

DIM, SIGMA0 = 5, 2.0


def _sphere_jax(x):
    return jnp.sum(x ** 2, axis=-1)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's run at nrestarts 4 (regime 2 appears from the
    third restart)."""
    return jstrategies.bipop_cmaes(jax.random.key(12), _sphere_jax, dim=DIM,
                                   sigma0=SIGMA0, nrestarts=4)


def test_restart_plan_gives_the_reference_runs(jax_run):
    _, best_f, logbooks = jax_run
    assert best_f < 1e-8
    key = jax.random.key(12)
    nsmall, small, large = 0, [], []
    regimes = []
    for i, lb in enumerate(logbooks):
        key, k_reg, _, _ = jax.random.split(key, 4)
        u = np.asarray(jax.random.uniform(k_reg, (2,)))
        plan = bipop._restart_plan(i, 4, nsmall, small, large, u, DIM,
                                   SIGMA0)
        rows = list(lb)
        assert {r["evals"] for r in rows} == {plan["lambda_"]}
        assert {r["regime"] for r in rows} == {plan["regime"]}
        assert {r["restart"] for r in rows} == {i}
        assert len(rows) <= math.ceil(plan["maxiter"])
        regimes.append(plan["regime"])
        if plan["regime"] == 2:
            nsmall += 1
            small.append(0)
            assert plan["sigma"] == 2 * 10 ** (-2 * float(u[1]))
        else:
            large.append(0)
            assert plan["sigma"] == SIGMA0
        spent = sum(r["evals"] for r in rows)
        if plan["regime"] == 1 and i > 0:
            large[-1] += spent
        elif plan["regime"] == 2:
            small[-1] += spent
    assert len(logbooks) == 4 + nsmall
    assert set(regimes) == {1, 2} and regimes[0] == regimes[-1] == 1


def test_restart_plan_constants():
    lambda0 = 4 + int(3 * math.log(DIM))
    plan = bipop._restart_plan(0, 3, 0, [], [], (0.5, 0.5), DIM, SIGMA0)
    assert plan == {"lambda_": lambda0, "sigma": SIGMA0, "regime": 1,
                    "maxiter": 100 + 50 * (DIM + 3) ** 2 / math.sqrt(lambda0),
                    "tolhistfun_iter": 10 + int(math.ceil(30.0 * DIM
                                                          / lambda0)),
                    "equalfunvals_k": int(math.ceil(0.1 + lambda0 / 4.0))}
    # regime 2 while its budget trails, with maxiter from the last large
    # budget; never on the last restart
    plan = bipop._restart_plan(2, 4, 0, [], [0, 500], (0.0, 1.0), DIM,
                               SIGMA0)
    assert plan["regime"] == 2 and plan["lambda_"] == lambda0
    assert plan["sigma"] == 2 * 10 ** -2
    assert plan["maxiter"] == 0.5 * 500 / lambda0
    assert bipop._restart_plan(3, 4, 0, [], [0, 500], (0.0, 1.0), DIM,
                               SIGMA0)["regime"] == 1
    assert bipop._restart_plan(2, 4, 0, [600], [0, 500], (0.0, 1.0), DIM,
                               SIGMA0)["regime"] == 1
    # λ is at least 2
    assert bipop._restart_plan(0, 1, 0, [], [], (0, 0), 1, 1.0)[
        "lambda_"] == 4


def _state(dim=3, **over):
    """A healthy CMA-ES state on the host: no criterion fires."""
    st = {"centroid": np.full(dim, 1.0, np.float32),
          "sigma": np.float32(0.5), "C": np.eye(dim, dtype=np.float32),
          "B": np.eye(dim, dtype=np.float32),
          "diagD": np.ones(dim, np.float32), "pc": np.full(dim, 0.1,
                                                           np.float32),
          "cond": np.float32(1.0)}
    st.update(over)
    return st


def _stop(st=None, t=5, dim=3, maxiter=1000.0, mins=(1.0, 2.0),
          window=2, equal=(0,), best=(), median=(), lam=10, sigma=0.5):
    return bipop._stop_conditions(
        _state(dim) if st is None else st, t, dim, lam, sigma, maxiter,
        deque(mins, maxlen=window), list(equal), list(best), list(median),
        1e-12, 1e-12, 1e20, 1e14)


@pytest.mark.parametrize("name,kw", [
    ("MaxIter", dict(t=10, maxiter=10.0)),
    ("TolHistFun", dict(mins=(1.0, 1.0 + 1e-13))),
    ("EqualFunVals", dict(t=4, equal=(0, 1, 1, 0))),
    ("TolX", dict(st=_state(pc=np.full(3, 1e-13, np.float32),
                            C=np.eye(3, dtype=np.float32) * 1e-27,
                            centroid=np.zeros(3, np.float32)))),
    ("TolUpSigma", dict(st=_state(sigma=np.float32(1e21)))),
    ("Stagnation", dict(t=200, best=[1.0] * 100 + [0.5] * 101,
                        median=[1.0] * 100 + [0.5] * 101)),
    ("ConditionCov", dict(st=_state(cond=np.float32(1e15)))),
    ("NoEffectAxis", dict(st=_state(centroid=np.full(3, 1e9, np.float32)),
                          t=6)),
    ("NoEffectCoor", dict(st=_state(centroid=np.float32([1e9, 1.0, 1.0])))),
])
def test_each_stopping_criterion_fires_alone(name, kw):
    assert _stop() == {}
    fired = _stop(**kw)
    assert name in fired
    # NoEffectAxis' centroid is large in every coordinate, so NoEffectCoor
    # fires beside it
    assert set(fired) <= {name, "NoEffectCoor"}


def test_port_run_reaches_the_gate():
    """The JAX package's gate (tests/test_multiswarm_bipop.py): sphere,
    dim 5, nrestarts 2, best below 1e-8 in at least two logbooks."""
    best_x, best_f, logbooks = bipop_cmaes(
        make_generator(12, "cpu"), lambda x: (x * x).sum(-1), dim=DIM,
        sigma0=SIGMA0, nrestarts=2, device="cpu")
    assert best_f < 1e-8 and len(logbooks) >= 2
    assert best_x.shape == (DIM,)
    assert float((best_x.astype(np.float64) ** 2).sum()) == pytest.approx(
        best_f, rel=1e-5, abs=1e-30)
    cols = logbooks[0][0]
    assert {"gen", "evals", "restart", "regime", "min", "avg", "max"} \
        <= set(cols)
    lambda0 = 4 + int(3 * math.log(DIM))
    assert [lb[0]["evals"] for lb in logbooks[:2]] == [lambda0, 2 * lambda0]


def test_port_draws_from_the_generator_in_order():
    """The regime's two uniforms, then the centroid, then the first
    generation's normals."""
    seen = []
    g = make_generator(3, "cpu")
    ref = make_generator(3, "cpu")
    torch.rand(2, generator=ref)  # the regime's uniforms
    c = -4.0 + 8.0 * torch.rand(DIM, generator=ref)
    arz = torch.randn((4 + int(3 * math.log(DIM)), DIM), generator=ref)

    def evaluate(x):
        seen.append(x)
        return (x * x).sum(-1)

    bipop_cmaes(g, evaluate, dim=DIM, nrestarts=1, device="cpu")
    want = c + SIGMA0 * arz  # the first samples: C = I, B = D = I
    np.testing.assert_allclose(seen[0].numpy(), want.numpy(), rtol=1e-6)
