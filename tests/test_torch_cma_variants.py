"""The rest of the CMA-ES family against the JAX package's, on the CPU:
``Strategy(eigh_impl='jacobi')``, ``StrategyOnePlusLambda``,
``StrategyMultiObjective`` and ``hypervolume_contributions_2d``.

Tolerances, each stated in ``strategies.cma``:

- ``'jacobi'`` updates: ``state_errors`` (the port's Jacobi and the JAX
  package's differ by XLA's contractions, ``ops.linalg.JACOBI_W_RTOL``).
- (1+λ): ``parent`` and ``parent_w`` equal (the improvement test compares
  the same float32 values), the rest within ``RTOL`` plus ``ATOL_FRAC`` of
  the largest entry (``field_errors``): products, ``exp`` and the Cholesky
  factor round in another order or library.
- MO-CMA-ES: ``x`` and ``w`` equal (the selection compares the same
  float32 contributions), the rest within ``RTOL`` plus ``ATOL_FRAC`` of
  the largest entry: the rank-one factor updates chain float32 products
  that XLA contracts (measured: 0.013 of that bound for both strategies).
- ``hypervolume_contributions_2d``: bitwise (subtractions and one product
  a point, nothing to contract).

Offspring come from numpy normals (or the JAX package's own draws), so
both packages update the same state on the same points; the data has no
near-ties, and the discrete outputs (``chosen``, the parents,
``improved``) must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import benchmarks as jbm
from deap_tpu.native import hypervolume as j_hypervolume
from deap_tpu.strategies import cma as jcma
from deap_tpu_torch import Toolbox, algorithms, benchmarks, convert
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.native import hypervolume
from deap_tpu_torch.strategies import cma

CMA_FIELDS = tuple(convert.CMA_FIELDS)


def _t(a):
    return torch.from_numpy(np.array(a))


def _zdt1_jax(x):
    return jax.vmap(jbm.zdt1)(jnp.clip(x, 0, 1))


# ------------------------------------------------ Strategy('jacobi') ----

def _cma_pair(dim, lam):
    centroid = np.linspace(-2.0, 3.0, dim).astype(np.float32)
    return (jcma.Strategy(jnp.asarray(centroid), sigma=0.7, lambda_=lam,
                          eigh_impl="jacobi"),
            cma.Strategy(torch.from_numpy(centroid), sigma=0.7, lambda_=lam,
                         eigh_impl="jacobi", device="cpu"))


def _cma_to_port(jstate):
    return convert.cma_state_from_arrays(
        **{f: np.asarray(getattr(jstate, f)) for f in CMA_FIELDS},
        device="cpu")


@pytest.mark.parametrize("seed,dim,lam,gens", [(0, 6, 12, 0), (1, 10, 20, 6),
                                               (2, 17, 24, 4)])
def test_jacobi_update_equals_the_reference(seed, dim, lam, gens):
    js, ts = _cma_pair(dim, lam)
    assert ts.eigh_impl == "jacobi"
    rng = np.random.default_rng(seed)
    update = jax.jit(js.update)
    jstate = js.initial_state()
    tstate = ts.initial_state()
    assert cma.state_errors(tstate, _cma_to_port(jstate))["ok"]
    for _ in range(gens):
        arz = rng.standard_normal((lam, dim)).astype(np.float32)
        pop = jstate.centroid + jstate.sigma * jnp.asarray(arz) @ jstate.BD.T
        jstate = update(jstate, pop, jax.vmap(jbm.sphere)(pop))
    arz = rng.standard_normal((lam, dim)).astype(np.float32)
    genomes = jstate.centroid + jstate.sigma * jnp.asarray(arz) @ jstate.BD.T
    values = jax.vmap(jbm.sphere)(genomes)
    want = update(jstate, genomes, values)
    got = ts.update(_cma_to_port(jstate), _t(genomes), _t(values))
    errs = cma.state_errors(got, _cma_to_port(want))
    assert errs["ok"], errs
    assert errs["columns_apart"] >= 1


def test_jacobi_and_auto_choices():
    s = cma.Strategy(torch.zeros(4), 1.0, eigh_impl="jacobi", device="cpu")
    st = s.initial_state()
    assert torch.equal(st.B, torch.eye(4)) and torch.equal(st.diagD,
                                                           torch.ones(4))
    with pytest.raises(NotImplementedError, match="'auto'"):
        cma.Strategy(torch.zeros(4), 1.0, eigh_impl="auto", device="cpu")


# ------------------------------------------------ StrategyOnePlusLambda ----

OPL_FIELDS = tuple(convert.ONE_PLUS_LAMBDA_FIELDS)


def _opl_pair(dim, lam, **kw):
    parent = np.linspace(-1.0, 2.0, dim).astype(np.float32)
    f = np.float32((parent ** 2).sum())
    return (jcma.StrategyOnePlusLambda(jnp.asarray(parent), f, sigma=0.8,
                                       lambda_=lam, **kw),
            cma.StrategyOnePlusLambda(torch.from_numpy(parent), f, sigma=0.8,
                                      lambda_=lam, device="cpu", **kw))


def _opl_to_port(jstate):
    return convert.one_plus_lambda_state_from_arrays(
        **{f: np.asarray(getattr(jstate, f)) for f in OPL_FIELDS},
        device="cpu")


def test_one_plus_lambda_parameters_and_initial_state():
    js, ts = _opl_pair(7, 6)
    for name in ("lambda_", "d", "ptarg", "cp", "cc", "ccov", "pthresh",
                 "dim"):
        assert getattr(ts, name) == getattr(js, name), name
    got, want = ts.initial_state(), _opl_to_port(js.initial_state())
    errs = cma.field_errors(got, want, exact=OPL_FIELDS)
    assert errs["ok"], errs
    assert ts.metric_names == js.metric_names
    m = ts.metrics(got)
    assert set(m) == set(ts.metric_names)
    assert float(m["psucc"]) == float(np.float32(js.ptarg))
    js2, ts2 = _opl_pair(3, 4, d=2.0, ptarg=0.3, cp=0.2, cc=0.4, ccov=0.1,
                         pthresh=0.5)
    for name in ("d", "ptarg", "cp", "cc", "ccov", "pthresh"):
        assert getattr(ts2, name) == getattr(js2, name)


@pytest.mark.parametrize("seed,dim,lam", [(0, 5, 8), (1, 9, 1), (2, 4, 12)])
def test_one_plus_lambda_update_equals_the_reference(seed, dim, lam):
    """Twenty steps in a row, each from the reference's state: parents and
    their fitness equal (both branches of the improvement and of the
    success threshold are taken), the rest within tolerance."""
    js, ts = _opl_pair(dim, lam)
    rng = np.random.default_rng(seed)
    update = jax.jit(js.update)
    jstate = js.initial_state()
    seen = set()
    for _ in range(20):
        arz = rng.standard_normal((lam, dim)).astype(np.float32)
        genomes = jstate.parent + jstate.sigma * jnp.asarray(arz) @ jstate.A.T
        values = jax.vmap(jbm.sphere)(genomes)
        want = update(jstate, genomes, values)
        got = ts.update(_opl_to_port(jstate), _t(genomes), _t(values))
        errs = cma.field_errors(got, _opl_to_port(want),
                                exact=cma.ONE_PLUS_LAMBDA_EXACT)
        assert errs["ok"], errs
        improved = not np.array_equal(np.asarray(want.parent),
                                      np.asarray(jstate.parent))
        seen.add((improved, bool(jstate.psucc < js.pthresh)))
        jstate = want
    assert {True, False} <= {i for i, _ in seen}


def test_one_plus_lambda_generate_on_injected_normals():
    js, ts = _opl_pair(6, 5)
    rng = np.random.default_rng(3)
    jstate = js.initial_state()
    update = jax.jit(js.update)
    for _ in range(5):
        arz = rng.standard_normal((5, 6)).astype(np.float32)
        pop = jstate.parent + jstate.sigma * jnp.asarray(arz) @ jstate.A.T
        jstate = update(jstate, pop, jax.vmap(jbm.sphere)(pop))
    arz = rng.standard_normal((5, 6)).astype(np.float32)
    want = jstate.parent + jstate.sigma * jnp.asarray(arz) @ jstate.A.T
    state = _opl_to_port(jstate)
    got = ts.sample(state, torch.from_numpy(arz))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=cma.RTOL,
                               atol=cma.ATOL_FRAC * np.abs(want).max())
    gen = make_generator(9, "cpu")
    arz = torch.randn((5, 6), generator=make_generator(9, "cpu"))
    assert torch.equal(ts.generate(gen, state), ts.sample(state, arz))


@pytest.mark.parametrize("seed", range(4))
def test_one_plus_lambda_sphere_gate(seed):
    """The JAX package's gate (tests/test_strategies.py): (1+λ) on sphere,
    N 5, λ 8, 300 generations, best below 1e-6."""
    parent = torch.full((5,), 2.0)
    strat = cma.StrategyOnePlusLambda(parent, benchmarks.sphere(parent[None]),
                                      sigma=1.0, lambda_=8, device="cpu")
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    state, logbook, _ = algorithms.ea_generate_update(
        make_generator(seed, "cpu"), strat.initial_state(), tb, 300,
        strat.spec, device="cpu")
    assert float(-state.parent_w[0]) < 1e-6
    assert len(logbook) == 300


# ------------------------------------------------ StrategyMultiObjective ----

MO_FIELDS = tuple(convert.MO_FIELDS)


def _mo_pair(mu, lam, dim, seed, nobj=2):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 1.0, size=(mu, dim)).astype(np.float32)
    if nobj == 2:
        f0 = np.array(_zdt1_jax(jnp.asarray(x0)))
    else:
        f0 = np.array(jax.vmap(lambda x: jbm.dtlz2(x, nobj))(
            jnp.asarray(x0)))
    spec = FitnessSpec((-1.0,) * nobj)
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    return (jcma.StrategyMultiObjective(x0, f0, sigma=0.1, mu=mu,
                                        lambda_=lam, spec=JSpec(spec.weights)),
            cma.StrategyMultiObjective(x0, f0, sigma=0.1, mu=mu, lambda_=lam,
                                       spec=spec, device="cpu"))


def _mo_to_port(jstate):
    return convert.mo_state_from_arrays(
        **{f: np.asarray(getattr(jstate, f)) for f in MO_FIELDS},
        device="cpu")


def _mo_values(x, nobj):
    if nobj == 2:
        return _zdt1_jax(x)
    return jax.vmap(lambda v: jbm.dtlz2(jnp.clip(v, 0, 1), nobj))(x)


def _mo_offspring(jstate, parent, rng):
    """Offspring of numpy normals from the given parents, as the
    reference's generate forms them."""
    arz = rng.standard_normal((parent.shape[0], jstate.x.shape[1])).astype(
        np.float32)
    p = jnp.asarray(parent)
    x = jstate.x[p] + jstate.sigmas[p, None] * jnp.einsum(
        "pij,pj->pi", jstate.A[p], jnp.asarray(arz))
    return x


def _advance_mo(js, rng, parent, gens, nobj):
    """``gens`` reference generations on offspring of numpy normals."""
    update = jax.jit(js.update)
    jstate = js.initial_state()
    for _ in range(gens):
        x = _mo_offspring(jstate, parent, rng)
        jstate = update(jstate, {"x": x, "parent": jnp.asarray(parent)},
                        _mo_values(x, nobj))
    return jstate, update


#: (mu, lambda, dim, nobj, parents of the offspring or None for λ == µ)
MO_CASES = [
    (8, 8, 5, 2, None),
    (6, 10, 4, 2, [0, 0, 1, 2, 2, 2, 3, 5, 0, 1]),
    (10, 4, 5, 2, [3, 3, 3, 7]),
    (6, 6, 4, 3, None),
    (5, 9, 4, 3, [4, 4, 0, 1, 4, 2, 2, 3, 0]),
]


@pytest.mark.parametrize("mu,lam,dim,nobj,parents", MO_CASES)
def test_mo_update_equals_the_reference(mu, lam, dim, nobj, parents):
    """One update from the reference's state on the same offspring: the
    chosen mask and the survivors equal, each parent's compounded success
    rate and step size (several children of one parent in order) and
    every entry within tolerance."""
    seed = mu * 100 + lam
    js, ts = _mo_pair(mu, lam, dim, seed, nobj)
    rng = np.random.default_rng(seed)
    parent = (np.arange(mu) if parents is None
              else np.asarray(parents)).astype(np.int32)
    jstate, update = _advance_mo(js, rng, parent, 4, nobj)
    select = jax.jit(js._select_mask)
    for step in range(3):
        x = _mo_offspring(jstate, parent, rng)
        values = _mo_values(x, nobj)
        genomes = {"x": x, "parent": jnp.asarray(parent)}
        want = update(jstate, genomes, values)
        state = _mo_to_port(jstate)
        tgen = {"x": _t(x),
                "parent": torch.from_numpy(parent.astype(np.int64))}
        w_all = torch.cat([ts.spec.wvalues(_t(values)), state.w])
        jw_all = jnp.concatenate([js.spec.wvalues(values), jstate.w])
        assert np.array_equal(ts._select_mask(w_all).numpy(),
                              np.asarray(select(jw_all)))
        got = ts.update(state, tgen, _t(values))
        errs = cma.field_errors(got, _mo_to_port(want), exact=cma.MO_EXACT)
        assert errs["ok"], (step, errs)
        jstate = want


def test_mo_generate_on_the_reference_draws():
    """``sample`` on the JAX package's own normals and parent scores gives
    its offspring: the parents equal, the points within tolerance; and
    ``generate`` draws normals, then scores, on the generator."""
    for mu, lam in ((7, 7), (7, 12)):
        js, ts = _mo_pair(mu, lam, 4, 5)
        rng = np.random.default_rng(mu + lam)
        jstate = js.initial_state().replace(
            A=jnp.asarray(np.tril(rng.normal(size=(mu, 4, 4))), jnp.float32),
            sigmas=jnp.asarray(rng.uniform(0.05, 0.2, mu), jnp.float32))
        key = jax.random.key(31)
        want = jax.jit(js.generate)(key, jstate)
        k_z, k_p = jax.random.split(key)
        arz = np.asarray(jax.random.normal(k_z, (lam, 4)))
        scores = (None if lam == mu else
                  _t(jax.random.uniform(k_p, (lam, mu))))
        state = _mo_to_port(jstate)
        got = ts.sample(state, torch.from_numpy(arz), scores)
        assert got["parent"].dtype == torch.int64
        np.testing.assert_array_equal(got["parent"].numpy(),
                                      np.asarray(want["parent"]))
        np.testing.assert_allclose(
            got["x"].numpy(), np.asarray(want["x"]), rtol=cma.RTOL,
            atol=cma.ATOL_FRAC * np.abs(np.asarray(want["x"])).max())
        gen = make_generator(2, "cpu")
        g2 = make_generator(2, "cpu")
        arz = torch.randn((lam, 4), generator=g2)
        sc = None if lam == mu else torch.rand((lam, mu), generator=g2)
        out = ts.generate(gen, state)
        ref = ts.sample(state, arz, sc)
        assert torch.equal(out["x"], ref["x"])
        assert torch.equal(out["parent"], ref["parent"])
    m = ts.metrics(state)
    assert ts.metric_names == js.metric_names == tuple(m)


def test_mo_initial_state_equals_the_reference():
    js, ts = _mo_pair(9, 4, 3, 1)
    got = ts.initial_state()
    errs = cma.field_errors(got, _mo_to_port(js.initial_state()),
                            exact=MO_FIELDS)
    assert errs["ok"], errs
    for name in ("d", "ptarg", "cp", "cc", "ccov", "pthresh", "mu",
                 "lambda_", "dim"):
        assert getattr(ts, name) == getattr(js, name), name


@pytest.mark.parametrize("n,seed", [(8, 0), (17, 1), (40, 2)])
def test_hypervolume_contributions_2d_bitwise(n, seed):
    """Against the JAX function bit for bit, on mixed sets: dominated
    points, masked-out points, duplicates and a reference point inside."""
    rng = np.random.default_rng(seed)
    w = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    w[1] = w[0]
    mask = rng.uniform(size=n) < 0.8
    for ref in (np.float32([-1.5, -1.5]), np.float32([-0.2, 0.1])):
        want = np.asarray(jcma.hypervolume_contributions_2d(
            jnp.asarray(w), jnp.asarray(mask), jnp.asarray(ref)))
        got = cma.hypervolume_contributions_2d(
            torch.from_numpy(w), torch.from_numpy(mask),
            torch.from_numpy(ref)).numpy()
        assert got.dtype == want.dtype == np.float32
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("seed", [5, 6])
def test_hypervolume_contributions_2d_leave_one_out(seed):
    """On a non-dominated front: each contribution is the hypervolume lost
    by leaving the point out (the JAX package's exact hypervolume and the
    port's copy, minimisation form)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.2, 1.0, size=8).astype(np.float32))
    y = np.sort(rng.uniform(0.2, 1.0, size=8).astype(np.float32))[::-1]
    pts = np.stack([x, y.copy()], axis=1)
    contrib = cma.hypervolume_contributions_2d(
        torch.from_numpy(pts), torch.ones(8, dtype=torch.bool),
        torch.zeros(2)).numpy()
    pts_min, ref_min = -pts, np.zeros(2)
    for hv in (j_hypervolume, hypervolume):
        total = hv(pts_min, ref_min)
        for i in range(8):
            excl = total - hv(np.delete(pts_min, i, axis=0), ref_min)
            assert contrib[i] == pytest.approx(excl, rel=1e-4, abs=1e-5)


def _zdt1_run(seed, mu, dim, ngen):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.0, 1.0, size=(mu, dim)).astype(np.float32)
    f0 = benchmarks.zdt1(torch.from_numpy(x0))
    strat = cma.StrategyMultiObjective(x0, f0, sigma=0.05, mu=mu, lambda_=mu,
                                       device="cpu")
    tb = Toolbox()
    tb.register("evaluate", lambda g: benchmarks.zdt1(g["x"].clamp(0, 1)))
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    state, _, _ = algorithms.ea_generate_update(
        make_generator(seed, "cpu"), strat.initial_state(), tb, ngen,
        strat.spec, device="cpu")
    return benchmarks.zdt1(state.x.clamp(0, 1)).numpy()


@pytest.mark.parametrize("seed", [128, 1, 2, 3])
def test_mo_cma_zdt1_hypervolume_gate(seed):
    """The JAX package's gate (tests/test_strategies.py): µ = λ = 16 on
    ZDT1 with 5 genes, 500 generations, hypervolume of ref [11, 11] above
    116."""
    front = _zdt1_run(seed, 16, 5, 500)
    assert (front[:, 0] >= 0).all() and (front[:, 0] <= 1).all()
    assert hypervolume(front, np.array([11.0, 11.0])) > 116.0
