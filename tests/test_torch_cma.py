"""Hansen CMA-ES (``strategies.cma.Strategy``) and ``ea_generate_update``
against the JAX package's, on the CPU.

Tolerances, and why none is bitwise:

- Constructor parameters: the same float64 arithmetic, equal; the weights
  equal as float32.
- ``generate`` on the reference's own state (carried across by
  ``convert``, its ``B`` included) with injected ``arz``: within rtol
  1e-5, with an absolute floor of 1e-6 of the largest sample. Only the
  order of the float32 product ``arz @ BDᵀ`` may differ.
- One ``update`` from the same state, genomes and values: ``centroid``,
  ``ps``, ``pc``, ``C`` and ``sigma`` within rtol 1e-5, each with an
  absolute floor of 1e-6 of its largest entry (the off-diagonals of C sit
  near 0); ``diagD`` within rtol 1e-4; ``B`` column for column up to sign
  where an eigenvalue stands apart from its neighbours (``|Bᵀ B_ref|`` ≈
  I there), and ``‖B diag(D²) Bᵀ − C‖ ≤ 1e-3 ‖C‖``, the JAX package's own
  check. The float32 products sum in another order, and XLA's LAPACK and
  PyTorch's may iterate differently and pick other signs.
- Whole runs draw different numbers in the two packages: log10 of the
  final best agrees over seeds within 3 standard errors.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import algorithms as jalg
from deap_tpu import benchmarks as jbm
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.strategies.cma import Strategy as JStrategy
from deap_tpu.support.stats import fitness_stats as j_fitness_stats
from deap_tpu_torch import Toolbox, algorithms, benchmarks, convert
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.strategies import cma
from deap_tpu_torch.support.stats import fitness_stats

RTOL, ATOL_FRAC, DIAGD_RTOL, RECON = 1e-5, 1e-6, 1e-4, 1e-3
# an eigenvalue this far (of the largest) from its neighbours has a
# well-defined eigenvector, compared up to sign
EIG_GAP, BASIS_TOL = 1e-3, 1e-4
FIELDS = tuple(convert.CMA_FIELDS)


def _pair(dim, lam=None, **kw):
    centroid = np.linspace(-2.0, 3.0, dim).astype(np.float32)
    return (JStrategy(jnp.asarray(centroid), sigma=0.7, lambda_=lam, **kw),
            cma.Strategy(torch.from_numpy(centroid), sigma=0.7, lambda_=lam,
                         device="cpu", **kw))


def _to_port(jstate):
    return convert.cma_state_from_arrays(
        **{f: np.asarray(getattr(jstate, f)) for f in FIELDS}, device="cpu")


def _sphere_jax(x):
    return jax.vmap(jbm.sphere)(x)


def _advance(js, jstate, rng, gens):
    """``gens`` reference updates on sphere with numpy draws: a state with
    a non-trivial C, B and paths."""
    for _ in range(gens):
        arz = rng.standard_normal((js.lambda_, js.dim)).astype(np.float32)
        pop = jstate.centroid + jstate.sigma * jnp.asarray(arz) @ jstate.BD.T
        jstate = js.update(jstate, pop, _sphere_jax(pop))
    return jstate


def _close(got, want, rtol=RTOL, frac=ATOL_FRAC):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=frac * np.abs(want).max())


# --------------------------------------------------------- parameters --

@pytest.mark.parametrize("weights", ["superlinear", "linear", "equal"])
@pytest.mark.parametrize("dim,lam", [(2, None), (10, 20), (30, 7),
                                     (100, 4096)])
def test_parameters_equal_the_reference(dim, lam, weights):
    js, ts = _pair(dim, lam, weights=weights)
    assert (ts.lambda_, ts.mu, ts.dim) == (js.lambda_, js.mu, js.dim)
    assert np.array_equal(ts.weights.numpy(), np.asarray(js.weights))
    for name in ("mueff", "cc", "cs", "ccov1", "ccovmu", "damps", "chiN"):
        assert np.float32(getattr(ts, name)) == np.float32(getattr(js, name))
    with pytest.raises(RuntimeError, match="Unknown weights"):
        _pair(dim, lam, weights="cubic")


def test_parameters_take_overrides():
    js, ts = _pair(8, 12, ccum=0.3, cs=0.2, ccov1=0.05, ccovmu=0.9,
                   damps=2.5)
    for name in ("cc", "cs", "ccov1", "ccovmu", "damps"):
        assert getattr(ts, name) == getattr(js, name)


def test_initial_state_equals_the_reference():
    js, ts = _pair(6, 10)
    jstate, tstate = js.initial_state(), ts.initial_state()
    for f in FIELDS:
        want = np.asarray(getattr(jstate, f))
        got = getattr(tstate, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    over = ts.initial_state(sigma=2.0, centroid=np.ones(6, np.float32))
    jover = js.initial_state(sigma=2.0, centroid=np.ones(6, np.float32))
    assert float(over.sigma) == float(jover.sigma)
    assert np.array_equal(over.centroid.numpy(), np.asarray(jover.centroid))
    with pytest.raises(ValueError, match="shape"):
        ts.initial_state(centroid=np.ones(5))


# --------------------------------------------------- generate, update --

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generate_on_the_reference_state(seed):
    js, ts = _pair(12, 24)
    rng = np.random.default_rng(seed)
    jstate = _advance(js, js.initial_state(), rng, 6)
    arz = rng.standard_normal((24, 12)).astype(np.float32)
    want = jstate.centroid + jstate.sigma * jnp.asarray(arz) @ jstate.BD.T
    got = ts.sample(_to_port(jstate), torch.from_numpy(arz))
    _close(got.numpy(), np.asarray(want))
    # generate draws arz with randn on the caller's generator
    gen = make_generator(seed, "cpu")
    tstate = _to_port(jstate)
    got = ts.generate(gen, tstate)
    arz = torch.randn((24, 12), generator=make_generator(seed, "cpu"))
    assert torch.equal(got, ts.sample(tstate, arz))


def _t(array):
    return torch.from_numpy(np.array(array))


def _check_update(got, want, fresh=True):
    """One update against the reference's, at the module's tolerances
    (``fresh``: the update recomputed the basis, so it reconstructs C)."""
    for f in ("centroid", "ps", "pc", "C", "sigma"):
        _close(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    assert int(got.count) == int(want.count)
    _close(got.diagD.numpy(), np.asarray(want.diagD), rtol=DIAGD_RTOL,
           frac=0.0)
    # B up to column sign where the eigenvalues are apart
    ev = np.asarray(want.diagD, np.float64) ** 2
    gaps = np.diff(ev)
    apart = np.minimum(np.r_[np.inf, gaps], np.r_[gaps, np.inf]) \
        > EIG_GAP * ev.max()
    cross = np.abs(got.B.numpy().astype(np.float64).T
                   @ np.asarray(want.B, np.float64))
    np.testing.assert_allclose(cross[np.ix_(apart, apart)],
                               np.eye(int(apart.sum())), atol=BASIS_TOL)
    if not fresh:
        return int(apart.sum())
    # and by reconstruction
    B = got.B.numpy().astype(np.float64)
    C = got.C.numpy().astype(np.float64)
    d2 = got.diagD.numpy().astype(np.float64) ** 2
    assert np.linalg.norm(B @ np.diag(d2) @ B.T - C) <= RECON * \
        np.linalg.norm(C)
    return int(apart.sum())


@pytest.mark.parametrize("seed,dim,lam,gens", [(0, 10, 20, 0), (1, 10, 20, 8),
                                               (2, 30, 64, 5),
                                               (3, 5, 9, 30)])
def test_update_equals_the_reference(seed, dim, lam, gens):
    js, ts = _pair(dim, lam)
    rng = np.random.default_rng(seed)
    jstate = _advance(js, js.initial_state(), rng, gens)
    arz = rng.standard_normal((lam, dim)).astype(np.float32)
    genomes = jstate.centroid + jstate.sigma * jnp.asarray(arz) @ jstate.BD.T
    values = _sphere_jax(genomes)
    want = js.update(jstate, genomes, values)
    got = ts.update(_to_port(jstate), _t(genomes),
                    _t(values))
    apart = _check_update(got, want)
    assert apart >= 1
    # the port's own verdict, as chip_smoke.py applies it on the card
    assert cma.state_errors(got, _to_port(want))["ok"]


def test_state_errors_rejects_a_wrong_update():
    js, ts = _pair(10, 20)
    jstate = _advance(js, js.initial_state(), np.random.default_rng(4), 3)
    state = _to_port(jstate)
    assert cma.state_errors(state, state)["ok"]
    bad_C = state.C.clone()
    bad_C[0, 1] += 1e-4 * float(state.C.abs().max())
    for bad in (dataclasses.replace(state, C=bad_C),
                dataclasses.replace(state, sigma=state.sigma * 1.001),
                dataclasses.replace(state, B=state.B.roll(1, 1))):
        assert not cma.state_errors(bad, state)["ok"]
    # a column of B with its sign flipped is the same basis
    flipped = state.B.clone()
    flipped[:, 2] *= -1
    assert cma.state_errors(dataclasses.replace(state, B=flipped),
                            state)["ok"]


def test_ties_break_by_index_as_the_reference():
    """Equal values: the stable best-first order keeps index order, so the
    recombination takes the first mu of the tied rows."""
    js, ts = _pair(4, 8)
    jstate = js.initial_state()
    genomes = np.arange(32, dtype=np.float32).reshape(8, 4) / 10
    values = np.array([1, 0, 1, 0, 1, 0, 1, 0], np.float32)
    want = js.update(jstate, jnp.asarray(genomes), jnp.asarray(values))
    got = ts.update(ts.initial_state(), torch.from_numpy(genomes),
                    torch.from_numpy(values))
    _close(got.centroid.numpy(), np.asarray(want.centroid))


def test_eigen_gap_keeps_the_stale_basis_between_refreshes():
    js, ts = _pair(8, 16, eigen_gap=4)
    rng = np.random.default_rng(7)
    jstate = js.initial_state()
    tstate = ts.initial_state()
    B0 = tstate.B.clone()
    for gen in range(1, 10):
        arz = rng.standard_normal((16, 8)).astype(np.float32)
        genomes = jstate.centroid + jstate.sigma * jnp.asarray(arz) \
            @ jstate.BD.T
        values = _sphere_jax(genomes)
        stale = _to_port(jstate)
        jstate = js.update(jstate, genomes, values)
        tstate = ts.update(stale, _t(genomes),
                           _t(values))
        if gen % 4:
            # off generations: the basis is the one it came in with
            assert torch.equal(tstate.B, stale.B)
            assert torch.equal(tstate.diagD, stale.diagD)
            if gen < 4:
                assert torch.equal(tstate.B, B0)
        else:
            assert not torch.equal(tstate.B, stale.B)
        _check_update(tstate, jstate, fresh=gen % 4 == 0)
    with pytest.raises(ValueError, match="eigen_gap"):
        cma.Strategy(torch.zeros(3), 1.0, eigen_gap=0, device="cpu")


@pytest.mark.parametrize("impl", ["jacobi", "auto"])
def test_unported_eigensolvers_raise(impl):
    # both are ported: 'jacobi' is the Jacobi kernel's strategy, 'auto' the
    # dispatch tuner's pick, which is 'lapack' with no tuner (as in the
    # JAX package)
    want = {"jacobi": "jacobi", "auto": "lapack"}[impl]
    assert cma.Strategy(torch.zeros(4), 1.0, eigh_impl=impl,
                        device="cpu").eigh_impl == want
    with pytest.raises(ValueError, match="unknown eigh_impl"):
        cma.Strategy(torch.zeros(4), 1.0, eigh_impl="qr", device="cpu")


def test_metrics_and_state_properties():
    js, ts = _pair(6, 12)
    jstate = _advance(js, js.initial_state(), np.random.default_rng(8), 4)
    state = _to_port(jstate)
    assert ts.metric_names == js.metric_names
    got, want = ts.metrics(state), js.metrics(jstate)
    for name in ts.metric_names:
        _close(float(got[name]), float(want[name]))
    _close(state.BD.numpy(), np.asarray(jstate.BD))
    # the round trip through numpy is exact
    back = convert.cma_state_to_arrays(state)
    for f in FIELDS:
        assert np.array_equal(back[f], np.asarray(getattr(jstate, f)))


def test_generator_must_live_on_the_strategy_device():
    import types
    ts = cma.Strategy(torch.zeros(3), 1.0, device="cpu")
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    with pytest.raises(ValueError, match="generator"):
        ts.generate(on_card, ts.initial_state())


def test_the_port_never_lowers_float32_matmul_precision():
    """TF32 would round ``arz @ BDᵀ`` and the rank-μ product to 10 bits on
    the card: no module of the port changes the matmul precision."""
    import pathlib
    import deap_tpu_torch
    root = pathlib.Path(deap_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        text = path.read_text()
        assert "set_float32_matmul_precision(" not in text, path
        assert "allow_tf32 =" not in text, path
    assert torch.get_float32_matmul_precision() == "highest"


# ------------------------------------------------- ea_generate_update --

def _toolboxes(strat_j, strat_t):
    jtb = JToolbox()
    jtb.register("evaluate", jax.vmap(jbm.sphere))
    jtb.register("generate", strat_j.generate)
    jtb.register("update", strat_j.update)
    ttb = Toolbox()
    ttb.register("evaluate", benchmarks.sphere)
    ttb.register("generate", strat_t.generate)
    ttb.register("update", strat_t.update)
    return jtb, ttb


def test_logbook_and_hall_of_fame_match_the_reference():
    js, ts = _pair(5, 10)
    jtb, ttb = _toolboxes(js, ts)
    jstate, jlog, jhof = jalg.ea_generate_update(
        jax.random.key(0), js.initial_state(), jtb, 6, js.spec,
        stats=j_fitness_stats(), halloffame_size=3)
    state, log, hof = algorithms.ea_generate_update(
        make_generator(0, "cpu"), ts.initial_state(), ttb, 6, ts.spec,
        stats=fitness_stats(), halloffame_size=3, device="cpu")
    assert log.header == jlog.header
    assert len(log) == len(jlog) == 6
    assert [e["gen"] for e in log] == [e["gen"] for e in jlog] == list(
        range(6))
    assert [e["nevals"] for e in log] == [e["nevals"] for e in jlog]
    assert set(log[0]) == set(jlog[0])
    assert hof.genomes.shape == np.asarray(jhof.genomes).shape
    assert hof.fitness.shape == np.asarray(jhof.fitness).shape
    assert bool(hof.filled.all()) and bool(np.asarray(jhof.filled).all())
    # the hall of fame holds the best of every generation's samples
    assert float(hof.fitness[0, 0]) == min(log.select("min"))
    assert int(state.count) == 6
    # no stats, no hall of fame
    _, log, hof = algorithms.ea_generate_update(
        make_generator(0, "cpu"), ts.initial_state(), ttb, 2, ts.spec,
        device="cpu")
    assert hof is None and log.header == ["gen", "nevals"]
    assert [e["nevals"] for e in log] == [10, 10]


def test_generate_update_spends_no_draw_to_learn_lambda():
    """The loop's first generation is the strategy's first generate: the
    same state as driving generate/update by hand."""
    js, ts = _pair(5, 10)
    _, ttb = _toolboxes(js, ts)
    state, _, _ = algorithms.ea_generate_update(
        make_generator(3, "cpu"), ts.initial_state(), ttb, 4, ts.spec,
        halloffame_size=1, device="cpu")
    gen = make_generator(3, "cpu")
    st = ts.initial_state()
    for _ in range(4):
        pop = ts.generate(gen, st)
        st = ts.update(st, pop, benchmarks.sphere(pop))
    for f in FIELDS:
        assert torch.equal(getattr(state, f), getattr(st, f)), f


def test_generate_update_refuses_what_is_not_ported():
    """``plan=`` (A12) raises; ``telemetry=`` and ``probes=`` are ported
    (A11): probes without telemetry is the JAX package's ValueError."""
    js, ts = _pair(3, 6)
    _, ttb = _toolboxes(js, ts)
    gen = make_generator(0, "cpu")
    with pytest.raises(NotImplementedError, match="A12"):
        algorithms.ea_generate_update(gen, ts.initial_state(), ttb, 1,
                                      ts.spec, device="cpu", plan=object())
    with pytest.raises(ValueError, match="requires telemetry"):
        algorithms.ea_generate_update(gen, ts.initial_state(), ttb, 1,
                                      ts.spec, device="cpu",
                                      probes=(object(),))


SEEDS, NGEN = 6, 60


def test_sphere_converges_and_agrees_with_the_reference():
    """Sphere, dim 10, λ 20 from 5.0 (the JAX package's
    tests/test_strategies.py configuration at dim 10): both converge, and
    log10 of the final best agrees over seeds within 3 standard errors."""
    dim = 10
    js = JStrategy(jnp.full(dim, 5.0), sigma=0.5, lambda_=20)
    ts = cma.Strategy(torch.full((dim,), 5.0), sigma=0.5, lambda_=20,
                      device="cpu")
    jtb, ttb = _toolboxes(js, ts)
    jbest, tbest = [], []
    for s in range(SEEDS):
        _, _, jhof = jalg.ea_generate_update(
            jax.random.key(s), js.initial_state(), jtb, NGEN, js.spec,
            halloffame_size=1)
        jbest.append(np.log10(float(jhof.fitness[0, 0])))
        _, _, hof = algorithms.ea_generate_update(
            make_generator(s, "cpu"), ts.initial_state(), ttb, NGEN, ts.spec,
            halloffame_size=1, device="cpu")
        tbest.append(np.log10(float(hof.fitness[0, 0])))
    a, b = np.array(jbest), np.array(tbest)
    se = np.sqrt(a.var(ddof=1) / SEEDS + b.var(ddof=1) / SEEDS)
    assert abs(a.mean() - b.mean()) <= 3 * se, (a, b, se)
    assert b.max() < np.log10(250.0) - 3  # from ~250 at the start
