"""Semantic GP and HARM-GP: the port held against the JAX package.

- ``logistic`` (K9's ``lf``: ``exp``, add, reciprocal, each rounded alone)
  within ``LF_ULPS`` ulp of ``jax.nn.sigmoid`` as XLA runs it on the CPU.
- ``add_semantic_primitives`` builds the JAX package's layout; the
  semantic mutation (random step) and crossover cores on the JAX
  operators' draws (the random trees and steps): bitwise. Their offspring
  evaluate through K9's plain version (``lf`` live) bit for bit like the
  port's scan mode, and within ``LF_PROGRAM_RTOL`` of the JAX package's
  interpreter (the logistic's last bits, carried through the programs).
- ``_kde_hist``: bitwise.
- One HARM generation on the JAX package's draws (trial parents,
  crossover and mutation children and flags, acceptance and pick draws):
  the kept offspring equal the JAX run's, genomes bit for bit.
- Whole HARM runs (``examples/gp/symbreg_harm.py`` at its smoke size):
  the final mean tree size of the port's runs over seeds in the spread of
  the JAX package's.

The JAX package's ``arity_table`` calls ``jax.core.trace_state_clean``
(moved by jax 0.9); the fixture aliases it in this test process only.
"""

import functools
import importlib

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu import ops as jops
from deap_tpu.algorithms import evaluate_invalid as jevaluate_invalid
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import gather as jgather
from deap_tpu.core.population import init_population as jinit
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.gp import semantic as jsem
from deap_tpu_torch import FitnessSpec, Toolbox, ops
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import (gp_genomes_from_arrays,
                                    gp_genomes_to_arrays,
                                    population_from_arrays)
from deap_tpu_torch.core.population import gather, init_population
from deap_tpu_torch.gp import semantic as tsem

# the modules (``gp.harm`` is also the name of the function)
jharm = importlib.import_module("deap_tpu.gp.harm")
tharm = importlib.import_module("deap_tpu_torch.gp.harm")

#: torch's CPU logistic (exp, add, reciprocal) against XLA's CPU
#: ``jax.nn.sigmoid``: the bound found over |x| <= 40
LF_ULPS = 4
#: whole programs with ``lf`` live, relative to the largest magnitude
LF_PROGRAM_RTOL = 1e-5
ML, N = 48, 32


@pytest.fixture(autouse=True)
def _trace_state_shim(monkeypatch):
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)


def _keys(seed, n):
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    return jax.random.split(jax.random.key(base), n)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _t(pop):
    return gp_genomes_from_arrays(pop, "cpu")


def _same_trees(got, want):
    got = gp_genomes_to_arrays(got)
    for k in ("nodes", "consts", "length"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        assert got[k].astype(w.dtype).tobytes() == w.tobytes(), k


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def test_logistic_within_lf_ulps_of_jax_sigmoid():
    rng = np.random.default_rng(0)
    x = np.concatenate([np.linspace(-40, 40, 4001),
                        rng.normal(0, 8, 4000)]).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    got = tgp.logistic(torch.from_numpy(x)).numpy()
    assert np.all(_ulps(got, want) <= LF_ULPS)
    assert got.min() >= 0.0 and got.max() <= 1.0
    assert tgp.logistic is tsem.gp_logistic


@functools.lru_cache(maxsize=None)
def _sets():
    return (jsem.add_semantic_primitives(jgp.math_set(1, trig=False)),
            tsem.add_semantic_primitives(tgp.math_set(1, trig=False)))


def test_add_semantic_primitives_layout():
    jps, tps = _sets()
    assert [p.name for p in tps.primitives] == [p.name
                                                for p in jps.primitives]
    assert tps.const_values == jps.const_values
    assert tps.primitives[-1].device_op == "lf"
    # every primitive evaluates through K9
    assert all(p.device_op for p in tps.primitives)
    bools = tsem.add_semantic_primitives(tgp.bool_set(2))
    assert bools.n_consts == 2 and [p.name for p in bools.primitives][-4:] \
        == ["add", "sub", "mul", "lf"]
    with pytest.raises(ValueError):
        tgp.make_mut_semantic(tgp.math_set(1), None, ML)


@functools.lru_cache(maxsize=None)
def _parents(seed):
    jps, _ = _sets()
    gen = jgp.make_generator(jps, 16, 1, 3, "half_and_half")
    return _np(jax.vmap(gen)(_keys(seed, N)))


def test_mut_semantic_core_bitwise():
    """The step ``ms`` drawn, uniform in (0, 2) a tree."""
    jps, tps = _sets()
    g = _parents(1)
    keys = _keys(2, N)
    jexpr = jgp.make_generator(jps, 8, 0, 2, "full")
    want = jax.vmap(jgp.make_mut_semantic(jps, jexpr, ML))(keys, g)

    def draws(key):
        k1, k2, k_ms = jax.random.split(key, 3)
        return (jexpr(k1), jexpr(k2),
                jax.random.uniform(k_ms, (), minval=0.0, maxval=2.0))

    tr1, tr2, ms_v = jax.vmap(draws)(keys)
    got = tsem.mut_semantic_core(tps, ML, _t(g), _t(_np(tr1)), _t(_np(tr2)),
                                 torch.from_numpy(np.array(ms_v)))
    _same_trees(got, _np(want))


def test_cx_semantic_core_bitwise_and_offspring_through_k9():
    jps, tps = _sets()
    g1, g2 = _parents(3), _parents(4)
    keys = _keys(5, N)
    jexpr = jgp.make_generator(jps, 8, 0, 2, "full")
    w1, w2 = jax.vmap(jgp.make_cx_semantic(jps, jexpr, ML))(keys, g1, g2)
    tr = _np(jax.vmap(jexpr)(keys))
    c1, c2 = tsem.cx_semantic_core(tps, ML, _t(g1), _t(g2), _t(tr))
    _same_trees(c1, _np(w1))
    _same_trees(c2, _np(w2))
    # the offspring (lf live) through K9's plain version and the scan mode
    X = np.linspace(-2.0, 2.0, 13, dtype=np.float32)[:, None]
    kids = {k: torch.cat([c1[k], c2[k]]) for k in c1}
    grouped = tgp.make_batch_interpreter(tps, ML, mode="grouped")
    got = grouped(kids, torch.from_numpy(X)).numpy()
    scan = tgp.make_batch_interpreter(tps, ML, mode="scan")
    assert got.tobytes() == scan(kids, torch.from_numpy(X)).numpy().tobytes()
    assert "lf" in {tps.primitives[b].name for b in grouped.mask}
    want = np.asarray(jgp.make_batch_interpreter(jps, ML)(
        {k: np.concatenate([np.asarray(w1[k]), np.asarray(w2[k])])
         for k in w1}, X))
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    scale = np.abs(want[fin]).max()
    assert np.abs(got[fin] - want[fin]).max() <= LF_PROGRAM_RTOL * scale


def test_semantic_operators_on_a_generator():
    _, tps = _sets()
    g = torch.Generator().manual_seed(6)
    pop = tgp.gen_half_and_half(tps, 16, 1, 3)(g, 20)
    expr = tgp.make_generator(tps, 8, 0, 2, "full")
    m = tgp.make_mut_semantic(tps, expr, ML)(g, pop)
    c1, c2 = tgp.make_cx_semantic(tps, expr, ML)(g, pop, pop)
    ar = tps.arity_table()
    for t in (m, c1, c2):
        assert t["nodes"].shape == (20, ML)
        live = torch.arange(ML) < t["length"][:, None]
        need = 1 + torch.where(live, ar[t["nodes"].long()] - 1, 0).sum(1)
        assert bool((need == 0).all())
    # a mutant is the parent plus 5 + both trees
    assert bool((m["length"] > pop["length"]).all())


# ----------------------------------------------------------------- HARM --

def test_kde_hist_bitwise():
    rng = np.random.default_rng(7)
    for n, top in ((200, 64), (2000, 40), (5, 3)):
        sizes = rng.integers(0, top + 1, n).astype(np.int32)
        want = np.asarray(jharm._kde_hist(jnp.asarray(sizes), top))
        got = tharm._kde_hist(torch.from_numpy(sizes), top).numpy()
        assert got.tobytes() == want.tobytes()


HARM = dict(alpha=0.05, beta=10.0, gamma=0.25, rho=0.9, mincutoff=20)
HN, HNBR, HML = 40, 120, 32


def _harm_toolboxes():
    X = np.linspace(-1.0, 1.0, 20, endpoint=False, dtype=np.float32)[:, None]
    y = X[:, 0] ** 4 + X[:, 0] ** 3 + X[:, 0] ** 2 + X[:, 0]
    jps, tps = jgp.math_set(1), tgp.math_set(1)
    jinterp = jgp.make_batch_interpreter(jps, HML)
    jtb = JToolbox()
    jtb.register("evaluate",
                 lambda gs: -jnp.mean((jinterp(gs, X) - y) ** 2, -1))
    jtb.register("mate", jgp.make_cx_one_point(jps))
    jtb.register("mutate", jgp.make_mut_uniform(
        jps, jgp.make_generator(jps, 16, 0, 2, "full")))
    jtb.register("select", jops.sel_tournament, tournsize=3)
    tinterp = tgp.make_batch_interpreter(tps, HML)
    Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
    ttb = Toolbox()
    ttb.register("evaluate",
                 lambda gs: -((tinterp(gs, Xt) - yt) ** 2).mean(-1))
    ttb.register("mate", tgp.make_cx_one_point(tps))
    ttb.register("mutate", tgp.make_mut_uniform(
        tps, tgp.make_generator(tps, 16, 0, 2, "full")))
    ttb.register("select", ops.sel_tournament, tournsize=3)
    return jps, tps, jtb, ttb


def test_one_harm_generation_on_the_jax_draws():
    jps, tps, jtb, ttb = _harm_toolboxes()
    key = jax.random.key(8)
    pop0 = jinit(jax.random.key(9), HN,
                 jgp.gen_half_and_half(jps, HML, 1, 2), JSpec((1.0,)))
    # the JAX run: gen 0's evaluation, then one generation
    want, _, _ = jgp.harm(key, pop0, jtb, 0.5, 0.1, 1, nbrindsmodel=HNBR,
                          **HARM)
    evaluated = jevaluate_invalid(pop0, jtb.evaluate)
    _, k_nat, k_acc, k_pick = jax.random.split(key, 4)

    @jax.jit
    def trial_draws(k, pop):
        """The draws the JAX trial population is bred from, split as
        ``_trial_offspring`` splits them."""
        k_u, k_sel, k_cx, k_mut = jax.random.split(k, 4)
        idx = jtb.select(k_sel, pop.wvalues, 2 * HNBR)
        p1 = jgather(pop, idx[:HNBR])
        p2 = jgather(pop, idx[HNBR:])
        c1, _ = jax.vmap(jtb.mate)(jax.random.split(k_cx, HNBR),
                                   p1.genomes, p2.genomes)
        m1 = jax.vmap(jtb.mutate)(jax.random.split(k_mut, HNBR), p1.genomes)
        return jax.random.uniform(k_u, (HNBR,)), idx, c1, m1

    u, idx, c1, m1 = trial_draws(k_nat, evaluated)
    th = lambda a: torch.from_numpy(np.array(a))
    tpop = population_from_arrays(_np(evaluated.genomes),
                                  np.asarray(evaluated.fitness),
                                  np.asarray(evaluated.valid), (1.0,),
                                  device="cpu")
    tnat = tharm.trial_offspring_core(tpop, th(idx), th(u), _t(_np(c1)),
                                      _t(_np(m1)), 0.5, 0.1)
    # reproduced children keep their parent's valid fitness
    u_np = np.asarray(u)
    assert np.array_equal(tnat.valid.numpy(),
                          u_np >= np.float32(0.5) + np.float32(0.1))
    take, cutoff, probs = tharm.harm_select(
        tnat, HN, HML, accept_u=th(jax.random.uniform(k_acc, (HNBR,))),
        pick_u=th(jax.random.uniform(k_pick, (HNBR,))), **HARM)
    off = gather(tnat, take)
    _same_trees(off.genomes, _np(want.genomes))
    assert cutoff >= HARM["mincutoff"] and 0 < float(probs.min()) <= 1.0
    # the kept offspring are evaluated: the port's MSE within float32
    # rounding of the JAX package's (summation order)
    fit = ttb.evaluate(off.genomes).numpy()
    wfit = np.asarray(want.fitness[:, 0])
    fin = np.isfinite(wfit)
    assert np.array_equal(fin, np.isfinite(fit))
    assert np.allclose(fit[fin], wfit[fin], rtol=1e-5, atol=1e-7)


def test_harm_runs_in_distribution_over_seeds():
    """The final mean tree size after 5 generations (pop 40, 120 trial
    children): the port's mean over 4 seeds within 3 standard errors (and
    2 nodes) of the JAX package's over 2, and no run bloats past the
    width."""
    jps, tps, jtb, ttb = _harm_toolboxes()
    jsizes = []
    for seed in range(2):
        pop = jinit(jax.random.key(100 + seed), HN,
                    jgp.gen_half_and_half(jps, HML, 1, 2), JSpec((1.0,)))
        out, _, _ = jgp.harm(jax.random.key(200 + seed), pop, jtb, 0.5, 0.1,
                             5, nbrindsmodel=HNBR, **HARM)
        jsizes.append(float(np.mean(np.asarray(out.genomes["length"]))))
    tsizes = []
    for seed in range(4):
        g = torch.Generator().manual_seed(300 + seed)
        pop = init_population(g, HN, tgp.gen_half_and_half(tps, HML, 1, 2),
                              FitnessSpec((1.0,)), device="cpu")
        out, logbook, _ = tgp.harm(g, pop, ttb, 0.5, 0.1, 5,
                                   nbrindsmodel=HNBR, **HARM)
        assert len(logbook) == 6 and bool(out.valid.all())
        tsizes.append(float(out.genomes["length"].float().mean()))
    se = np.sqrt(np.var(jsizes, ddof=1) / 2 + np.var(tsizes, ddof=1) / 4)
    assert abs(np.mean(tsizes) - np.mean(jsizes)) <= 3 * se + 2.0, (
        jsizes, tsizes)
    assert max(tsizes) < HML
