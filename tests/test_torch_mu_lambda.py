"""The (μ + λ) and (μ, λ) loops against the JAX package, on the CPU.

- One generation of each loop with injected draws: the JAX package's
  ``var_or_masks`` and tournament aspirants for one key, turned to numpy
  and handed to the port, which then runs the step's apply (the plain
  apply and the kernel wrapper) → ``evaluate_invalid`` → selection over
  the union (μ + λ) or the children (μ, λ) → ``hof_update`` → stats on
  the same population. Populations, hall of fame, ``nevals`` and
  avg/min/max are held bitwise; ``std`` to 1e-5 of the largest fitness
  (XLA's summation order is its own).
- Whole runs agree in distribution (the two packages draw different
  numbers): OneMax (μ + λ) at μ = λ = 200 and (μ, λ) at μ 50, λ 200, L
  100, 10 generations, the last generation's ``max`` and ``avg`` means
  over 8 seeds within 3 standard errors of their difference; the
  reference's ``examples/es/fctmin.py`` ((μ, λ) ES: ``cx_es_blend``,
  ``mut_es_log_normal`` floored at 0.5, sphere) by the log10 of its final
  best, and ``examples/ga/kursawefct.py`` ((μ + λ) NSGA-II on Kursawe) by
  its final non-dominated count, each over 8 seeds within 3 standard
  errors.
- The logbooks carry the same header and render the same header line.

The port's fctmin and kursawefct toolboxes are ``chip_smoke.py``'s (run
from the repository's root).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import fctmin_init, fctmin_toolbox, kursawe_toolbox
from deap_tpu import algorithms as jalg
from deap_tpu import benchmarks as jbm
from deap_tpu import mo as jmo
from deap_tpu import ops as jops
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import init_population as j_init_population
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.ops import selection as jsel
from deap_tpu.ops import variation as jvar
from deap_tpu.support import hof as jhof
from deap_tpu.support.stats import fitness_stats as j_fitness_stats
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import convert, mo as tmo, ops as tops
from deap_tpu_torch.core.fitness import FitnessSpec as TSpec
from deap_tpu_torch.core.population import concat, gather
from deap_tpu_torch.core.population import init_population as t_init_population
from deap_tpu_torch.core.toolbox import Toolbox as TToolbox
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.support import hof as thof
from deap_tpu_torch.support.stats import fitness_stats as t_fitness_stats

CXPB, MUTPB, INDPB, TOURNSIZE, L = 0.5, 0.2, 0.05, 3, 100
SEEDS = range(8)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def _jax_toolbox():
    tb = JToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    tb.register("mate", jops.cx_two_point)
    tb.register("mutate", jops.mut_flip_bit, indpb=INDPB)
    tb.register("select", jops.sel_tournament, tournsize=TOURNSIZE)
    return tb


def _torch_toolbox():
    tb = TToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", tops.cx_two_point)
    tb.register("mutate", tops.mut_flip_bit, indpb=INDPB)
    tb.register("select", tops.sel_tournament, tournsize=TOURNSIZE)
    return tb


_LOOPS = {"plus": (jalg.make_ea_mu_plus_lambda_step, talg.ea_mu_plus_lambda),
          "comma": (jalg.make_ea_mu_comma_lambda_step,
                    talg.ea_mu_comma_lambda)}


def _jax_runs(make_step, init, spec, toolbox, mu, lam, cxpb, mutpb, ngen,
              stats=None):
    """The JAX package's loop (``ea_mu_plus_lambda`` /
    ``ea_mu_comma_lambda`` without a plan: ``_pop_loop_init``, then
    ``lax.scan`` of the step over ``split(key, ngen)``) for every seed of
    SEEDS at once, vmapped in one compile. Returns the final populations
    and the stacked records of generations 1..ngen."""
    step = make_step(toolbox, mu, lam, cxpb, mutpb, stats)

    def run(seed):
        pop = j_init_population(jax.random.key(seed), mu, init, spec)
        pop, hof, _ = jalg._pop_loop_init(pop, toolbox, 0, stats)
        (pop, _), records = jax.lax.scan(
            step, (pop, hof), jax.random.split(jax.random.key(1000 + seed),
                                               ngen))
        return pop, records

    return jax.jit(jax.vmap(run))(jnp.asarray(list(SEEDS)))


@pytest.mark.parametrize("loop, mu, lam", [("plus", 41, 23),
                                           ("comma", 30, 90)])
def test_one_generation_with_injected_draws_is_bitwise(loop, mu, lam):
    make_step = _LOOPS[loop][0]
    tb = _jax_toolbox()
    stats = j_fitness_stats()
    # founders with structure: random genomes, a few of them unevaluated,
    # and a hall of fame of 4 seeded from the evaluated ones
    pop = j_init_population(jax.random.key(mu), mu,
                            jops.bernoulli_genome(L), JSpec((1.0,)))
    pop = jalg.evaluate_invalid(pop, tb.evaluate)
    hof = jhof.hof_update(jhof.hof_init(4, pop), pop)
    pop = pop.invalidate(jnp.arange(mu) % 7 == 3)
    key = jax.random.key(mu + 2)
    # the step as the JAX loop runs it: compiled
    (want_pop, want_hof), want_rec = jax.jit(make_step(
        tb, mu, lam, CXPB, MUTPB, stats))((pop, hof), key)

    # the step's own draws, as the JAX package makes them
    k_var, k_sel = jax.random.split(key)
    plan = jvar.resolve_plan(tb)
    masks = jvar.var_or_masks(k_var, mu, lam, L, CXPB, MUTPB, plan,
                              pop.genomes.dtype)
    pool_n = mu + lam if loop == "plus" else lam
    aspirants = jsel.tournament_aspirants(k_sel, pool_n, mu, TOURNSIZE)

    tpop = convert.population_from_arrays(pop.genomes, pop.fitness,
                                          pop.valid, pop.spec.weights,
                                          device="cpu")
    start_hof = convert.hof_from_arrays(hof.genomes, hof.fitness, hof.filled,
                                        hof.spec.weights, device="cpu")
    tmasks = tuple(T(m) for m in masks[:7]) + (None,)
    for mode in ("plain", "kernel"):
        off = talg.var_or_apply(tpop, tmasks, plan.mut_kind, mode)
        nevals = (~off.valid).sum()
        off = talg.evaluate_invalid(off, _torch_toolbox().evaluate)
        pool = concat([tpop, off]) if loop == "plus" else off
        idx = tsel._tournament_winners(pool.wvalues, T(aspirants).long())
        new_pop = gather(pool, idx)
        got_hof = thof.hof_update(start_hof, off)
        rec = t_fitness_stats().compile(new_pop)

        assert int(nevals) == int(want_rec["nevals"])
        got = convert.population_to_arrays(new_pop)
        for name in ("genomes", "fitness", "valid"):
            assert_bitwise(got[name], getattr(want_pop, name))
        got = convert.hof_to_arrays(got_hof)
        for name in ("genomes", "fitness", "filled"):
            assert_bitwise(got[name], getattr(want_hof, name))
        for name in ("avg", "min", "max"):
            assert_bitwise(rec[name], want_rec[name])
        np.testing.assert_allclose(rec["std"].numpy(),
                                   np.asarray(want_rec["std"]), rtol=0,
                                   atol=1e-5 * L)


def _within_3_standard_errors(jax_runs, torch_runs):
    jr, tr = (np.asarray(r, np.float64).reshape(len(r), -1)
              for r in (jax_runs, torch_runs))
    se = np.sqrt(jr.var(0, ddof=1) / len(jr) + tr.var(0, ddof=1) / len(tr))
    diff = np.abs(jr.mean(0) - tr.mean(0))
    assert np.all(diff <= 3 * se + 1e-9), (jr.mean(0), tr.mean(0), se)
    return jr.mean(0), tr.mean(0)


@pytest.mark.parametrize("loop, mu, lam", [("plus", 200, 200),
                                           ("comma", 50, 200)])
def test_onemax_runs_agree_in_distribution(loop, mu, lam):
    ngen = 10
    make_step, trun = _LOOPS[loop]
    _, records = _jax_runs(make_step, jops.bernoulli_genome(L),
                           JSpec((1.0,)), _jax_toolbox(), mu, lam, CXPB,
                           MUTPB, ngen, stats=j_fitness_stats())
    jax_runs = np.stack([records["max"][:, -1], records["avg"][:, -1]], 1)
    ttb, torch_runs = _torch_toolbox(), []
    for seed in SEEDS:
        gen = make_generator(seed, "cpu")
        tpop = t_init_population(gen, mu, tops.bernoulli_genome(L),
                                 TSpec((1.0,)), device="cpu")
        _, tlb, hof = trun(gen, tpop, ttb, mu, lam, CXPB, MUTPB, ngen,
                           stats=t_fitness_stats(), halloffame_size=1,
                           device="cpu")
        torch_runs.append((tlb[-1]["max"], tlb[-1]["avg"]))
        assert float(hof.fitness[0, 0]) >= tlb[-1]["max"] or loop == "comma"
        # gen 0 evaluates the μ founders, each later generation at most the
        # λ children (as the JAX records say)
        nevals = tlb.select("nevals")
        assert nevals[0] == mu and len(nevals) == ngen + 1
        assert max(nevals[1:]) <= lam
    assert int(np.asarray(records["nevals"]).max()) <= lam
    _, tmean = _within_3_standard_errors(jax_runs, torch_runs)
    assert tmean[1] > 60  # and both evolve


def test_logbooks_render_the_same_header():
    """The same fields, the same header line (column widths follow the
    values) and the same ``nevals`` for one seed's gen 0."""
    for loop, (_, trun) in _LOOPS.items():
        jrun = (jalg.ea_mu_plus_lambda if loop == "plus"
                else jalg.ea_mu_comma_lambda)
        pop = j_init_population(jax.random.key(0), 20,
                                jops.bernoulli_genome(L), JSpec((1.0,)))
        _, jlb, _ = jrun(jax.random.key(1), pop, _jax_toolbox(), 20, 40,
                         CXPB, MUTPB, 2, stats=j_fitness_stats())
        gen = make_generator(0, "cpu")
        tpop = t_init_population(gen, 20, tops.bernoulli_genome(L),
                                 TSpec((1.0,)), device="cpu")
        _, tlb, _ = trun(gen, tpop, _torch_toolbox(), 20, 40, CXPB, MUTPB, 2,
                         stats=t_fitness_stats(), device="cpu")
        assert tlb.header == jlb.header == ["gen", "nevals", "avg", "std",
                                            "min", "max"]
        assert (tlb.stream.splitlines()[0].split()
                == jlb.stream.splitlines()[0].split())
        assert len(tlb) == len(jlb) == 3
        assert tlb.select("nevals")[0] == jlb.select("nevals")[0] == 20


def _fctmin_jax_toolbox():
    """examples/es/fctmin.py: μ 10, λ 100, 30 genes, cx_es_blend(0.1),
    mut_es_log_normal(c=1, indpb=0.03) floored at 0.5, tournament 3,
    sphere, cxpb 0.6, mutpb 0.3."""
    def mate(key, a, b):
        (c1x, c1s), (c2x, c2s) = jops.cx_es_blend(
            key, a["x"], a["strategy"], b["x"], b["strategy"], alpha=0.1)
        return {"x": c1x, "strategy": c1s}, {"x": c2x, "strategy": c2s}

    mut = jops.strategy_floor(0.5)(jops.mut_es_log_normal)

    def mutate(key, a):
        x, s = mut(key, a["x"], a["strategy"], c=1.0, indpb=0.03)
        return {"x": x, "strategy": s}

    tb = JToolbox()
    tb.register("evaluate",
                lambda g: jax.vmap(jbm.sphere)(g["x"])[:, 0])
    tb.register("mate", mate)
    tb.register("mutate", mutate)
    tb.register("select", jops.sel_tournament, tournsize=3)
    return tb


def _fctmin_jax_init(key):
    kx, ks = jax.random.split(key)
    return {"x": jax.random.uniform(kx, (30,), minval=-3.0, maxval=3.0),
            "strategy": jax.random.uniform(ks, (30,), minval=0.5,
                                           maxval=3.0)}


def _fctmin_torch(seed, ngen):
    gen = make_generator(seed, "cpu")
    pop = t_init_population(gen, 10, fctmin_init, TSpec((-1.0,)),
                            device="cpu")
    pop, lb, _ = talg.ea_mu_comma_lambda(gen, pop, fctmin_toolbox(), 10, 100,
                                         0.6, 0.3, ngen, device="cpu")
    assert lb.select("nevals")[0] == 10
    return float(-pop.wvalues.max())


def test_fctmin_es_agrees_in_distribution():
    ngen = 100
    pops, _ = _jax_runs(jalg.make_ea_mu_comma_lambda_step, _fctmin_jax_init,
                        JSpec((-1.0,)), _fctmin_jax_toolbox(), 10, 100, 0.6,
                        0.3, ngen)
    jax_best = np.log10(np.asarray(pops.fitness).min(axis=(1, 2)))
    torch_best = [np.log10(_fctmin_torch(s, ngen)) for s in SEEDS]
    _, tmean = _within_3_standard_errors(jax_best, torch_best)
    # and both descend: the founders' best sphere value is ~50
    assert np.all(np.isfinite(torch_best)) and tmean[0] < 1


def test_kursawefct_nsga2_agrees_in_distribution():
    """examples/ga/kursawefct.py: n 100, 50 generations, cx_blend(1.5),
    mut_gaussian(0, 3, 0.3), sel_nsga2, cxpb 0.5, mutpb 0.3."""
    n, ngen = 100, 50
    jtb = JToolbox()
    jtb.register("evaluate", lambda g: jax.vmap(jbm.kursawe)(g))
    jtb.register("mate", jops.cx_blend, alpha=1.5)
    jtb.register("mutate", jops.mut_gaussian, mu=0.0, sigma=3.0, indpb=0.3)
    jtb.register("select", jmo.sel_nsga2)
    pops, _ = _jax_runs(jalg.make_ea_mu_plus_lambda_step,
                        jops.uniform_genome(3, -5.0, 5.0),
                        JSpec((-1.0, -1.0)), jtb, n, n, 0.5, 0.3, ngen)
    jax_nd = [int(jmo.nondominated_mask(jnp.asarray(-f)).sum())
              for f in np.asarray(pops.fitness)]
    assert bool(np.asarray(pops.valid).all())
    ttb, torch_nd = kursawe_toolbox(), []
    for seed in SEEDS:
        gen = make_generator(seed, "cpu")
        tpop = t_init_population(gen, n, tops.uniform_genome(3, -5.0, 5.0),
                                 TSpec((-1.0, -1.0)), device="cpu")
        tpop, _, _ = talg.ea_mu_plus_lambda(gen, tpop, ttb, n, n, 0.5, 0.3,
                                            ngen, device="cpu")
        torch_nd.append(int(tmo.nondominated_mask(tpop.wvalues).sum()))
    _within_3_standard_errors(jax_nd, torch_nd)
    assert min(torch_nd) > n // 2
