"""The port's main path as a whole against the JAX package, on the CPU.

- One ``ea_simple`` generation with injected draws: the JAX package's
  tournament aspirants and ``var_and_masks`` draws for one key, turned to
  numpy and handed to the port, which then runs select → apply (both the
  plain apply and the kernel wrapper) → ``evaluate_invalid`` →
  ``hof_update`` → stats on the same population. Populations, hall of
  fame, ``nevals`` and avg/min/max are held bitwise; ``std`` to 1e-5 of
  the largest fitness (XLA's summation order is its own).
- Whole runs: ``ea_simple`` OneMax at pop 300, L 100, ngen 40 (the
  reference configuration, BASELINE.md) over 8 seeds in each package.
  The two packages draw different random numbers, so the runs agree in
  distribution only: the gen-40 ``max`` and ``avg`` means must agree
  within 3 standard errors of their difference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import algorithms as jalg
from deap_tpu import ops as jops
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import init_population as j_init_population
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.ops import selection as jsel
from deap_tpu.ops import variation as jvar
from deap_tpu.support.stats import fitness_stats as j_fitness_stats
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import convert, ops as tops
from deap_tpu_torch.core.fitness import FitnessSpec as TSpec
from deap_tpu_torch.core.population import init_population as t_init_population
from deap_tpu_torch.core.toolbox import Toolbox as TToolbox
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import packed as tpacked
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.support import hof as thof
from deap_tpu_torch.support.stats import fitness_stats as t_fitness_stats

CXPB, MUTPB, INDPB, TOURNSIZE = 0.5, 0.2, 0.05, 3


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


@pytest.mark.parametrize("n", [300, 101])
def test_one_generation_with_injected_draws_is_bitwise(n):
    L = 100
    tb = _jax_toolbox()
    stats = j_fitness_stats()
    pop = j_init_population(jax.random.key(n), n,
                            jops.bernoulli_genome(L), JSpec((1.0,)))
    # a few JAX generations first, so the population has structure
    pop, _, hof = jalg.ea_simple(jax.random.key(n + 1), pop, tb, CXPB, MUTPB,
                                 3, halloffame_size=4)
    key = jax.random.key(n + 2)
    (want_pop, want_hof), want_rec = jalg.make_ea_simple_step(
        tb, CXPB, MUTPB, stats)((pop, hof), key)

    # the step's own draws, as the JAX package makes them
    k_sel, k_var = jax.random.split(key)
    aspirants = jsel.tournament_aspirants(k_sel, n, n, TOURNSIZE)
    plan = jvar.resolve_plan(tb)
    masks = jvar.var_and_masks(k_var, n, L, CXPB, MUTPB, plan,
                               pop.genomes.dtype)

    tpop = convert.population_from_arrays(pop.genomes, pop.fitness,
                                          pop.valid, pop.spec.weights,
                                          device="cpu")
    start_hof = convert.hof_from_arrays(hof.genomes, hof.fitness, hof.filled,
                                        hof.spec.weights, device="cpu")
    tmasks = tuple(T(m) for m in masks[:5]) + (None,)
    for mode in ("plain", "kernel"):
        idx = tsel._tournament_winners(tpop.wvalues, T(aspirants).long())
        off = talg.var_and_apply(tpop, tmasks, plan.mut_kind, mode,
                                 sel_idx=idx)
        nevals = (~off.valid).sum()
        off = talg.evaluate_invalid(off, _torch_toolbox().evaluate)
        got_hof = thof.hof_update(start_hof, off)
        rec = t_fitness_stats().compile(off)

        assert int(nevals) == int(want_rec["nevals"])
        got = convert.population_to_arrays(off)
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


def _gen40(logbook):
    return logbook[-1]["max"], logbook[-1]["avg"]


def test_ea_simple_onemax_runs_agree_in_distribution():
    n, L, ngen, seeds = 300, 100, 40, range(8)
    jtb, ttb = _jax_toolbox(), _torch_toolbox()
    jax_runs, torch_runs = [], []
    for seed in seeds:
        pop = j_init_population(jax.random.key(seed), n,
                                jops.bernoulli_genome(L), JSpec((1.0,)))
        _, lb, _ = jalg.ea_simple(jax.random.key(1000 + seed), pop, jtb,
                                  CXPB, MUTPB, ngen, stats=j_fitness_stats())
        jax_runs.append(_gen40(lb))
        gen = make_generator(seed, "cpu")
        tpop = t_init_population(gen, n, tops.bernoulli_genome(L),
                                 TSpec((1.0,)), device="cpu")
        _, lb, hof = talg.ea_simple(gen, tpop, ttb, CXPB, MUTPB, ngen,
                                    stats=t_fitness_stats(),
                                    halloffame_size=1, device="cpu")
        torch_runs.append(_gen40(lb))
        assert float(hof.fitness[0, 0]) >= lb[-1]["max"]
    jr, tr = np.array(jax_runs), np.array(torch_runs)
    se = np.sqrt(jr.var(0, ddof=1) / len(jr) + tr.var(0, ddof=1) / len(tr))
    diff = np.abs(jr.mean(0) - tr.mean(0))
    # 3 standard errors of the difference of the two means (max, avg)
    assert np.all(diff <= 3 * se + 1e-9), (jr.mean(0), tr.mean(0), se)
    assert tr[:, 1].mean() > 90  # and both actually evolve


@pytest.mark.parametrize("n", [2, 7, 64])
def test_var_and_modes_give_the_unfused_children(n):
    """fused='plain' / 'kernel' / 'auto' consume the generator exactly as
    the unfused composition does, and give the same children."""
    tb = _torch_toolbox()
    pop = t_init_population(make_generator(0, "cpu"), n,
                            tops.bernoulli_genome(33), TSpec((1.0,)),
                            device="cpu")
    pop = talg.evaluate_invalid(pop, tb.evaluate)
    sel = torch.randint(0, n, (n,), generator=make_generator(1, "cpu"))
    want = talg.var_and(make_generator(2, "cpu"), pop, tb, 0.7, 0.5,
                        fused=False, sel_idx=sel)
    for fused in ("auto", "plain", "kernel"):
        got = talg.var_and(make_generator(2, "cpu"), pop, tb, 0.7, 0.5,
                           fused=fused, sel_idx=sel)
        assert torch.equal(got.genomes, want.genomes)
        assert torch.equal(got.valid, want.valid)
        assert torch.equal(got.fitness, want.fitness)


def test_var_and_explicit_modes_refuse_what_they_cannot_do():
    tb = _torch_toolbox()
    tb.register("mutate", lambda g, x: x)  # not fused-capable
    pop = t_init_population(make_generator(0, "cpu"), 4,
                            tops.bernoulli_genome(8), TSpec((1.0,)),
                            device="cpu")
    with pytest.raises(ValueError, match="not fused-capable"):
        talg.var_and(make_generator(0, "cpu"), pop, tb, 0.5, 0.5,
                     fused="kernel")
    with pytest.raises(ValueError, match="unknown fused"):
        talg.var_and(make_generator(0, "cpu"), pop, _torch_toolbox(), 0.5,
                     0.5, fused="xla")


@pytest.mark.parametrize("select", ["gather", "sorted"])
def test_ea_simple_packed_evolves_onemax(select):
    gen = make_generator(3, "cpu")
    bits = tops.bernoulli_genome(100)(gen, 501)
    packed = tpacked.pack_genomes(bits)
    fit = tpacked.packed_fitness(packed)
    out, out_fit = talg.ea_simple_packed(gen, packed, fit, 100, 25,
                                         cxpb=CXPB, mutpb=MUTPB, indpb=INDPB,
                                         select=select, device="cpu")
    assert out.dtype == torch.uint32 and out.shape == packed.shape
    assert torch.equal(out_fit, tpacked.packed_fitness(out))
    assert out_fit.mean() > fit.mean() + 20
    # tail bits beyond L stay clear
    assert torch.equal(tpacked.pack_genomes(tpacked.unpack_genomes(out, 100)),
                       out)


def test_ea_simple_packed_gather_is_the_two_kernels_in_turn():
    """One generation of select='gather' is K4 then K3 on the generator's
    draws, in that order."""
    n, L = 65, 100
    gen = make_generator(4, "cpu")
    packed = tpacked.pack_genomes(tops.bernoulli_genome(L)(gen, n))
    fit = tpacked.packed_fitness(packed)
    got = talg.ea_simple_packed(make_generator(5, "cpu"), packed, fit, L, 1,
                                cxpb=CXPB, mutpb=MUTPB, indpb=INDPB,
                                device="cpu")
    g = make_generator(5, "cpu")
    parents = tpacked.sel_tournament_gather_packed_plain(
        packed, fit, tpacked.tournament_bits(g, TOURNSIZE, n))
    want = tpacked.fused_variation_eval_packed_plain(
        parents, L, *tpacked.variation_bits(g, n, packed.shape[1]),
        cxpb=CXPB, mutpb=MUTPB, indpb=INDPB)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ea_simple_packed_hw_prng_is_not_ported():
    # the packed loop's Philox path is ported: on the CPU it runs the plain
    # versions on ops.philox's streams, one key per generation
    from deap_tpu_torch.ops import kernels as tkernels, philox
    gen = make_generator(0, "cpu")
    packed = torch.zeros((4, 4), dtype=torch.uint32)
    got = talg.ea_simple_packed(gen, packed, torch.zeros(4), 100, 1,
                                cxpb=0.5, mutpb=0.2, indpb=0.05, prng="hw",
                                device="cpu")
    key = tkernels.philox_key(make_generator(0, "cpu"))
    parents = tpacked.sel_tournament_gather_packed_plain(
        packed, torch.zeros(4), philox.hw_tournament_bits(key, 3, 4))
    want = tpacked.fused_variation_eval_packed_plain(
        parents, 100, *philox.hw_packed_bits(key, 4, 4, 100), cxpb=0.5,
        mutpb=0.2, indpb=0.05)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # K6's (the Rastrigin kernel's) is not ported yet
    from deap_tpu_torch.ops import kernels_real
    g = torch.zeros((4, 3))
    with pytest.raises(NotImplementedError, match="Philox"):
        kernels_real.fused_variation_eval_real(
            g, *kernels_real.real_bits(gen, 4, 3), cxpb=0.5, mutpb=0.2,
            indpb=0.1, prng="hw")
