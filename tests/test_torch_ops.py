"""Core and support ops of the port held bit for bit against the JAX
package's on the CPU: the same numpy inputs through both.

Tournament winners with the same aspirants (ties, -inf rows, two
objectives), lexicographic sorts with ties, hall-of-fame updates with
duplicate genomes, and the fitness statistics. Tolerance: bitwise,
except where a float32 sum's order matters: XLA picks its own summation
order (and divides by ``n`` directly in eager ``jnp.var`` but multiplies
by the reciprocal inside a compiled loop), so ``std``, and ``avg`` of
fractional fitness, are held to 1e-5 of the largest ``|fitness|`` (two
float32 summation orders part by a few ``eps·Σ|x|/n`` at these sizes);
``avg`` of integer-valued fitness (an exact sum) is bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.core import fitness as jf
from deap_tpu.core.population import Population as JPopulation
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.ops import selection as jsel
from deap_tpu.support import hof as jhof
from deap_tpu.support.stats import fitness_stats as j_fitness_stats
from deap_tpu_torch import convert
from deap_tpu_torch.core import fitness as tf
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.support import hof as thof
from deap_tpu_torch.support.stats import fitness_stats as t_fitness_stats


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def _weighted(rng, n, nobj):
    w = rng.integers(0, 4, (n, nobj)).astype(np.float32)  # many ties
    w[rng.random(n) < 0.15] = -np.inf  # invalid rows
    w[rng.random((n, nobj)) < 0.1] *= -1.0  # and -0.0 beside 0.0
    return w


@pytest.mark.parametrize("nobj", [1, 2, 3])
def test_lex_sort_desc_and_compare_match_jax(nobj):
    rng = np.random.default_rng(nobj)
    w = _weighted(rng, 101, nobj)
    assert_bitwise(tf.lex_sort_desc(T(w)), jf.lex_sort_desc(jnp.asarray(w)))
    a, b = T(w), T(w[::-1].copy())
    ja, jb = jnp.asarray(w), jnp.asarray(w[::-1].copy())
    assert_bitwise(tf.lex_gt(a, b), jf.lex_gt(ja, jb))
    assert_bitwise(tf.lex_ge(a, b), jf.lex_ge(ja, jb))
    assert_bitwise(tf.dominates(a, b), jf.dominates(ja, jb))
    valid = rng.random(101) < 0.8
    assert int(tf.lex_best_index(T(w), T(valid))) == int(
        jf.lex_best_index(jnp.asarray(w), jnp.asarray(valid)))


@pytest.mark.parametrize("nobj,tournsize", [(1, 3), (2, 2), (1, 7)])
def test_tournament_winners_match_jax(nobj, tournsize):
    rng = np.random.default_rng(10 + nobj)
    n = 60
    w = _weighted(rng, n, nobj)
    aspirants = rng.integers(0, n, (n, tournsize)).astype(np.int32)
    want = jsel._tournament_winners(jnp.asarray(w), jnp.asarray(aspirants))
    got = tsel._tournament_winners(T(w), T(aspirants).long())
    assert_bitwise(got.to(torch.int32), want)


def _jax_pop(genomes, fitness, valid, weights=(1.0,)):
    return JPopulation(genomes=jnp.asarray(genomes),
                       fitness=jnp.asarray(fitness),
                       valid=jnp.asarray(valid), spec=JSpec(weights))


@pytest.mark.parametrize("weights", [(1.0,), (-1.0, 1.0)])
def test_hof_update_with_duplicates_matches_jax(weights):
    rng = np.random.default_rng(len(weights))
    n, L, k = 40, 12, 5
    base = rng.random((8, L)) < 0.5
    genomes = base[rng.integers(0, 8, n)]  # many exact duplicates
    fitness = genomes.sum(-1, keepdims=True).astype(np.float32)
    fitness = np.repeat(fitness, len(weights), axis=1)
    fitness[:, -1] = rng.integers(0, 3, n)  # ties beside duplicates
    fitness[genomes[:, 0], -1] = 7.0  # keep duplicates' fitness equal
    valid = rng.random(n) < 0.9
    jpop = _jax_pop(genomes, fitness, valid, weights)
    tpop = convert.population_from_arrays(genomes, fitness, valid, weights,
                                          device="cpu")
    jh = jhof.hof_update(jhof.hof_init(k, jpop), jpop)
    th = thof.hof_update(thof.hof_init(k, tpop), tpop)
    # and a second merge, into a filled archive
    jh, th = jhof.hof_update(jh, jpop), thof.hof_update(th, tpop)
    for name in ("genomes", "fitness", "filled"):
        assert_bitwise(getattr(th, name), getattr(jh, name))
    w = np.where(valid[:, None], fitness * np.float32(weights), -np.inf)
    assert_bitwise(thof.duplicate_mask(T(genomes), T(w), T(valid)),
                   jhof.duplicate_mask(jnp.asarray(genomes), jnp.asarray(w),
                                       jnp.asarray(valid)))


def test_gather_concat_and_hof_best_match_jax():
    from deap_tpu.core import population as jpop_mod
    from deap_tpu_torch.core import population as tpop_mod
    rng = np.random.default_rng(4)
    genomes = rng.random((9, 6)) < 0.5
    fit = rng.integers(0, 6, (9, 1)).astype(np.float32)
    valid = rng.random(9) < 0.7
    jp = _jax_pop(genomes, fit, valid)
    tp = convert.population_from_arrays(genomes, fit, valid, (1.0,),
                                        device="cpu")
    idx = rng.integers(0, 9, 12)
    jg = jpop_mod.concat([jpop_mod.gather(jp, jnp.asarray(idx)), jp])
    tg = tpop_mod.concat([tpop_mod.gather(tp, T(idx)), tp])
    for name in ("genomes", "fitness", "valid"):
        assert_bitwise(getattr(tg, name), getattr(jg, name))
    assert_bitwise(tg.wvalues, jg.wvalues)
    jh = jhof.hof_update(jhof.hof_init(3, jg), jg)
    th = thof.hof_update(thof.hof_init(3, tg), tg)
    for got, want in zip(thof.hof_best(th), jhof.hof_best(jh)):
        assert_bitwise(got, want)


def test_genome_hash_float_genomes_match_jax():
    g = np.random.default_rng(0).normal(size=(30, 9)).astype(np.float32)
    assert_bitwise(thof._genome_hash(T(g)), jhof._genome_hash(jnp.asarray(g)))


def test_initialisers_shapes_dtypes_and_ranges():
    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.ops import init as tinit
    gen = make_generator(0, "cpu")
    n = 64
    bits = tinit.bernoulli_genome(10, p=0.3)(gen, n)
    assert bits.dtype == torch.bool and bits.shape == (n, 10)
    assert 0.15 < bits.float().mean() < 0.45
    u = tinit.uniform_genome(5, -2.0, 3.0)(gen, n)
    assert u.shape == (n, 5) and bool(((u >= -2) & (u < 3)).all())
    z = tinit.normal_genome(7, mu=5.0, sigma=0.1)(gen, n)
    assert z.shape == (n, 7) and abs(float(z.mean()) - 5.0) < 0.1
    r = tinit.randint_genome(6, 2, 4)(gen, n)
    assert r.dtype == torch.int32 and set(r.unique().tolist()) == {2, 3, 4}
    p = tinit.permutation_genome(8)(gen, n)
    assert torch.equal(p.sort(-1).values,
                       torch.arange(8, dtype=torch.int32).expand(n, 8))
    c = tinit.constant_genome(torch.tensor([1.0, 2.0]))(gen, n)
    assert torch.equal(c, torch.tensor([[1.0, 2.0]]).expand(n, 2))
    rep = tinit.init_repeat(tinit.bernoulli_genome(3), 4)(gen, n)
    assert rep.shape == (n, 4, 3)
    it = tinit.init_iterate([tinit.bernoulli_genome(3),
                             tinit.uniform_genome(2)])(gen, n)
    assert it.shape == (n, 5) and it.dtype == torch.float32
    cyc = tinit.init_cycle([tinit.uniform_genome(2),
                            tinit.uniform_genome(1)], 3)(gen, n)
    assert cyc.shape == (n, 9)


def _assert_summed(got, want, fit):
    """The tolerance of a float32 reduction whose order differs."""
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(fit).max()))


@pytest.mark.parametrize("n", [1, 7, 32, 33, 300, 1000, 5000])
@pytest.mark.parametrize("integer", [True, False])
def test_fitness_stats_match_jax(n, integer):
    rng = np.random.default_rng(n)
    fit = (rng.integers(0, 101, (n, 1)) if integer
           else rng.normal(size=(n, 1)) * 10.0).astype(np.float32)
    valid = np.ones(n, bool)
    want = j_fitness_stats().compile(_jax_pop(np.zeros((n, 1)), fit, valid))
    got = t_fitness_stats().compile(convert.population_from_arrays(
        np.zeros((n, 1)), fit, valid, (1.0,), device="cpu"))
    assert list(got) == list(want)
    for name in ("min", "max") + (("avg",) if integer else ()):
        assert_bitwise(got[name], want[name])
    _assert_summed(got["avg"], want["avg"], fit)
    _assert_summed(got["std"], want["std"], fit)


def test_fitness_stats_two_objectives_match_jax():
    rng = np.random.default_rng(5)
    fit = rng.normal(size=(777, 2)).astype(np.float32)
    valid = np.ones(777, bool)
    want = j_fitness_stats().compile(_jax_pop(np.zeros((777, 1)), fit,
                                              valid, (1.0, -1.0)))
    got = t_fitness_stats().compile(convert.population_from_arrays(
        np.zeros((777, 1)), fit, valid, (1.0, -1.0), device="cpu"))
    for name in ("min", "max"):
        assert_bitwise(got[name], want[name])
    for name in ("avg", "std"):
        _assert_summed(got[name], want[name], fit)
