"""PSO, differential evolution, PBIL and EMNA (``deap_tpu_torch.
strategies``) and the Griewank and h1 benchmarks against the JAX
package's, on the CPU.

The port's pure steps take the JAX package's own draws, rebuilt here from
its keys exactly as its functions split them:

- one PSO step (``update_bests`` then ``move(u1, u2)``), one DE step
  (``step_from_draws(abc, cross_u, forced)``), PBIL's ``sample`` and
  ``update_from_draws(do_mut, bits)`` and EMNA's ``sample``: bitwise. The
  objectives of these checks add their terms left to right in both
  packages, so only the step's own arithmetic is compared; the JAX
  package's steps run eagerly, one rounding an operation, as the port's.
- EMNA's update: within ``eda.EMNA_RTOL`` (the mean and the sum of
  squares add µ rows in another order).
- Griewank and h1: within ``benchmarks.GRIEWANK_RTOL`` / ``H1_RTOL``
  (torch's ``cos``, ``sin`` and ``sqrt`` are not XLA's).
- Whole runs draw different numbers in the two packages: PSO's final
  global best over 8 seeds agrees in mean within 3 standard errors of
  the difference, and the JAX package's quality gates (PSO on h1, DE on
  sphere, PBIL on OneMax, EMNA on sphere) hold on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import benchmarks as jbm
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import Population as JPopulation
from deap_tpu.strategies import (EMNA as JEMNA, PBIL as JPBIL, PSO as JPSO,
                                 DifferentialEvolution as JDE)
from deap_tpu_torch import Toolbox, algorithms, benchmarks, convert
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.strategies import (EMNA, PBIL, PSO,
                                       DifferentialEvolution, eda)


def _t(a):
    return torch.from_numpy(np.array(a))


def _sq_sum_jax(x):
    """Σ x² over the row, added left to right (as the port's twin)."""
    acc = x[:, 0] * x[:, 0]
    for c in range(1, x.shape[1]):
        acc = acc + x[:, c] * x[:, c]
    return acc


def _sq_sum_torch(x):
    acc = x[:, 0] * x[:, 0]
    for c in range(1, x.shape[1]):
        acc = acc + x[:, c] * x[:, c]
    return acc


def _two_obj_jax(x):
    """Two objectives with ties on the first: lexicographic steps."""
    return jnp.stack([jnp.floor(x[:, 0]), _sq_sum_jax(x)], 1)


def _two_obj_torch(x):
    return torch.stack([torch.floor(x[:, 0]), _sq_sum_torch(x)], 1)


def _mean_se(a):
    a = np.asarray(a, np.float64)
    return a.mean(), a.std(ddof=1) / np.sqrt(len(a))


def _same_distribution(jax_vals, torch_vals):
    (jm, js), (tm, ts) = _mean_se(jax_vals), _mean_se(torch_vals)
    assert abs(jm - tm) <= 3 * np.hypot(js, ts) + 1e-9, (jm, js, tm, ts)


# ------------------------------------------------------------- exports --

def test_exports_match_the_jax_package():
    import deap_tpu.strategies as jstrat
    from deap_tpu_torch import mo, strategies
    assert strategies.__all__ == jstrat.__all__
    for name in ("sel_nsga3", "NSGA3Memory", "sel_spea2", "selNSGA3",
                 "selSPEA2"):
        assert name in mo.__all__ and hasattr(mo, name)
    for name in ("griewank", "h1", "movingpeaks"):
        assert name in benchmarks.__all__ and hasattr(benchmarks, name)


# ----------------------------------------------------------- benchmarks --

def test_griewank_and_h1_against_the_reference():
    rng = np.random.default_rng(0)
    x = rng.uniform(-600, 600, (257, 13)).astype(np.float32)
    want = np.asarray(jax.vmap(jbm.griewank)(jnp.asarray(x)))
    got = benchmarks.griewank(_t(x)).numpy()
    assert got.shape == want.shape == (257, 1)
    scale = 1.0 + (x.astype(np.float64) ** 2).sum(1, keepdims=True) / 4000
    assert np.all(np.abs(got - want) <= benchmarks.GRIEWANK_RTOL * scale)
    assert float(benchmarks.griewank(torch.zeros(3, 7)).abs().max()) == 0.0
    x = rng.uniform(-10, 10, (257, 2)).astype(np.float32)
    want = np.asarray(jax.vmap(jbm.h1)(jnp.asarray(x)))
    got = benchmarks.h1(_t(x)).numpy()
    assert got.shape == want.shape == (257, 1)
    np.testing.assert_allclose(got, want, rtol=benchmarks.H1_RTOL, atol=0)
    opt = benchmarks.h1(torch.tensor([[8.6998, 6.7665]]))
    assert abs(float(opt) - 2.0) < 1e-3


# -------------------------------------------------------------------- PSO --

PSO_CASES = {
    "canonical": (dict(phi1=2.0, phi2=2.0, smin=0.001, smax=3.0), (1.0,)),
    "constricted": (dict(phi1=2.05, phi2=2.05, chi=0.729843788), (-1.0,)),
    "two_objectives": (dict(phi1=1.5, phi2=2.5, smin=0.0, smax=0.5),
                       (1.0, -1.0)),
}


@pytest.mark.parametrize("case", sorted(PSO_CASES))
def test_pso_steps_bitwise_on_the_reference_draws(case):
    kw, weights = PSO_CASES[case]
    two = len(weights) == 2
    jpso = JPSO(_two_obj_jax if two else _sq_sum_jax, spec=JSpec(weights),
                **kw)
    tpso = PSO(_two_obj_torch if two else _sq_sum_torch,
               spec=FitnessSpec(weights), device="cpu", **kw)
    js = jpso.init(jax.random.key(3), 24, 3, pmin=-4.0, pmax=4.0,
                   smin=-1.0, smax=1.0)
    ts = convert.swarm_state_from_arrays(
        **{k: np.asarray(getattr(js, k)) for k in convert.SWARM_FIELDS},
        device="cpu")
    for g in range(4):
        key = jax.random.key(100 + g)
        k1, k2 = jax.random.split(key)
        u1 = jax.random.uniform(k1, (24, 3), maxval=kw["phi1"])
        u2 = jax.random.uniform(k2, (24, 3), maxval=kw["phi2"])
        js = jpso.step(key, js)
        ts = tpso.move(tpso.update_bests(ts), _t(u1), _t(u2))
        got = convert.swarm_state_to_arrays(ts)
        for k, v in got.items():
            np.testing.assert_array_equal(v, np.asarray(getattr(js, k)),
                                          err_msg=f"{k} at step {g}")
    if "smax" in kw:
        speed = np.abs(convert.swarm_state_to_arrays(ts)["v"])
        assert speed.min() >= kw["smin"] and speed.max() <= kw["smax"]


def test_pso_clamp_keeps_the_sign_and_zero_goes_positive():
    tpso = PSO(_sq_sum_torch, smin=0.5, smax=1.0, device="cpu")
    s = tpso.init(make_generator(0, "cpu"), 4, 1, 0.0, 0.0, 0.0, 0.0)
    s = s.replace(v=torch.tensor([[0.0], [-0.1], [3.0], [-3.0]]))
    zero = torch.zeros(4, 1)
    out = tpso.move(s.replace(pbest_x=s.x, gbest_x=s.x[0]), zero, zero)
    assert out.v[:, 0].tolist() == [0.5, -0.5, 1.0, -1.0]


def _jax_pso_h1_finals(seeds, ngen):
    pso = JPSO(jax.vmap(jbm.h1), smin=0.001, smax=3.0)

    def one(k):
        k1, k2 = jax.random.split(k)
        s = pso.init(k1, 20, 2, pmin=-6.0, pmax=6.0, smin=-3.0, smax=3.0)
        s, traj = pso.run(k2, s, ngen)
        return s.gbest_w[0]

    return np.asarray(jax.jit(jax.vmap(one))(
        jax.vmap(jax.random.key)(jnp.arange(seeds))))


def test_pso_h1_gate_and_distribution():
    """The JAX package's gate (20 particles, 1000 generations, gbest >
    1.6, monotone trajectory) on the port, and 8 seeds of 60 generations
    against the JAX package's in distribution."""
    pso = PSO(benchmarks.h1, smin=0.001, smax=3.0, device="cpu")
    gen = make_generator(9, "cpu")
    s = pso.init(gen, 20, 2, pmin=-6.0, pmax=6.0, smin=-3.0, smax=3.0)
    s, traj = pso.run(gen, s, 1000)
    assert traj.shape == (1000,) and float(s.gbest_w[0]) > 1.6
    assert bool((traj[1:] >= traj[:-1]).all())
    finals = []
    for seed in range(8):
        gen = make_generator(seed, "cpu")
        s = pso.init(gen, 20, 2, pmin=-6.0, pmax=6.0, smin=-3.0, smax=3.0)
        finals.append(float(pso.run(gen, s, 60)[0].gbest_w[0]))
    _same_distribution(_jax_pso_h1_finals(8, 60), finals)


# --------------------------------------------------------------------- DE --

@pytest.mark.parametrize("weights,F,CR", [((-1.0,), 1.0, 0.25),
                                          ((1.0,), 0.5, 0.9),
                                          ((-1.0, 1.0), 0.8, 0.5)])
def test_de_steps_bitwise_on_the_reference_draws(weights, F, CR):
    two = len(weights) == 2
    jde = JDE(_two_obj_jax if two else _sq_sum_jax, F=F, CR=CR,
              spec=JSpec(weights))
    tde = DifferentialEvolution(_two_obj_torch if two else _sq_sum_torch,
                                F=F, CR=CR, spec=FitnessSpec(weights))
    n, d = 33, 5
    rng = np.random.default_rng(len(weights) + int(10 * F))
    g0 = rng.uniform(-3, 3, (n, d)).astype(np.float32)
    f0 = np.asarray(_two_obj_jax(jnp.asarray(g0)) if two else
                    _sq_sum_jax(jnp.asarray(g0))[:, None])
    jpop = JPopulation(genomes=jnp.asarray(g0), fitness=jnp.asarray(f0),
                       valid=jnp.ones(n, bool), spec=JSpec(weights))
    tpop = convert.population_from_arrays(g0, f0, np.ones(n, bool), weights,
                                          device="cpu")
    for g in range(4):
        key = jax.random.key(7 * g + 1)
        k_abc, k_cr, k_idx = jax.random.split(key, 3)
        abc = jax.random.randint(k_abc, (3, n), 0, n)
        cross_u = jax.random.uniform(k_cr, (n, d))
        forced = jax.random.randint(k_idx, (n,), 0, d)
        jpop = jde.step(key, jpop)
        tpop = tde.step_from_draws(tpop, _t(abc), _t(cross_u), _t(forced))
        np.testing.assert_array_equal(tpop.genomes.numpy(),
                                      np.asarray(jpop.genomes))
        np.testing.assert_array_equal(tpop.fitness.numpy(),
                                      np.asarray(jpop.fitness))
        assert bool(tpop.valid.all())


def test_de_draws_and_sphere_gate():
    """The draws' ranges, and the JAX package's gate: sphere, 10 genes, n
    300, 200 generations, best < 1e-2, a monotone trajectory."""
    from deap_tpu_torch.core.population import init_population
    from deap_tpu_torch.ops import uniform_genome

    abc, cross_u, forced = DifferentialEvolution.draws(
        make_generator(0, "cpu"), 50, 7)
    assert abc.shape == (3, 50) and 0 <= int(abc.min()) <= int(abc.max()) < 50
    assert cross_u.shape == (50, 7) and 0 <= int(forced.min())
    assert int(forced.max()) < 7
    de = DifferentialEvolution(benchmarks.sphere, F=1.0, CR=0.25)
    gen = make_generator(2, "cpu")
    pop = init_population(gen, 300, uniform_genome(10, -3.0, 3.0),
                          FitnessSpec((-1.0,)), device="cpu")
    pop, traj = de.run(gen, pop, 200)
    assert traj.shape == (200,) and float(-pop.wvalues[:, 0].max()) < 1e-2
    assert bool((traj[1:] >= traj[:-1]).all())


# ------------------------------------------------------------------- PBIL --

def test_pbil_generate_and_update_bitwise_on_the_reference_draws():
    jp = JPBIL(ndim=37, learning_rate=0.3, mut_prob=0.4, mut_shift=0.05,
               lambda_=16)
    tp = PBIL(ndim=37, learning_rate=0.3, mut_prob=0.4, mut_shift=0.05,
              lambda_=16, device="cpu")
    js = jp.initial_state(jax.random.key(5))
    ts = convert.pbil_state_from_arrays(np.asarray(js.prob_vector), seed=1,
                                        device="cpu")
    for g in range(5):
        key = jax.random.key(50 + g)
        u = jax.random.uniform(key, (16, 37))
        genomes = jp.generate(key, js)
        got = tp.sample(ts, _t(u))
        np.testing.assert_array_equal(got.numpy(), np.asarray(genomes))
        values = genomes.sum(-1)
        _, k_m, k_b = jax.random.split(js.key, 3)
        do_mut = jax.random.bernoulli(k_m, 0.4, (37,))
        bits = jax.random.bernoulli(k_b, 0.5, (37,)).astype(jnp.float32)
        js = jp.update(js, genomes, values)
        ts = tp.update_from_draws(ts, got, _t(values), _t(do_mut), _t(bits))
        np.testing.assert_array_equal(ts.prob_vector.numpy(),
                                      np.asarray(js.prob_vector))
    # generate and update draw from their generators
    gen = make_generator(4, "cpu")
    sample = tp.generate(gen, ts)
    assert torch.equal(sample, tp.sample(ts, torch.rand(
        (16, 37), generator=make_generator(4, "cpu"))))
    before = ts.generator.get_state()
    nxt = tp.update(ts, sample, sample.sum(-1))
    replay = torch.Generator().manual_seed(0)
    replay.set_state(before)
    do_mut = torch.rand(37, generator=replay) < 0.4
    bits = (torch.rand(37, generator=replay) < 0.5).float()
    again = tp.update_from_draws(ts, sample, sample.sum(-1), do_mut, bits)
    assert torch.equal(nxt.prob_vector, again.prob_vector)


def test_pbil_onemax_gate_and_state_round_trip():
    """The JAX package's gate: 50-bit OneMax, λ 20, 50 generations, hall
    of fame >= 45."""
    pbil = PBIL(ndim=50, learning_rate=0.3, mut_prob=0.1, mut_shift=0.05,
                lambda_=20, device="cpu")
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1))
    tb.register("generate", pbil.generate)
    tb.register("update", pbil.update)
    state, _, hof = algorithms.ea_generate_update(
        make_generator(1, "cpu"),
        pbil.initial_state(make_generator(2, "cpu")), tb, ngen=50,
        spec=pbil.spec, halloffame_size=1, device="cpu")
    assert float(hof.fitness[0, 0]) >= 45.0
    arrays = convert.pbil_state_to_arrays(state)
    back = convert.pbil_state_from_arrays(
        arrays["prob_vector"], generator_state=arrays["generator_state"],
        device="cpu")
    assert torch.equal(back.prob_vector, state.prob_vector)
    assert torch.equal(torch.rand(5, generator=back.generator),
                       torch.rand(5, generator=state.generator))


# ------------------------------------------------------------------- EMNA --

def test_emna_sample_bitwise_and_update_within_rtol():
    dim, mu, lam = 30, 250, 1000
    centroid = np.linspace(-2, 5, dim).astype(np.float32)
    je = JEMNA(centroid=jnp.asarray(centroid), sigma=2.0, mu=mu, lambda_=lam)
    te = EMNA(centroid=centroid, sigma=2.0, mu=mu, lambda_=lam,
              device="cpu")
    js, ts = je.initial_state(), te.initial_state()
    for g in range(3):
        key = jax.random.key(30 + g)
        z = jax.random.normal(key, (lam, dim))
        genomes = je.generate(key, js)
        got = te.sample(ts, _t(z))
        np.testing.assert_array_equal(got.numpy(), np.asarray(genomes))
        values = jax.vmap(jbm.sphere)(genomes)
        js = je.update(js, genomes, values)
        ts = te.update(ts, got, _t(values))
        want_c = np.asarray(js.centroid)
        assert np.all(np.abs(ts.centroid.numpy() - want_c)
                      <= eda.EMNA_RTOL * np.abs(want_c).max())
        assert abs(float(ts.sigma) - float(js.sigma)) \
            <= eda.EMNA_RTOL * float(js.sigma)
        # carry the reference's state on, so each update starts equal
        ts = convert.emna_state_from_arrays(want_c, np.asarray(js.sigma),
                                            device="cpu")
    assert convert.emna_state_to_arrays(ts)["sigma"] == np.asarray(js.sigma)
    gen = make_generator(3, "cpu")
    assert torch.equal(te.generate(gen, ts), te.sample(ts, torch.randn(
        (lam, dim), generator=make_generator(3, "cpu"))))


def test_emna_sphere_gate():
    """The JAX package's gate: sphere, N 30, λ 1000, µ 250, 150
    generations, best < 1e-3."""
    emna = EMNA(centroid=[5.0] * 30, sigma=5.0, mu=250, lambda_=1000,
                device="cpu")
    tb = Toolbox()
    tb.register("evaluate", benchmarks.sphere)
    tb.register("generate", emna.generate)
    tb.register("update", emna.update)
    _, _, hof = algorithms.ea_generate_update(
        make_generator(4, "cpu"), emna.initial_state(), tb, ngen=150,
        spec=emna.spec, halloffame_size=1, device="cpu")
    assert float(hof.fitness[0, 0]) < 1e-3
