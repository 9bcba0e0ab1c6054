"""The real-valued operators and objectives of the port against the JAX
package's on the CPU, and the continuous GA's two loops against each
other.

- ``cx_blend`` and ``mut_gaussian``: bitwise, the JAX operators' own
  draws injected into the port's draw-taking cores (the JAX operators run
  eagerly, one rounding per operation, as the port's cores compute).
- ``rastrigin`` and ``sphere``: within 8 float32 epsilons of the sum of
  the absolute terms (XLA sums and computes ``cos`` in another way).
- ``var_and`` with ``cx_two_point`` and ``mut_gaussian`` takes the fused
  plane (K1's ``add`` kind) and gives the unfused children.
- The fused Rastrigin loop (K6, ``bench_suite.py``'s fused step) and
  unfused ``ea_simple`` with ``cx_blend``, ``mut_gaussian`` and
  ``sel_tournament`` agree in distribution: multi-seed means within 3
  standard errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deap_tpu import benchmarks as jbm
from deap_tpu.ops import crossover as jcx
from deap_tpu.ops import mutation as jmut
from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
from deap_tpu_torch import benchmarks as tbm
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import crossover as tcx
from deap_tpu_torch.ops import kernels_real as tkr
from deap_tpu_torch.ops import mutation as tmut
from deap_tpu_torch.ops import variation as tvar


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("m,L,alpha", [(1, 5, 0.5), (40, 30, 0.5),
                                       (33, 7, 0.3)])
def test_cx_blend_bitwise_with_injected_draws(m, L, alpha):
    rng = np.random.default_rng(m + L)
    g1 = rng.normal(size=(m, L)).astype(np.float32) * 3
    g2 = rng.normal(size=(m, L)).astype(np.float32) * 3
    key = jax.random.key(m)
    want = jcx.pair_vmap(jcx.cx_blend)(key, jnp.asarray(g1), jnp.asarray(g2),
                                       alpha=alpha)
    u = jax.vmap(lambda k: jax.random.uniform(k, (L,)))(
        jax.random.split(key, m))
    got = tcx._blend(T(g1), T(g2), alpha, T(u))
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])


@pytest.mark.parametrize("n,L,mu,sigma,indpb", [(1, 5, 0.0, 1.0, 0.5),
                                                (50, 30, 0.0, 0.3, 0.1),
                                                (17, 8, 2.0, 0.5, 0.9)])
def test_mut_gaussian_bitwise_with_injected_draws(n, L, mu, sigma, indpb):
    g = np.random.default_rng(n).normal(size=(n, L)).astype(np.float32)
    key = jax.random.key(n + L)
    want = jmut.genome_vmap(jmut.mut_gaussian)(key, jnp.asarray(g), mu,
                                               sigma, indpb)

    def draws(k):
        km, kn = jax.random.split(k)
        return (jax.random.bernoulli(km, indpb, (L,)),
                jax.random.normal(kn, (L,)))

    mask, z = jax.vmap(draws)(jax.random.split(key, n))
    got = tmut._gaussian(T(g), mu, sigma, T(mask), T(z))
    assert_bitwise(got, want)


def test_real_operators_draw_on_the_generator():
    gen = make_generator(0, "cpu")
    g1, g2 = torch.zeros((6, 4)), torch.ones((6, 4))
    c1, c2 = ops.cx_blend(gen, g1, g2, 0.5)
    assert torch.allclose(c1 + c2, g1 + g2)  # shared γ per gene
    assert float(c1.min()) >= -0.5 and float(c1.max()) <= 1.5
    out = ops.mut_gaussian(make_generator(1, "cpu"), torch.zeros((2000, 10)),
                           1.0, 0.5, 0.3)
    moved = out[out != 0]
    assert abs(moved.numel() / out.numel() - 0.3) < 0.02
    assert abs(float(moved.mean()) - 1.0) < 0.03
    assert abs(float(moved.std()) - 0.5) < 0.03


@pytest.mark.parametrize("name", ["rastrigin", "sphere"])
@pytest.mark.parametrize("dim", [2, 30, 100])
def test_objectives_match_jax(name, dim):
    x = np.random.default_rng(dim).uniform(-5.12, 5.12,
                                           (500, dim)).astype(np.float32)
    x[:10] *= 1e-4  # near the optimum, where Rastrigin's terms cancel
    want = np.asarray(jax.vmap(getattr(jbm, name))(jnp.asarray(x)))
    got = getattr(tbm, name)(T(x)).numpy()
    assert got.shape == want.shape == (500, 1)
    if name == "rastrigin":
        scale = 10 * dim + np.abs(x * x - 10 * np.cos(2 * np.pi * x)).sum(1)
    else:
        scale = (x * x).sum(1)
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(got - want)[:, 0] <= 8 * eps * scale)
    # the kernel module's evaluations are these objectives per row
    assert torch.equal(getattr(tkr, f"eval_{name}")(T(x)), T(got[:, 0]))


def test_var_and_with_gaussian_takes_the_add_kind():
    tb = Toolbox()
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.2)
    plan = tvar.resolve_plan(tb)
    assert plan is not None and plan.mut_kind == "add"
    pop = init_population(make_generator(0, "cpu"), 31,
                          ops.uniform_genome(12, -1.0, 1.0),
                          FitnessSpec((-1.0,)), device="cpu")
    pop = pop.with_fitness(torch.zeros((31, 1)), mask=~pop.valid)
    sel = torch.randint(0, 31, (31,), generator=make_generator(1, "cpu"))
    want = algorithms.var_and(make_generator(2, "cpu"), pop, tb, 0.6, 0.5,
                              fused=False, sel_idx=sel)
    for fused in ("auto", "plain", "kernel"):
        got = algorithms.var_and(make_generator(2, "cpu"), pop, tb, 0.6, 0.5,
                                 fused=fused, sel_idx=sel)
        assert torch.equal(got.genomes, want.genomes), fused
        assert torch.equal(got.valid, want.valid)


SEEDS, N_LOOP, NGEN_LOOP = 12, 256, 10


def test_rastrigin_fused_loop_agrees_with_unfused_ea_simple():
    """The fused loop (rank tournament, gather, K6) against ``ea_simple``
    with the unfused blend and Gaussian operators: the final mean and
    best fitness over seeds within 3 standard errors."""
    dim = chip_smoke.RA_DIM
    init = ops.uniform_genome(dim, chip_smoke.RA_LOW, chip_smoke.RA_UP)
    fused, unfused = [], []
    for s in range(SEEDS):
        gen = make_generator(s, "cpu")
        genomes = init(gen, N_LOOP)
        fit = tkr.eval_rastrigin(genomes)
        for _ in range(NGEN_LOOP):
            genomes, fit = chip_smoke.rastrigin_fused_generation(gen, genomes,
                                                                 fit)
        assert torch.allclose(fit, tkr.eval_rastrigin(genomes), rtol=1e-5)
        fused.append((float(fit.mean()), float(fit.min())))
        gen = make_generator(100 + s, "cpu")
        pop = init_population(gen, N_LOOP, init, FitnessSpec((-1.0,)),
                              device="cpu")
        pop, _, _ = algorithms.ea_simple(
            gen, pop, chip_smoke.rastrigin_toolbox(), chip_smoke.RA_CXPB,
            chip_smoke.RA_MUTPB, NGEN_LOOP, device="cpu")
        unfused.append((float(pop.fitness.mean()), float(pop.fitness.min())))
    f, u = np.array(fused), np.array(unfused)
    se = np.sqrt(f.var(0, ddof=1) / SEEDS + u.var(0, ddof=1) / SEEDS)
    assert np.all(np.abs(f.mean(0) - u.mean(0)) <= 3 * se), (f.mean(0),
                                                            u.mean(0), se)
    start = float(tkr.eval_rastrigin(init(make_generator(0, "cpu"),
                                          N_LOOP)).mean())
    assert f.mean(0)[0] < 0.85 * start  # both descend
