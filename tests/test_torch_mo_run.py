"""The multi-objective slice as a whole against the JAX package, on the
CPU.

- One NSGA-II 3-objective DTLZ2 generation (``bench.py``'s
  ``make_run_nsga2_3obj`` step: tournament DCD, Gaussian variation
  clipped to [0, 1], evaluation, ``sel_nsga2`` over the union) with the
  JAX package's draws injected: the same parents, the same offspring bit
  for bit, DTLZ2 values within 8 ulps, and, fed JAX's evaluated values,
  the same survivors.
- The reference's quality gate (NSGA-II on ZDT1, MU 16, 5 variables,
  bounded SBX and polynomial mutation, 100 generations): hypervolume
  > 116.0 against [11, 11] on each of 4 seeds, run by the port alone.
- DTLZ2 with 3 objectives at MU 512, 10 generations of ``bench.py``'s
  step, 8 seeds in each package: the packages draw different random
  numbers, so they agree in distribution only. The mean of ‖f‖ − 1 over
  the final first front (0 on the optimal sphere) must agree within 3
  standard errors of the difference of the two means.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from deap_tpu import benchmarks as jbm
from deap_tpu import mo as jmo
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import benchmarks as tbm
from deap_tpu_torch import mo as tmo
from deap_tpu_torch import ops as tops
from deap_tpu_torch.benchmarks.tools import hypervolume
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import concat, gather, init_population
from deap_tpu_torch.core.toolbox import Toolbox
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.mo import emo as temo

NOBJ, DIM = 3, 12


def T(a):
    return torch.from_numpy(np.array(a))


def _j_dtlz2(x):
    return jax.vmap(lambda xi: jbm.dtlz2(xi, NOBJ))(x)


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


@pytest.mark.parametrize("mu", [300, 64])
def test_one_nsga2_generation_with_injected_draws(mu):
    x = jax.random.uniform(jax.random.key(mu), (mu, DIM))
    w = -_j_dtlz2(x)
    key = jax.random.key(mu + 1)
    k_sel, k_mut = jax.random.split(key)
    # the JAX step (bench.py: gen_step)
    parents_idx = jmo.sel_tournament_dcd(k_sel, w, mu)
    noise = jax.random.normal(k_mut, (mu, DIM))
    off = jnp.clip(x[parents_idx] + 0.02 * noise, 0.0, 1.0)
    woff = -_j_dtlz2(off)
    wall = jnp.concatenate([w, woff])
    keep = jmo.sel_nsga2(None, wall, mu)

    # the port on the same draws
    k1, k2, kc = jax.random.split(k_sel, 3)
    draws = (jax.random.permutation(k1, mu), jax.random.permutation(k2, mu),
             jax.random.bernoulli(kc, 0.5, (mu,)))
    tw = T(w)
    idx = temo._dcd_winners(tw, mu, *(T(d) for d in draws))
    assert np.array_equal(idx.numpy(), np.asarray(parents_idx))
    toff = torch.clamp(T(x)[idx] + 0.02 * T(noise), 0.0, 1.0)
    assert toff.numpy().tobytes() == np.asarray(off).tobytes()
    assert _ulps(-tbm.dtlz2(toff, NOBJ), woff) <= 8
    twall = torch.cat([tw, T(woff)])
    for nd in ("standard", "tiled", "matrix"):
        got = tmo.sel_nsga2(None, twall, mu, nd=nd)
        assert np.array_equal(got.numpy(), np.asarray(keep)), nd


# ------------------------------------------------------ ZDT1 quality gate --

ZDT1_MU, ZDT1_NDIM = 16, 5


def _zdt1_run(seed, ngen=100):
    tb = Toolbox()
    tb.register("evaluate", tbm.zdt1)
    tb.register("mate", tops.cx_simulated_binary_bounded, eta=20.0, low=0.0,
                up=1.0)
    tb.register("mutate", tops.mut_polynomial_bounded, eta=20.0, low=0.0,
                up=1.0, indpb=1.0 / ZDT1_NDIM)
    gen = make_generator(seed, "cpu")
    pop = init_population(gen, ZDT1_MU, tops.uniform_genome(ZDT1_NDIM),
                          FitnessSpec((-1.0, -1.0)), device="cpu")
    pop = talg.evaluate_invalid(pop, tb.evaluate)
    for _ in range(ngen):
        idx = tmo.sel_tournament_dcd(gen, pop.wvalues, ZDT1_MU)
        off = talg.var_and(gen, gather(pop, idx), tb, cxpb=0.9, mutpb=1.0)
        off = talg.evaluate_invalid(off, tb.evaluate)
        pool = concat([pop, off])
        pop = gather(pool, tmo.sel_nsga2(gen, pool.wvalues, ZDT1_MU))
    return pop


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_nsga2_zdt1_hypervolume_gate(seed):
    pop = _zdt1_run(seed)
    hv = hypervolume(pop, ref=[11.0, 11.0])
    assert hv > 116.0, hv  # the optimum is 120.777
    assert pop.genomes.min() >= 0.0 and pop.genomes.max() <= 1.0


# ------------------------------------------- DTLZ2 runs in distribution --

MU, NGEN, SEEDS = 512, 10, range(8)


def _first_front_distance(w):
    """Mean of ||f|| - 1 over the first front (f = -w, minimisation)."""
    w = np.asarray(w)
    ranks = tmo.nd_rank(T(w), impl="matrix").numpy()
    f = -w[ranks == 0]
    return float(np.mean(np.linalg.norm(f, axis=1) - 1.0))


def _jax_runs():
    def gen_step(carry, key):
        x, w = carry
        k_sel, k_mut = jax.random.split(key)
        parents = x[jmo.sel_tournament_dcd(k_sel, w, MU)]
        off = jnp.clip(parents + 0.02 * jax.random.normal(k_mut, parents.shape),
                       0.0, 1.0)
        xall = jnp.concatenate([x, off])
        wall = jnp.concatenate([w, -_j_dtlz2(off)])
        keep = jmo.sel_nsga2(None, wall, MU)
        return (xall[keep], wall[keep]), None

    @jax.jit
    def run(key):
        k0, k1 = jax.random.split(key)
        x = jax.random.uniform(k0, (MU, DIM))
        (_, w), _ = lax.scan(gen_step, (x, -_j_dtlz2(x)),
                             jax.random.split(k1, NGEN))
        return w

    return [_first_front_distance(run(jax.random.key(100 + s)))
            for s in SEEDS]


def _torch_run(seed):
    gen = make_generator(seed, "cpu")
    x = torch.rand((MU, DIM), generator=gen)
    w = -tbm.dtlz2(x, NOBJ)
    for _ in range(NGEN):
        parents = x[tmo.sel_tournament_dcd(gen, w, MU)]
        noise = torch.randn(parents.shape, generator=gen)
        off = torch.clamp(parents + 0.02 * noise, 0.0, 1.0)
        xall = torch.cat([x, off])
        wall = torch.cat([w, -tbm.dtlz2(off, NOBJ)])
        keep = tmo.sel_nsga2(gen, wall, MU)
        x, w = xall[keep], wall[keep]
    return _first_front_distance(w)


def test_dtlz2_runs_agree_in_distribution():
    jr = np.array(_jax_runs())
    tr = np.array([_torch_run(s) for s in SEEDS])
    se = np.sqrt(jr.var(ddof=1) / len(jr) + tr.var(ddof=1) / len(tr))
    assert abs(jr.mean() - tr.mean()) <= 3 * se, (jr.mean(), tr.mean(), se)
    # and both move toward the sphere from their random start
    start = np.mean([_first_front_distance(-tbm.dtlz2(torch.rand(
        (MU, DIM), generator=make_generator(s, "cpu")), NOBJ)) for s in SEEDS])
    assert tr.mean() < start and jr.mean() < start, (start, tr, jr)
