"""The port's real-valued operators, benchmark functions, quality metrics
and Pareto archive held against the JAX package's, on the CPU.

- Bounded SBX and polynomial mutation with the JAX package's draw planes
  injected: ``**`` is computed by another library, so values are held
  to 4 ulps of 1.0 (4.77e-7 absolute; genes lie in [0, 1]). ZDT1 and
  DTLZ2 (``sqrt``, ``sin``, ``cos``, sums in another order): 8 ulps.
  The largest gaps measured were 1 ulp of 1.0 and 5 ulps.
- ``sort_nondominated`` and the Pareto archive (through ``convert``):
  bitwise. Hypervolume: equal; convergence and diversity: relative 1e-6
  (float32 in another summation order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import benchmarks as jbm
from deap_tpu import mo as jmo
from deap_tpu import ops as jops
from deap_tpu.benchmarks import tools as jtools
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import Population as JPopulation
from deap_tpu.support import pareto as jpareto
from deap_tpu_torch import benchmarks as tbm
from deap_tpu_torch import convert
from deap_tpu_torch import mo as tmo
from deap_tpu_torch.benchmarks import tools as ttools
from deap_tpu_torch.ops import crossover as tcx
from deap_tpu_torch.ops import mutation as tmut
from deap_tpu_torch.support import pareto as tpareto


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def ulps(a, b):
    """Largest distance in units in the last place between float32s."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def test_sort_nondominated_equals_jax():
    rng = np.random.default_rng(40)
    w = rng.integers(0, 4, (50, 2)).astype(np.float32)
    for first in (False, True):
        wr, wo = jmo.sort_nondominated(jnp.asarray(w), 30,
                                       first_front_only=first)
        gr, go = tmo.sort_nondominated(T(w), 30, first_front_only=first)
        assert_bitwise(gr, wr)
        assert_bitwise(go, wo)


# ----------------------------------------------------- real operators ----

GENE_TOL = 4 * float(np.finfo(np.float32).eps)


@pytest.mark.parametrize("eta", [20.0, 2.0])
def test_sbx_bounded_with_injected_planes_matches_jax(eta):
    rng = np.random.default_rng(int(eta))
    g1 = rng.random((300, 12)).astype(np.float32)
    g2 = rng.random((300, 12)).astype(np.float32)
    g2[:, :2] = g1[:, :2]  # equal parents: never crossed
    key = jax.random.key(int(eta))
    kg, kr, ks = jax.random.split(key, 3)
    coin = jax.random.bernoulli(kg, 0.5, g1.shape)
    rand = jax.random.uniform(kr, g1.shape)
    swap = jax.random.bernoulli(ks, 0.5, g1.shape)
    want = jops.cx_simulated_binary_bounded(key, jnp.asarray(g1),
                                            jnp.asarray(g2), eta, 0.0, 1.0)
    got = tcx._sbx_bounded(T(g1), T(g2), eta, 0.0, 1.0, T(coin), T(rand),
                           T(swap))
    for a, b, parent in zip(got, want, (g1, g2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=GENE_TOL)
        # the same genes change
        assert np.array_equal(a.numpy() != parent, np.asarray(b) != parent)
        assert a.min() >= 0.0 and a.max() <= 1.0
    assert np.array_equal(got[0].numpy()[:, :2], g1[:, :2])


@pytest.mark.parametrize("eta", [20.0, 2.0])
def test_polynomial_bounded_with_injected_planes_matches_jax(eta):
    rng = np.random.default_rng(int(eta) + 1)
    g = rng.random((300, 12)).astype(np.float32)
    g[0, :3] = [0.0, 1.0, 0.5]  # the bounds themselves
    key = jax.random.key(int(eta) + 1)
    km, kr = jax.random.split(key)
    mask = jax.random.bernoulli(km, 0.3, g.shape)
    rand = jax.random.uniform(kr, g.shape)
    want = jops.mut_polynomial_bounded(key, jnp.asarray(g), eta, 0.0, 1.0,
                                       0.3)
    got = tmut._polynomial_bounded(T(g), eta, 0.0, 1.0, T(mask), T(rand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=GENE_TOL)
    assert np.array_equal(got.numpy()[~np.asarray(mask)],
                          g[~np.asarray(mask)])
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_real_operators_draw_with_the_generator():
    from deap_tpu_torch.device import make_generator
    g1, g2 = torch.rand(64, 5), torch.rand(64, 5)
    a = tcx.cx_simulated_binary_bounded(make_generator(1, "cpu"), g1, g2,
                                        20.0, 0.0, 1.0)
    b = tcx._sbx_bounded(g1, g2, 20.0, 0.0, 1.0, *tcx.sbx_bounded_draws(
        make_generator(1, "cpu"), g1.shape))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    m = tmut.mut_polynomial_bounded(make_generator(2, "cpu"), g1, 20.0, 0.0,
                                    1.0, 0.2)
    assert torch.equal(m, tmut._polynomial_bounded(
        g1, 20.0, 0.0, 1.0, *tmut.polynomial_bounded_draws(
            make_generator(2, "cpu"), g1.shape, 0.2)))


def test_zdt1_and_dtlz2_match_jax_to_8_ulps():
    rng = np.random.default_rng(50)
    x = rng.random((1000, 12)).astype(np.float32)
    x[0] = 0.0
    x[1] = 1.0
    want = jax.vmap(lambda xi: jbm.dtlz2(xi, 3))(jnp.asarray(x))
    got = tbm.dtlz2(T(x), 3)
    assert got.shape == (1000, 3) and ulps(got, want) <= 8
    x5 = x[:, :5].copy()
    x5[0, 0] = 1e-3
    want = jax.vmap(jbm.zdt1)(jnp.asarray(x5))
    got = tbm.zdt1(T(x5))
    assert got.shape == (1000, 2) and ulps(got, want) <= 8


# ----------------------------------------------------- metrics, archive --

def test_metrics_and_optimal_fronts_match_jax():
    rng = np.random.default_rng(60)
    front = np.sort(rng.random((20, 2)).astype(np.float32), axis=0)
    front[:, 1] = front[::-1, 1]
    zopt = jtools.optimal_front("zdt1", 50)
    np.testing.assert_allclose(ttools.optimal_front("zdt1", 50).numpy(),
                               np.asarray(zopt), rtol=0, atol=1e-7)
    dopt = ttools.optimal_front("dtlz2", 91, 3)
    np.testing.assert_allclose(dopt.numpy(), np.asarray(
        jtools.optimal_front("dtlz2", 91, 3)), rtol=0, atol=1e-7)
    assert ttools.hypervolume(front, ref=[2.0, 2.0]) == \
        jtools.hypervolume(front, ref=[2.0, 2.0])
    np.testing.assert_allclose(
        ttools.convergence(front, np.asarray(zopt)),
        jtools.convergence(front, zopt), rtol=1e-6)
    np.testing.assert_allclose(
        ttools.diversity(front, [0.0, 1.0], [1.0, 0.0]),
        jtools.diversity(front, [0.0, 1.0], [1.0, 0.0]), rtol=1e-6)
    with pytest.raises(ValueError, match="no analytic front"):
        ttools.optimal_front("kursawe")


def _archive_pops(rng, n, L, weights):
    base = rng.random((8, L)) < 0.5
    genomes = base[rng.integers(0, 8, n)]          # exact duplicates
    fitness = rng.integers(0, 4, (n, len(weights))).astype(np.float32)
    fitness[genomes[:, 0]] = fitness[genomes[:, 0]][:1]
    valid = rng.random(n) < 0.9
    return genomes, fitness, valid


@pytest.mark.parametrize("weights", [(1.0, 1.0), (-1.0, 1.0, -1.0)])
def test_pareto_update_through_convert_equals_jax(weights):
    rng = np.random.default_rng(len(weights))
    cap = 6
    ja = ta = None
    for _ in range(3):
        g, f, v = _archive_pops(rng, 40, 10, weights)
        jpop = JPopulation(genomes=jnp.asarray(g), fitness=jnp.asarray(f),
                           valid=jnp.asarray(v), spec=JSpec(weights))
        tpop = convert.population_from_arrays(g, f, v, weights, device="cpu")
        if ja is None:
            ja = jpareto.pareto_init(cap, jpop)
            ta = tpareto.pareto_init(cap, tpop)
        ja = jpareto.pareto_update(ja, jpop)
        arr = convert.pareto_to_arrays(tpareto.pareto_update(ta, tpop))
        # the next merge starts from the archive carried through numpy
        ta = convert.pareto_from_arrays(arr["genomes"], arr["fitness"],
                                        arr["filled"], arr["weights"],
                                        device="cpu")
        for name in ("genomes", "fitness", "filled"):
            assert_bitwise(arr[name], getattr(ja, name))
        assert arr["weights"] == tuple(weights)
    w = np.where(v[:, None], f * np.float32(weights), -np.inf)
    assert_bitwise(tpareto.nondominated_mask(T(w), T(v), chunk=7),
                   jpareto.nondominated_mask(jnp.asarray(w), jnp.asarray(v),
                                             chunk=8))
