"""The ES operators, the ``sel_best`` family and Kursawe against the JAX
package, on the CPU.

The JAX operators take one individual and a key; the JAX package vmaps
them over per-individual keys. Here the draws each of those keys makes
are taken from JAX, turned to numpy and handed to the port's draw-taking
cores, and each port operator is checked to feed its cores its own
generator's draws in its stated order.

- ``cx_es_blend`` and ``cx_es_two_point``: bitwise (selects and the
  eager blend's separately rounded products and sums).
- ``mut_es_log_normal``: within ``ops.mutation.ES_ULPS`` /
  ``ES_ARG_ULPS`` of the JAX function run eagerly and inside a jitted
  ``lax.scan`` (where XLA may fuse multiply-adds); torch's ``exp`` is not
  XLA's.
- ``strategy_floor``: bitwise.
- ``sel_best`` / ``sel_worst``: bitwise on tied, ``-inf`` and
  multi-objective rows; ``sel_random`` in range.
- ``kursawe``: within ``benchmarks.KURSAWE_RTOL`` of each objective's sum
  of absolute terms.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import benchmarks as jbm
from deap_tpu import ops as jops
from deap_tpu.ops import crossover as jcx
from deap_tpu_torch import benchmarks as tbm
from deap_tpu_torch import ops as tops
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import crossover as tcx
from deap_tpu_torch.ops import mutation as tmut


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def _pairs(seed, m, L):
    rng = np.random.default_rng(seed)
    g1, g2 = (rng.uniform(-3, 3, (m, L)).astype(np.float32) for _ in "ab")
    s1, s2 = (rng.uniform(0.5, 3, (m, L)).astype(np.float32) for _ in "ab")
    return g1, s1, g2, s2


@pytest.mark.parametrize("m, L", [(64, 30), (7, 1), (33, 5)])
def test_cx_es_blend_on_jax_draws_is_bitwise(m, L):
    g1, s1, g2, s2 = _pairs(m, m, L)
    keys = jax.random.split(jax.random.key(m), m)
    want = jax.vmap(lambda k, a, b, c, d: jops.cx_es_blend(
        k, a, b, c, d, alpha=0.1))(keys, g1, s1, g2, s2)

    def draws(k):
        kg, ks = jax.random.split(k)
        return jax.random.uniform(kg, (L,)), jax.random.uniform(ks, (L,))

    ug, us = jax.vmap(draws)(keys)
    (c1, c2), (n1, n2) = (tcx._blend(T(g1), T(g2), 0.1, T(ug)),
                          tcx._blend(T(s1), T(s2), 0.1, T(us)))
    for got, w in zip((c1, n1, c2, n2), jax.tree_util.tree_leaves(want)):
        assert_bitwise(got, w)
    # the operator feeds its cores the values' uniforms, then the
    # strategies'
    args = [T(a) for a in (g1, s1, g2, s2)]
    got = tops.cx_es_blend(make_generator(5, "cpu"), *args, alpha=0.1)
    g = make_generator(5, "cpu")
    ug, us = torch.rand((m, L), generator=g), torch.rand((m, L), generator=g)
    want = (tcx._blend(args[0], args[2], 0.1, ug),
            tcx._blend(args[1], args[3], 0.1, us))
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    (want[0][0], want[1][0], want[0][1], want[1][1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m, L", [(64, 30), (9, 2), (40, 100)])
def test_cx_es_two_point_on_jax_draws_is_bitwise(m, L):
    g1, s1, g2, s2 = _pairs(m + 1, m, L)
    keys = jax.random.split(jax.random.key(m + 1), m)
    want = jax.vmap(jops.cx_es_two_point)(keys, g1, s1, g2, s2)
    lo, hi = jax.vmap(lambda k: jcx._two_points(k, L))(keys)
    c1, c2 = tcx._segment_swap(T(lo), T(hi), T(g1), T(g2))
    n1, n2 = tcx._segment_swap(T(lo), T(hi), T(s1), T(s2))
    for got, w in zip((c1, n1, c2, n2), jax.tree_util.tree_leaves(want)):
        assert_bitwise(got, w)
    args = [T(a) for a in (g1, s1, g2, s2)]
    got = tops.cx_es_two_point(make_generator(6, "cpu"), *args)
    lo, hi = tcx._two_points(make_generator(6, "cpu"), m, L)
    c1, c2 = tcx._segment_swap(lo, hi, args[0], args[2])
    n1, n2 = tcx._segment_swap(lo, hi, args[1], args[3])
    for a, b in zip(jax.tree_util.tree_leaves(got), (c1, n1, c2, n2)):
        assert torch.equal(a, b)


def _ulp(x):
    return np.spacing(np.abs(np.asarray(x, np.float32))).astype(np.float64)


def _es_draws(keys, L, indpb):
    """The draws of the JAX ``mut_es_log_normal`` under each key."""
    def one(k):
        k0, km, k1, k2 = jax.random.split(k, 4)
        return (jax.random.normal(k0, ()),
                jax.random.bernoulli(km, indpb, (L,)),
                jax.random.normal(k1, (L,)), jax.random.normal(k2, (L,)))
    return [T(a) for a in jax.vmap(one)(keys)]


def _assert_es_within_bound(got, want, c, L, draws):
    """The stated bound of ``ops.mutation``: the strategy within ES_ULPS
    ulp plus ES_ARG_ULPS ulp of the exponent's magnitude (times the
    strategy), the gene within one ulp of itself and of its step plus the
    strategy's bound times |n2|."""
    n0, mask, n1, n2 = (a.numpy().astype(np.float64) for a in draws)
    size = np.float32(L)
    t = np.float32(c) / np.sqrt(np.float32(2.0) * np.sqrt(size))
    t0 = np.float32(c) / np.sqrt(np.float32(2.0) * size)
    arg = np.abs(t0 * n0[:, None]) + np.abs(t * n1)
    wg, ws = (np.asarray(w).astype(np.float64) for w in want)
    gg, gs = (x.numpy().astype(np.float64) for x in got)
    s_bound = (tmut.ES_ULPS * _ulp(ws)
               + tmut.ES_ARG_ULPS * np.abs(ws) * _ulp(arg))
    assert np.all(np.abs(gs - ws) <= s_bound)
    step = np.abs(ws * n2)
    g_bound = _ulp(wg) + _ulp(step) + s_bound * np.abs(n2)
    assert np.all(np.abs(gg - wg) <= g_bound)
    # untouched genes are the parents' bit for bit
    off = ~draws[1].numpy()
    assert np.array_equal(gg[off], wg[off]) and np.array_equal(gs[off],
                                                               ws[off])


@pytest.mark.parametrize("m, L, c, indpb", [(500, 30, 1.0, 0.5),
                                            (200, 3, 1.0, 1.0),
                                            (100, 100, 2.0, 0.03),
                                            (50, 1, 0.5, 1.0)])
def test_mut_es_log_normal_on_jax_draws_within_the_stated_bound(m, L, c,
                                                                indpb):
    rng = np.random.default_rng(m + L)
    g = rng.uniform(-3, 3, (m, L)).astype(np.float32)
    s = rng.uniform(0.5, 3, (m, L)).astype(np.float32)
    keys = jax.random.split(jax.random.key(m + L), m)

    def mutate(k, a, b):
        return jops.mut_es_log_normal(k, a, b, c, indpb)

    eager = jax.vmap(mutate)(keys, g, s)
    _, scanned = jax.jit(lambda: jax.lax.scan(
        lambda carry, _: (carry, jax.vmap(mutate)(keys, g, s)), 0, None,
        length=1))()
    scanned = jax.tree_util.tree_map(lambda x: x[0], scanned)
    draws = _es_draws(keys, L, indpb)
    got = tmut._es_log_normal(T(g), T(s), c, *draws)
    # eagerly each operation rounds as the port's: most genes agree bit
    # for bit
    assert np.mean(got[1].numpy() == np.asarray(eager[1])) > 0.8
    for want in (eager, scanned):
        _assert_es_within_bound(got, want, c, L, draws)
    # the operator draws n0, the mask, n1, n2 in that order
    gen = make_generator(m, "cpu")
    got = tops.mut_es_log_normal(gen, T(g), T(s), c=c, indpb=indpb)
    want = tmut._es_log_normal(T(g), T(s), c, *tmut.es_log_normal_draws(
        make_generator(m, "cpu"), (m, L), indpb))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_strategy_floor_is_bitwise():
    keys = jax.random.split(jax.random.key(3), 64)
    g, s = (np.random.default_rng(3).uniform(0.0, 2.0, (64, 10))
            .astype(np.float32) for _ in "ab")
    jmut = jops.strategy_floor(0.9)(jops.mut_es_log_normal)
    want = jax.vmap(lambda k, a, b: jmut(k, a, b, 1.0, 1.0))(keys, g, s)
    draws = _es_draws(keys, 10, 1.0)
    floored = tops.strategy_floor(0.9)(tmut._es_log_normal)
    got = floored(T(g), T(s), 1.0, *draws)
    assert float(got[1].min()) >= np.float32(0.9)
    # the floor is a maximum: where JAX's unfloored strategy is above it
    # both are within the bound, where below both are 0.9 exactly
    below = np.asarray(want[1]) == np.float32(0.9)
    assert np.array_equal(got[1].numpy()[below], np.asarray(want[1])[below])
    strat = torch.tensor([[0.1, 0.9, 2.0, -1.0]])
    got = tops.strategy_floor(0.5)(lambda: (strat, strat))()
    assert_bitwise(got[1], jnp.maximum(jnp.asarray(strat.numpy()), 0.5))


_W = np.array([[1.0, 2.0], [3.0, -np.inf], [1.0, 2.0], [3.0, 0.5],
               [-np.inf, -np.inf], [1.0, 5.0], [3.0, 0.5], [-np.inf, 1.0],
               [0.0, 0.0]], np.float32)


@pytest.mark.parametrize("nobj", [1, 2])
@pytest.mark.parametrize("k", [1, 4, 9, 12])
def test_sel_best_and_worst_are_bitwise_on_ties_and_infinities(nobj, k):
    w = _W[:, :nobj]
    for jsel, tsel in ((jops.sel_best, tops.sel_best),
                       (jops.sel_worst, tops.sel_worst)):
        want = np.asarray(jsel(None, jnp.asarray(w), k))
        got = tsel(None, T(w), k)
        assert got.dtype == torch.int64
        assert np.array_equal(got.numpy(), want), (tsel.__name__, got, want)


def test_sel_random_draws_in_range():
    w = torch.zeros((17, 2))
    idx = tops.sel_random(make_generator(0, "cpu"), w, 5000)
    assert idx.dtype == torch.int64 and idx.shape == (5000,)
    assert int(idx.min()) == 0 and int(idx.max()) == 16
    counts = torch.bincount(idx, minlength=17).double()
    assert float(counts.std() / counts.mean()) < 0.15  # uniform


@pytest.mark.parametrize("n, L", [(2000, 3), (500, 30)])
def test_kursawe_within_the_stated_bound(n, L):
    x = np.random.default_rng(n).uniform(-5, 5, (n, L)).astype(np.float32)
    got = tbm.kursawe(T(x)).numpy().astype(np.float64)
    xd = x.astype(np.float64)
    a, b = xd[:, :-1], xd[:, 1:]
    mag = np.stack([(10 * np.exp(-0.2 * np.sqrt(a * a + b * b))).sum(1),
                    (np.abs(xd) ** 0.8 + 5 * np.abs(np.sin(xd ** 3))).sum(1)],
                   axis=1)
    for want in (jax.vmap(jbm.kursawe)(x), jax.jit(jax.vmap(jbm.kursawe))(x)):
        want = np.asarray(want).astype(np.float64)
        assert got.shape == want.shape == (n, 2)
        assert np.all(np.abs(got - want) <= tbm.KURSAWE_RTOL * mag)
