"""The rest of the operators (A3, A7) against the JAX package's on the CPU.

Each random operator of the port draws in one place and applies its draws
in a draw-taking core; here the JAX package's own draws (its per-pair or
per-genome keys, split as its operators split them) are handed to the
core, and the two must agree (the JAX functions jitted where XLA has no
product to contract, for one compile instead of one an operation):

- bitwise: ``cx_uniform``, ``cx_partialy_matched``,
  ``cx_uniform_partialy_matched``, ``cx_ordered``, ``cx_messy_one_point``,
  ``mut_uniform_int`` (int32 and float32 genomes, scalar and per-gene
  bounds), ``mut_shuffle_indexes``, ``mut_two_opt``, ``sel_roulette`` and
  ``sel_stochastic_universal_sampling`` on integer-valued fitness,
  ``sel_double_tournament`` (both orders), the lexicase family (on
  ``jax.random.choice(p=...)``'s formula), ``delta_penalty``,
  ``closest_valid_penalty``, ``MultiStatistics`` and
  ``logbook_from_records``;
- ``cx_simulated_binary`` within ``SBX_ULPS`` (torch's ``pow`` is not
  XLA's);
- the roulette pair on fractional fitness: equal picks except where a
  pointer lies within ``ROULETTE_RTOL`` of the total from a cumulative
  boundary (torch's ``cumsum`` and XLA's may round differently).

``var_and(fused='auto')`` with ``mut_uniform_int`` takes the fused plane's
``set`` kind (K1 on the card) and gives the unfused composition's
children, as the JAX package's plan does.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import ops as jops
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import Population as JPopulation
from deap_tpu.ops import crossover as jcx
from deap_tpu.ops import mutation as jmut
from deap_tpu.ops import selection as jsel
from deap_tpu.ops import variation as jvar
from deap_tpu.support import logbook as jlog
from deap_tpu.support import stats as jstats
from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import crossover as tcx
from deap_tpu_torch.ops import mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.ops import variation as tvar
from deap_tpu_torch.support import logbook as tlog
from deap_tpu_torch.support import stats as tstats


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.astype(want.dtype).tobytes() == want.tobytes()


def _perms(rng, m, L):
    return np.stack([rng.permutation(L) for _ in range(m)]).astype(np.int32)


def _keys(seed, m):
    return jax.random.split(jax.random.key(seed), m)


def _with_draws(op, draws):
    """``op`` vmapped over a batch of keys and its arguments, and ``draws``
    (the same keys, the draws ``op`` takes), in one compile."""
    return jax.jit(lambda keys, *a: (jax.vmap(op)(keys, *a),
                                     jax.vmap(draws)(keys, *a)))


# ------------------------------------------------------------ crossovers ----

@pytest.mark.parametrize("m,L,indpb", [(1, 1, 0.5), (37, 20, 0.3),
                                       (8, 5, 1.0)])
def test_cx_uniform(m, L, indpb):
    rng = np.random.default_rng(m)
    g1, g2 = rng.normal(size=(2, m, L)).astype(np.float32)
    keys = _keys(m, m)
    want, mask = _with_draws(
        lambda k, a, b: jcx.cx_uniform(k, a, b, indpb),
        lambda k, *_: jax.random.bernoulli(k, indpb, (L,)))(keys, g1, g2)
    got = tcx._uniform(T(g1), T(g2), T(mask))
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])


def _pmx_points(k, L):
    k1, k2 = jax.random.split(k)
    c1 = jax.random.randint(k1, (), 0, L + 1)
    c2 = jax.random.randint(k2, (), 0, L)
    c2 = jnp.where(c2 >= c1, c2 + 1, c2)
    return jnp.minimum(c1, c2), jnp.maximum(c1, c2)


@pytest.mark.parametrize("m,L", [(1, 1), (1, 2), (40, 9), (25, 31)])
def test_cx_partialy_matched(m, L):
    rng = np.random.default_rng(L)
    g1, g2 = _perms(rng, m, L), _perms(rng, m, L)
    keys = _keys(L + 1, m)
    want, (lo, hi) = _with_draws(jcx.cx_partialy_matched,
                                 lambda k, *_: _pmx_points(k, L))(keys, g1,
                                                                  g2)
    slots = tcx._segment_slots(T(lo), T(hi), L)
    got = tcx._pmx(T(g1), T(g2), slots)
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    for child in got:   # still permutations
        assert torch.equal(child.sort(1).values,
                           torch.arange(L, dtype=child.dtype).expand(m, L))


@pytest.mark.parametrize("m,L,indpb", [(1, 3, 1.0), (40, 12, 0.3),
                                       (16, 50, 0.05)])
def test_cx_uniform_partialy_matched(m, L, indpb):
    rng = np.random.default_rng(L)
    g1, g2 = _perms(rng, m, L), _perms(rng, m, L)
    keys = _keys(L + 2, m)
    want, do = _with_draws(
        lambda k, a, b: jcx.cx_uniform_partialy_matched(k, a, b, indpb),
        lambda k, *_: jax.random.bernoulli(jax.random.split(k)[0], indpb,
                                           (L,)))(keys, g1, g2)
    got = tcx._pmx(T(g1), T(g2), T(do))
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])


@pytest.mark.parametrize("m,L", [(1, 2), (40, 9), (25, 31)])
def test_cx_ordered(m, L):
    rng = np.random.default_rng(L + 5)
    g1, g2 = _perms(rng, m, L), _perms(rng, m, L)
    keys = _keys(L + 3, m)
    def points(k, *_):
        k1, k2 = jax.random.split(k)
        i1 = jax.random.randint(k1, (), 0, L)
        i2 = jax.random.randint(k2, (), 0, L - 1)
        i2 = jnp.where(i2 >= i1, i2 + 1, i2)
        return jnp.minimum(i1, i2), jnp.maximum(i1, i2)

    want, (lo, hi) = _with_draws(jcx.cx_ordered, points)(keys, g1, g2)
    got = tcx._ordered(T(g1), T(g2), T(lo), T(hi))
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


@pytest.mark.parametrize("eta", [0.5, 2.0, 20.0])
def test_cx_simulated_binary_within_its_bound(eta):
    rng = np.random.default_rng(int(eta * 10))
    m, L = 300, 30
    g1, g2 = (rng.normal(size=(2, m, L)) * 3).astype(np.float32)
    keys = _keys(int(eta), m)
    want = jax.vmap(lambda k, a, b: jcx.cx_simulated_binary(k, a, b, eta))(
        keys, g1, g2)
    u = jax.jit(jax.vmap(lambda k: jax.random.uniform(k, (L,))))(keys)
    got = tcx._sbx(T(g1), T(g2), eta, T(u))
    beta = np.asarray(jcx._sbx_beta(u, eta), np.float64)
    scale = (1 + beta) * np.maximum(np.abs(g1), np.abs(g2))
    ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
    for c, w in zip(got, want):
        err = np.abs(c.numpy().astype(np.float64) - np.asarray(w))
        assert np.all(err <= tcx.SBX_ULPS * (
            np.spacing(np.abs(np.asarray(w))).astype(np.float64) + ulp))
    # the draw-taking path draws one uniform a gene
    c1, c2 = ops.cx_simulated_binary(make_generator(0, "cpu"), T(g1), T(g2),
                                     eta)
    assert c1.shape == (m, L) and torch.allclose(c1 + c2, T(g1) + T(g2),
                                                 rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,cap", [(1, 4), (40, 12)])
def test_cx_messy_one_point(m, cap):
    rng = np.random.default_rng(cap)
    g1, g2 = rng.integers(1, 9, (2, m, cap)).astype(np.int32)
    len1, len2 = rng.integers(0, cap + 1, (2, m)).astype(np.int32)
    keys = _keys(cap, m)
    def cuts(k, a, l1, b, l2):
        a, b = jax.random.split(k)
        return (jax.random.randint(a, (), 0, l1 + 1),
                jax.random.randint(b, (), 0, l2 + 1))

    ((wc1, wn1), (wc2, wn2)), (k1, k2) = _with_draws(
        jcx.cx_messy_one_point, cuts)(keys, g1, len1, g2, len2)
    (c1, n1), (c2, n2) = tcx._messy_one_point(T(g1), T(len1), T(g2),
                                              T(len2), T(k1), T(k2))
    for got, want in ((c1, wc1), (n1, wn1), (c2, wc2), (n2, wn2)):
        assert_bitwise(got, want)
    # the draw-taking path: cuts within the lengths
    (c1, n1), _ = ops.cx_messy_one_point(make_generator(1, "cpu"), T(g1),
                                         T(len1), T(g2), T(len2))
    assert c1.shape == (m, cap) and bool((n1 <= cap).all())


# ------------------------------------------------------------- mutations ----

@pytest.mark.parametrize("dtype,low,up", [
    (np.int32, 0, 9), (np.int32, -5, 5), (np.float32, 0, 1),
    (np.int32, [0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 8])])
def test_mut_uniform_int(dtype, low, up):
    n, L, indpb = 300, 6, 0.4
    rng = np.random.default_rng(3)
    g = rng.integers(0, 9, (n, L)).astype(dtype)
    keys = _keys(4, n)
    def draws(k, *_):
        km, kv = jax.random.split(k)
        return (jax.random.bernoulli(km, indpb, (L,)),
                jax.random.uniform(kv, (L,)))

    want, (mask, u) = _with_draws(
        lambda k, x: jmut.mut_uniform_int(k, x, low, up, indpb), draws)(
            keys, g)
    got = tmut._uniform_int(T(g), low, up, T(mask), T(u))
    assert got.dtype == T(g).dtype
    assert_bitwise(got, want)
    # every redrawn gene in [low, up]
    out = ops.mut_uniform_int(make_generator(2, "cpu"), T(g), low, up, 1.0)
    assert bool((out >= torch.as_tensor(low, dtype=out.dtype)).all())
    assert bool((out <= torch.as_tensor(up, dtype=out.dtype)).all())


@pytest.mark.parametrize("n,L,indpb", [(5, 1, 1.0), (40, 2, 0.5),
                                       (60, 17, 0.2)])
def test_mut_shuffle_indexes(n, L, indpb):
    rng = np.random.default_rng(L)
    g = _perms(rng, n, L)
    keys = _keys(L + 9, n)
    def draws(k, *_):
        km, kj = jax.random.split(k)
        return (jax.random.bernoulli(km, indpb, (L,)),
                jax.random.randint(kj, (L,), 0, L - 1))

    want, (do, raw) = _with_draws(
        lambda k, x: jmut.mut_shuffle_indexes(k, x, indpb), draws)(keys, g)
    got = tmut._shuffle_indexes(T(g), T(do), T(raw).long())
    assert_bitwise(got, want)
    out = ops.mut_shuffle_indexes(make_generator(3, "cpu"), T(g), 1.0)
    assert torch.equal(out.sort(1).values, T(g).sort(1).values)


@pytest.mark.parametrize("L,steps", [(8, None), (17, 5), (24, None)])
def test_mut_two_opt(L, steps):
    rng = np.random.default_rng(L)
    pts = rng.uniform(0, 100, (L, 2))
    dist = np.sqrt(((pts[:, None] - pts[None]) ** 2).sum(-1)).astype(
        np.float32)
    g = _perms(rng, 12, L)
    want = jax.jit(jax.vmap(lambda x: jmut.mut_two_opt(
        None, x, jnp.asarray(dist), steps)))(g)
    got = ops.mut_two_opt(None, T(g), T(dist), steps)
    assert_bitwise(got, want)


def test_var_and_with_uniform_int_takes_the_set_kind():
    tb = Toolbox()
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_uniform_int, low=0, up=7, indpb=0.2)
    plan = tvar.resolve_plan(tb)
    assert plan is not None and plan.mut_kind == "set"
    assert plan.mut_name == "mut_uniform_int"
    jtb = type("TB", (), {})()
    jtb.mate = functools.partial(jops.cx_two_point)
    jtb.mutate = functools.partial(jops.mut_uniform_int, low=0, up=7,
                                   indpb=0.2)
    assert jvar.resolve_plan(jtb).mut_kind == "set"
    for dtype in (torch.float32, torch.int32):
        pop = init_population(make_generator(0, "cpu"), 33,
                              ops.randint_genome(20, 0, 7),
                              FitnessSpec((1.0,)), device="cpu")
        pop = pop.replace(genomes=pop.genomes.to(dtype))
        pop = pop.with_fitness(torch.zeros((33, 1)), mask=~pop.valid)
        sel = torch.randint(0, 33, (33,), generator=make_generator(1, "cpu"))
        want = algorithms.var_and(make_generator(2, "cpu"), pop, tb, 0.6,
                                  0.5, fused=False, sel_idx=sel)
        for fused in ("auto", "plain", "kernel"):
            if fused == "kernel" and dtype == torch.int32:
                with pytest.raises(ValueError, match="kernel's set"):
                    algorithms.var_and(make_generator(2, "cpu"), pop, tb,
                                       0.6, 0.5, fused=fused, sel_idx=sel)
                continue
            got = algorithms.var_and(make_generator(2, "cpu"), pop, tb, 0.6,
                                     0.5, fused=fused, sel_idx=sel)
            assert got.genomes.dtype == dtype
            assert torch.equal(got.genomes, want.genomes), (dtype, fused)
            assert torch.equal(got.valid, want.valid)


# ------------------------------------------------------------ selections ----

def _fitness(rng, n, integer):
    v = rng.integers(1, 50, n) if integer else rng.uniform(0.1, 5.0, n)
    return v.astype(np.float32)[:, None]


def _jax_roulette(key, w, k):
    """The JAX roulette and SUS picks and their uniforms; the roulette
    jitted (it multiplies and never adds), SUS eager (jitted, XLA would
    fuse its pointers' multiply and add)."""
    roul, u = jax.jit(lambda kk: (jsel.sel_roulette(kk, w, k),
                                  jax.random.uniform(kk, (k,))))(key)
    sus = jsel.sel_stochastic_universal_sampling(key, w, k)
    return (np.asarray(roul), np.asarray(u), np.asarray(sus),
            np.asarray(jax.random.uniform(key, ())))


@pytest.mark.parametrize("n,k", [(1, 3), (50, 50), (333, 1000)])
def test_roulette_and_sus_bitwise_on_integer_fitness(n, k):
    w = _fitness(np.random.default_rng(n), n, integer=True)
    roul, u, sus, u0 = _jax_roulette(jax.random.key(n), jnp.asarray(w), k)
    assert_bitwise(tsel._roulette(T(w), T(u)), roul.astype(np.int64))
    assert_bitwise(tsel._sus(T(w), k, T(u0)), sus.astype(np.int64))
    gen = make_generator(0, "cpu")
    assert ops.sel_roulette(gen, T(w), k).shape == (k,)
    assert ops.sel_stochastic_universal_sampling(gen, T(w), k).shape == (k,)
    with pytest.raises(ValueError, match="non-negative"):
        ops.sel_roulette(gen, -T(w), k)


@pytest.mark.parametrize("n,k", [(1000, 3000), (10_000, 10_000)])
def test_roulette_and_sus_on_fractional_fitness(n, k):
    w = _fitness(np.random.default_rng(n + 1), n, integer=False)
    roul, u, sus, u0 = _jax_roulette(jax.random.key(n + 1), jnp.asarray(w),
                                     k)
    cs = np.cumsum(w[np.asarray(tsel.lex_sort_desc(T(w)))][:, 0],
                   dtype=np.float64)
    total = cs[-1]
    distance = total / k
    for got, want, points in (
            (tsel._roulette(T(w), T(u)), roul, u * total),
            (tsel._sus(T(w), k, T(u0)), sus,
             u0 * distance + distance * np.arange(k))):
        differ = got.numpy() != want
        near = np.abs(points[differ][:, None] - cs[None, :]).min(1)
        assert np.all(near <= tsel.ROULETTE_RTOL * total)
        assert differ.mean() <= 0.01


@pytest.mark.parametrize("fitness_first", [True, False])
@pytest.mark.parametrize("parsimony", [1.4, 2.0])
def test_sel_double_tournament(fitness_first, parsimony):
    rng = np.random.default_rng(7)
    n, k, fs = 60, 80, 3
    w = rng.integers(0, 10, (n, 1)).astype(np.float32)
    lengths = rng.integers(1, 6, n).astype(np.int32)
    key = jax.random.key(int(parsimony * 10) + fitness_first)
    shape = (k, 2, fs) if fitness_first else (k, fs, 2)

    @jax.jit
    def run(kk):
        ka, ku = jax.random.split(kk)
        return (jsel.sel_double_tournament(
            kk, jnp.asarray(w), jnp.asarray(lengths), k, fs, parsimony,
            fitness_first), jax.random.randint(ka, shape, 0, n),
            jax.random.uniform(ku, shape[:1] if fitness_first
                               else shape[:2]))

    want, asp, u = run(key)
    got = tsel._double_tournament(T(w), T(lengths), T(asp).long(), T(u),
                                  parsimony, fitness_first)
    assert_bitwise(got, np.asarray(want).astype(np.int64))
    out = ops.sel_double_tournament(make_generator(4, "cpu"), T(w),
                                    T(lengths), k, fs, parsimony,
                                    fitness_first)
    assert out.shape == (k,) and int(out.max()) < n


def _lexicase_draws(key, k, ncases):
    def one(kk):
        kp, kc = jax.random.split(kk)
        return (jax.random.permutation(kp, ncases),
                jax.random.uniform(kc, (), dtype=jnp.float32))
    return jax.vmap(one)(jax.random.split(key, k))


@pytest.mark.parametrize("name,extra", [
    ("lexicase", ()), ("epsilon_lexicase", (0.5,)),
    ("automatic_epsilon_lexicase", ())])
@pytest.mark.parametrize("n,ncases,k", [(1, 3, 4), (57, 11, 64)])
def test_lexicase_family(name, extra, n, ncases, k):
    rng = np.random.default_rng(n + ncases)
    values = rng.integers(0, 4, (n, ncases)).astype(np.float32)
    values[:, ::3] += rng.uniform(0, 1, (n, len(range(0, ncases, 3)))
                                  ).astype(np.float32)
    weights = np.where(np.arange(ncases) % 2 == 0, 1.0, -1.0)
    key = jax.random.key(n * 7 + ncases)
    want, (orders, u) = jax.jit(lambda kk: (getattr(jsel, f"sel_{name}")(
        kk, jnp.asarray(values), weights, k, *extra),
        _lexicase_draws(kk, k, ncases)))(key)
    survive = {"lexicase": lambda: tsel._survive_exact,
               "epsilon_lexicase": lambda: tsel._survive_epsilon(*extra),
               "automatic_epsilon_lexicase":
               lambda: tsel._survive_automatic}[name]()
    got = tsel._lexicase(T(values), weights, T(orders).long(), T(u), survive)
    assert_bitwise(got, np.asarray(want).astype(np.int64))
    out = getattr(ops, f"sel_{name}")(make_generator(5, "cpu"), T(values),
                                      weights, k, *extra)
    assert out.shape == (k,) and int(out.max()) < n


# ------------------------------------------------------------ constraint ----

def test_delta_and_closest_valid_penalty():
    from deap_tpu.ops import constraint as jcon
    from deap_tpu_torch.ops import constraint as tcon
    rng = np.random.default_rng(9)
    x = rng.normal(size=(200, 3)).astype(np.float32)

    def j_eval(g):
        return jnp.stack([(g ** 2).sum(-1), g[:, 0]], -1)

    def t_eval(g):
        return torch.stack([(g ** 2).sum(-1), g[:, 0]], -1)

    for spec_w in ((-1.0, 1.0), (1.0, -1.0)):
        jspec, tspec = JSpec(spec_w), FitnessSpec(spec_w)
        jd = jcon.delta_penalty(lambda g: g[:, 1] > 0, [7.0, -3.0],
                                lambda g: jnp.abs(g[:, 1]), spec=jspec)
        td = tcon.delta_penalty(lambda g: g[:, 1] > 0, [7.0, -3.0],
                                lambda g: g[:, 1].abs(), spec=tspec)
        assert_bitwise(td(t_eval)(T(x)), jd(j_eval)(jnp.asarray(x)))
        jd = jcon.DeltaPenality(lambda g: g[:, 1] > 0, 5.0, spec=jspec)
        td = tcon.DeltaPenality(lambda g: g[:, 1] > 0, 5.0, spec=tspec)
        assert_bitwise(td(t_eval)(T(x)), jd(j_eval)(jnp.asarray(x)))
        jc_ = jcon.closest_valid_penalty(
            lambda g: g[:, 2] < 0.5, lambda g: jnp.minimum(g, 0.5), 2.0,
            lambda v, g: jnp.abs(v - g).sum(-1), spec=jspec)
        tc_ = tcon.closest_valid_penalty(
            lambda g: g[:, 2] < 0.5, lambda g: torch.clamp_max(g, 0.5), 2.0,
            lambda v, g: (v - g).abs().sum(-1), spec=tspec)
        assert_bitwise(tc_(t_eval)(T(x)), jc_(j_eval)(jnp.asarray(x)))
    assert ops.ClosestValidPenality is ops.closest_valid_penalty
    assert ops.DeltaPenalty is ops.delta_penalty


# --------------------------------------------------------------- support ----

def test_multistatistics_and_logbook_from_records():
    rng = np.random.default_rng(10)
    fit = rng.integers(0, 100, (64, 1)).astype(np.float32)
    size = rng.integers(1, 20, 64).astype(np.float32)
    jpop = JPopulation(genomes=jnp.asarray(size), fitness=jnp.asarray(fit),
                       valid=jnp.ones(64, bool))
    tpop = init_population(make_generator(0, "cpu"), 64,
                           lambda g, n: T(size), FitnessSpec((1.0,)),
                           device="cpu").with_fitness(T(fit))
    jms = jstats.MultiStatistics(
        fitness=jstats.Statistics(lambda p: p.fitness[:, 0]),
        size=jstats.Statistics(lambda p: p.genomes))
    jms.register("max", jnp.max)
    jms.register("min", jnp.min)
    tms = tstats.MultiStatistics(
        fitness=tstats.Statistics(lambda p: p.fitness[:, 0]),
        size=tstats.Statistics(lambda p: p.genomes))
    tms.register("max", tstats.max0)
    tms.register("min", tstats.min0)
    assert tms.fields == jms.fields == ["fitness", "size"]
    jrec, trec = jms.compile(jpop), tms.compile(tpop)
    for ch in ("fitness", "size"):
        for f in ("max", "min"):
            assert float(trec[ch][f]) == float(jrec[ch][f])
    # stacked per-generation records, chapters included
    stack = {"gen": np.arange(4), "nevals": np.array([64, 30, 31, 29]),
             "fitness": {"max": np.array([1.5, 2.5, 3.0, 4.25], np.float32),
                         "min": np.zeros(4, np.float32)}}
    tstack = {"gen": torch.arange(4), "nevals": T(stack["nevals"]),
              "fitness": {k: T(v) for k, v in stack["fitness"].items()}}
    jl = jlog.logbook_from_records(stack, header=["gen", "nevals",
                                                  "fitness"])
    tl = tlog.logbook_from_records(tstack, header=["gen", "nevals",
                                                   "fitness"])
    assert list(tl) == list(jl)
    assert tl.chapters["fitness"].select("max") == jl.chapters[
        "fitness"].select("max")
    assert str(tl) == str(jl)
    assert len(tlog.logbook_from_records({})) == 0


def test_the_port_holds_every_operator_name():
    def public(m):
        return {n for n in dir(m) if not n.startswith("_")
                and callable(getattr(m, n))}
    # pair_vmap and genome_vmap lift a per-key operator over rows with
    # jax.random.split; the port's operators are batched
    assert public(jops) - public(ops) == {"pair_vmap", "genome_vmap"}
    from deap_tpu import support as jsupport
    from deap_tpu_torch import support as tsupport
    assert {"MultiStatistics", "Statistics", "Logbook"} <= set(
        tsupport.__all__) & set(dir(jsupport))
