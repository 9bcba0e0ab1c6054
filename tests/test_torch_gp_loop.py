"""The host-dispatch GP loop held against the JAX package's.

- **One generation, bit for bit.** The JAX package's ``make_symbreg_loop``
  runs ``init_state`` and one ``advance``; the port starts from the same
  population with the JAX fitness handed to it (so selection compares the
  same numbers: torch and XLA sum the MSE's 32 points in another order,
  and ``cos``/``sin`` round differently), and advances once with the JAX
  package's own draws injected — the aspirants, the flags, the cut points
  per pair id, the mutation points and donor trees per row id, each split
  from the generation's key as the JAX loop splits it. Genomes and carried
  depth arrays must then be equal bit for bit; the fitness of the rows the
  generation evaluated within ``FIT_RTOL`` (relative), the others bitwise.
  A variant plants trees that evaluate to NaN: the best pick (the first
  NaN), the tournaments and the best-ever update follow the JAX package.
- **Whole runs, in distribution.** ``SEEDS`` runs of each package, each
  drawing for itself, agree in their mean best MSE within 3 standard
  errors.
- The port alone: the carried depths equal ``prefix_depths`` recomputed
  and the height limit holds after many generations; host and device
  compaction give the same run.
"""

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu.gp import loop as jloop
from deap_tpu.gp import tree as jtree
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import gp_genomes_from_arrays, gp_genomes_to_arrays
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.gp import loop as tloop

POP, ML, P, NGEN, SEEDS = 128, 48, 32, 8, 10
CXPB, MUTPB, TOURNSIZE = 0.5, 0.1, 3
#: relative tolerance of an evaluated row's fitness (summation order, and
#: cos/sin rounding, differ between torch and XLA)
FIT_RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _trace_state_shim():
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's ``PrimitiveSet.arity_table`` calls it; alias it in this
    test process only."""
    with pytest.MonkeyPatch.context() as mp:
        if not hasattr(jax.core, "trace_state_clean"):
            mp.setattr(jax.core, "trace_state_clean",
                       jax._src.core.trace_state_clean, raising=False)
        yield


def _data():
    X = np.linspace(-1.0, 1.0, P, dtype=np.float32)[:, None]
    x = X[:, 0]
    return X, x ** 4 + x ** 3 + x ** 2 + x


@pytest.fixture(scope="module")
def jax_run(_trace_state_shim):
    """One JAX loop for the module: its jitted pieces compile once."""
    jps = jgp.math_set(1)
    X, y = _data()
    run = jloop.make_symbreg_loop(jps, ML, jnp.asarray(X), jnp.asarray(y),
                                  cxpb=CXPB, mutpb=MUTPB)
    return jps, run


def _jax_pop(jps, seed, n=POP):
    gen = jtree.gen_half_and_half(jps, ML, 1, 2)
    keys = jax.random.split(jax.random.key(seed), n)
    return {k: np.array(v) for k, v in jax.vmap(gen)(keys).items()}


class JaxDraws:
    """The draws of generation ``gen`` of the JAX loop keyed by ``key``, in
    the port's :class:`gp.loop.GpDraws` shape."""

    def __init__(self, jps, key, gen):
        k_sel, k_var = jax.random.split(jax.random.fold_in(key, gen))
        self.k_sel = k_sel
        self.k_draw, self.k_cx, self.k_mut = jax.random.split(k_var, 3)
        self.expr = jtree.make_generator(jps, min(ML, 32), 0, 2, "full")

    @staticmethod
    def _t(a):
        return torch.from_numpy(np.array(a))

    def aspirants(self, n):
        return self._t(jax.random.randint(self.k_sel, (n, TOURNSIZE), 0,
                                          n)).long()

    def flags(self, n):
        k_pair, k_ind = jax.random.split(self.k_draw)
        return (self._t(jax.random.bernoulli(k_pair, CXPB, (n // 2,))),
                self._t(jax.random.bernoulli(k_ind, MUTPB, (n,))))

    def cut_points(self, len_even, len_odd):
        def one(p, l1, l2):
            k1, k2 = jax.random.split(jax.random.fold_in(self.k_cx, p))
            i1 = jnp.where(l1 >= 2, jax.random.randint(
                k1, (), 1, jnp.maximum(l1, 2)), 0)
            i2 = jnp.where(l2 >= 2, jax.random.randint(
                k2, (), 1, jnp.maximum(l2, 2)), 0)
            return i1, i2

        ids = jnp.arange(len_even.shape[0], dtype=jnp.int32)
        i1, i2 = jax.vmap(one)(ids, jnp.asarray(len_even.numpy()),
                               jnp.asarray(len_odd.numpy()))
        return self._t(i1), self._t(i2)

    def _row_keys(self, n):
        return jax.vmap(lambda r: jax.random.split(
            jax.random.fold_in(self.k_mut, r)))(jnp.arange(n, dtype=jnp.int32))

    def mut_points(self, length):
        keys = self._row_keys(length.shape[0])
        return self._t(jax.vmap(lambda k, l: jax.random.randint(
            k, (), 0, jnp.maximum(l, 1)))(keys[:, 0],
                                           jnp.asarray(length.numpy())))

    def donors(self, n):
        donor = jax.vmap(self.expr)(self._row_keys(n)[:, 1])
        return gp_genomes_from_arrays({k: np.array(v) for k, v in
                                       donor.items()}, "cpu")


def _bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.astype(want.dtype).tobytes() == want.tobytes()


def _nan_tree(tps):
    """A tree whose value is NaN at every point: inf - inf."""
    big = "mul(1e30, 1e30)"
    return tgp.from_string(f"sub({big}, {big})", tps, ML, device="cpu")


@pytest.mark.parametrize("plant_nan", [False, True])
def test_one_generation_with_injected_draws_is_bitwise(jax_run, plant_nan):
    jps, jrun = jax_run
    tps = tgp.math_set(1)
    pop = _jax_pop(jps, 3)
    if plant_nan:
        nan = gp_genomes_to_arrays(_nan_tree(tps))
        for r in (5, 77):
            for k in pop:
                pop[k][r] = nan[k][0]
    key = jax.random.key(11)
    js = jrun.init_state(key, {k: jnp.asarray(v) for k, v in pop.items()}, 1)
    fit0 = np.array(js["fit"])
    assert np.isnan(fit0[[5, 77]]).all() == plant_nan
    best0 = js["best_fitness"]
    jrun.advance(key, js)

    X, y = _data()
    trun = tgp.make_symbreg_loop(tps, ML, X, y, cxpb=CXPB, mutpb=MUTPB,
                                 device="cpu")
    ts = trun.init_state(gp_genomes_from_arrays(pop, "cpu"), 1)
    np.testing.assert_allclose(ts["fit"].numpy(), fit0, rtol=FIT_RTOL)
    if plant_nan:
        # argmax picks the first NaN, in both packages
        assert np.isnan(ts["best_fitness"]) and np.isnan(best0)
    # hand the port the JAX fitness, so selection compares the same values
    ts["fit"] = torch.from_numpy(fit0)
    ts["best_fitness"] = best0
    trun.advance(None, ts, draws=JaxDraws(jps, key, 1))

    got = gp_genomes_to_arrays(ts["genomes"])
    for k in ("nodes", "consts", "length"):
        _bitwise(got[k], js["genomes"][k])
    _bitwise(ts["depths"], js["depths"])
    assert ts["nevals"] == js["nevals"]
    fit, want = ts["fit"].numpy(), np.array(js["fit"])
    same = fit == want
    assert np.isnan(fit).tolist() == np.isnan(want).tolist()
    np.testing.assert_allclose(fit, want, rtol=FIT_RTOL)
    # untouched rows carry the handed values bit for bit
    assert same.sum() + np.isnan(want).sum() >= POP - js["nevals"][-1]
    if plant_nan:
        assert np.isnan(ts["best_fitness"]) and np.isnan(js["best_fitness"])
    else:
        np.testing.assert_allclose(ts["best_fitness"], js["best_fitness"],
                                   rtol=FIT_RTOL)
        best = gp_genomes_to_arrays(ts["best_genome"])
        for k in ("nodes", "consts", "length"):
            _bitwise(best[k], js["best_genome"][k])


def test_whole_runs_agree_in_distribution(jax_run):
    """Best MSE after NGEN generations over SEEDS seeds: the two packages'
    means within 3 standard errors."""
    jps, jrun = jax_run
    tps = tgp.math_set(1)
    X, y = _data()
    trun = tgp.make_symbreg_loop(tps, ML, X, y, cxpb=CXPB, mutpb=MUTPB,
                                 device="cpu")
    jbest, tbest = [], []
    for s in range(SEEDS):
        r = jrun(jax.random.key(1000 + s), {
            k: jnp.asarray(v) for k, v in _jax_pop(jps, 2000 + s).items()},
            NGEN)
        jbest.append(-r["best_fitness"])
        g = make_generator(s, "cpu")
        pop = tgp.gen_half_and_half(tps, ML, 1, 2)(g, POP)
        tbest.append(-trun(g, pop, NGEN)["best_fitness"])
    jb, tb = np.asarray(jbest), np.asarray(tbest)
    se = np.sqrt(jb.var(ddof=1) / SEEDS + tb.var(ddof=1) / SEEDS)
    assert abs(jb.mean() - tb.mean()) <= 3 * se, (jb, tb)
    assert np.isfinite(tb).all() and tb.mean() < 0.6


def test_carried_depths_exact_and_height_limited():
    tps = tgp.math_set(1)
    X, y = _data()
    run = tgp.make_symbreg_loop(tps, ML, X, y, height_limit=6, device="cpu")
    g = make_generator(3, "cpu")
    r = run(g, tgp.gen_half_and_half(tps, ML, 1, 2)(g, 256), 12)
    genomes = r["genomes"]
    live = torch.arange(ML) < genomes["length"][:, None]
    dep = tgp.prefix_depths(genomes["nodes"], genomes["length"],
                            tps.arity_table())
    assert torch.equal(torch.where(live, r["depths"], 0),
                       torch.where(live, dep, 0))
    assert int(torch.where(live, dep, 0).amax()) <= 6
    need = 1 + torch.where(live, tps.arity_table()[genomes["nodes"].long()]
                           - 1, 0).sum(1)
    assert bool((need == 0).all()) and int(genomes["length"].min()) >= 1
    assert all(ne <= 256 for ne in r["nevals"])
    assert np.mean(r["nevals"][1:]) < 256
    # the fitness is the negative MSE of the final trees
    preds = tgp.make_batch_interpreter(tps, ML, mode="scan")(
        genomes, torch.from_numpy(X))
    want = -((preds - torch.from_numpy(y)) ** 2).mean(1)
    assert torch.equal(r["fitness"], want)


def test_host_and_device_compaction_give_the_same_run():
    tps = tgp.math_set(1)
    X, y = _data()
    out = []
    for compaction in ("host", "device"):
        run = tgp.make_symbreg_loop(tps, ML, X, y, compaction=compaction,
                                    device="cpu")
        assert run.compaction == compaction
        g = make_generator(8, "cpu")
        out.append(run(g, tgp.gen_half_and_half(tps, ML, 1, 2)(g, 100), 4))
    for k in ("nodes", "consts", "length"):
        assert torch.equal(out[0]["genomes"][k], out[1]["genomes"][k])
    assert torch.equal(out[0]["fitness"], out[1]["fitness"])
    assert out[0]["nevals"] == out[1]["nevals"]
    host_fn, device_fn = tloop.make_compaction_pipelines(CXPB, MUTPB)
    for n in (1, 2, 37, 256):
        a = host_fn(make_generator(n, "cpu"), n)
        b = device_fn(make_generator(n, "cpu"), n)
        assert a[1] == b[1]
        for x, z in zip(a[0], b[0]):
            assert torch.equal(x, z)


def test_flag_compaction_equals_the_jax_compactor(jax_run):
    """Given the JAX package's flags, the port's compaction equals the
    JAX ``make_flag_compactor`` output."""
    for n in (1, 7, 128):
        key = jax.random.key(n)
        k_pair, k_ind = jax.random.split(key)
        do_cx = np.array(jax.random.bernoulli(k_pair, CXPB, (n // 2,)))
        do_mut = np.array(jax.random.bernoulli(k_ind, MUTPB, (n,)))
        want = jloop.make_flag_compactor(CXPB, MUTPB)(key, n)
        got = tloop.compact_flags(torch.from_numpy(do_cx),
                                  torch.from_numpy(do_mut), n)
        for a, b in zip(got, want):
            _bitwise(a, b)
    assert tloop.resolve_compaction("auto", torch.device("cpu")) == "host"
    assert tloop.resolve_compaction("auto", torch.device("cuda")) == "device"


def test_not_ported_options_raise():
    """``plan=`` (A12) raises; ``telemetry=`` is ported (A11), and
    ``probes=`` without it is the JAX loop's ValueError."""
    tps = tgp.math_set(1)
    X, y = _data()
    with pytest.raises(NotImplementedError, match="plan"):
        tgp.make_symbreg_loop(tps, ML, X, y, device="cpu", plan=object())
    with pytest.raises(ValueError, match="requires telemetry"):
        tgp.make_symbreg_loop(tps, ML, X, y, device="cpu",
                              probes=(object(),))
    with pytest.raises(ValueError, match="lives on"):
        run = tgp.make_symbreg_loop(tps, ML, X, y, device="cpu")
        run.init_state({"nodes": torch.zeros((2, ML), dtype=torch.int32,
                                             device="meta"),
                        "consts": torch.zeros((2, ML)),
                        "length": torch.ones(2, dtype=torch.int32)}, 1)
