"""The rest of the port's benchmark set against the JAX package's, on the
CPU: every single- and multi-objective function, the symbolic-regression
targets, the bit-genome functions, the transforms, ``igd``, the
analytic fronts and ``core.wvalues``.

Inputs are made from a seed with numpy. The JAX functions take one
genome and run as ``jax.jit(jax.vmap(fn))``; the port's take the batch.
Tolerances: ``benchmarks.BENCH_RTOL`` and ``benchmarks.gp.GP_TARGET_RTOL``
(``|port - jax| <= rtol · max(1, |jax|)``; torch's ``exp``, ``cos``,
``sin``, ``sqrt``, ``pow`` are not XLA's, and XLA contracts ``a*b + c``);
the bit-genome functions and the metrics of exact sums are bitwise.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import benchmarks as jbm
from deap_tpu import core as jcore
from deap_tpu import native as jnative
from deap_tpu.benchmarks import binary as jbin
from deap_tpu.benchmarks import gp as jgp
from deap_tpu.benchmarks import tools as jtools
from deap_tpu.core import fitness as jfit
from deap_tpu_torch import benchmarks as tbm
from deap_tpu_torch import core as tcore
from deap_tpu_torch import native as tnative
from deap_tpu_torch.benchmarks import binary as tbin
from deap_tpu_torch.benchmarks import gp as tgp
from deap_tpu_torch.benchmarks import tools as ttools
from deap_tpu_torch.core import fitness as tfit
from deap_tpu_torch.device import make_generator

N = 256


def _uniform(seed, lo, hi, d):
    return np.random.default_rng(seed).uniform(lo, hi, (N, d)).astype(
        np.float32)


_A = np.random.default_rng(90).uniform(0, 10, (5, 4)).astype(np.float32)
_C = np.random.default_rng(91).uniform(0.1, 1, 5).astype(np.float32)

# name, extra arguments, (low, high, dim) of the genes
CASES = [
    ("plane", (), (-5, 5, 5)), ("cigar", (), (-5, 5, 5)),
    ("rosenbrock", (), (-2, 2, 5)), ("ackley", (), (-15, 30, 10)),
    ("bohachevsky", (), (-100, 100, 6)),
    ("rastrigin_scaled", (), (-5, 5, 8)), ("rastrigin_skew", (), (-5, 5, 8)),
    ("schaffer", (), (-100, 100, 6)), ("schwefel", (), (-500, 500, 6)),
    ("himmelblau", (), (-6, 6, 2)), ("shekel", (_A, _C), (0, 10, 4)),
    ("schaffer_mo", (), (-10, 10, 1)), ("zdt2", (), (0, 1, 30)),
    ("zdt3", (), (0, 1, 30)), ("zdt4", (), (0, 1, 10)),
    ("zdt6", (), (0, 1, 10)), ("dtlz1", (3,), (0, 1, 12)),
    ("dtlz3", (3,), (0, 1, 12)), ("dtlz4", (3, 100.0), (0, 1, 12)),
    ("dtlz5", (3,), (0, 1, 12)), ("dtlz6", (3,), (0, 1, 12)),
    ("dtlz7", (3,), (0, 1, 22)), ("fonseca", (), (-4, 4, 3)),
    ("poloni", (), (-np.pi, np.pi, 2)), ("dent", (), (-1.5, 1.5, 2)),
]


def _within(got, want, rtol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if rtol == 0.0:
        assert got.tobytes() == want.astype(got.dtype).tobytes()
        return
    err = np.abs(got.astype(np.float64) - want) / np.maximum(1.0,
                                                             np.abs(want))
    assert err.max() <= rtol, err.max()


@pytest.mark.parametrize("name,extra,box", CASES, ids=[c[0] for c in CASES])
def test_benchmark_matches_jax(name, extra, box):
    x = _uniform(len(name), *box)
    if name == "zdt4":  # x0 in [0, 1], the rest in [-5, 5]
        x[:, 1:] = x[:, 1:] * 10.0 - 5.0
    fn = getattr(jbm, name)
    want = jax.jit(jax.vmap(lambda xi: fn(xi, *extra)))(jnp.asarray(x))
    got = getattr(tbm, name)(torch.from_numpy(x), *extra)
    _within(got, want, tbm.BENCH_RTOL[name])


@pytest.mark.parametrize("name", tgp.__all__)
def test_gp_target_matches_jax(name):
    x = _uniform(7, -2, 8, 3)
    want = jax.jit(jax.vmap(getattr(jgp, name)))(jnp.asarray(x))
    _within(getattr(tgp, name)(torch.from_numpy(x)), want,
            tgp.GP_TARGET_RTOL)


BINARY = [("trap", (), 10), ("inv_trap", (), 10), ("chuang_f1", (), 41),
          ("chuang_f2", (), 42), ("chuang_f3", (), 41),
          ("royal_road1", (4,), 64), ("royal_road2", (4,), 64),
          ("royal_road1", (8,), 70)]


@pytest.mark.parametrize("name,extra,L", BINARY,
                         ids=[f"{b[0]}{b[1]}" for b in BINARY])
def test_binary_function_matches_jax_bitwise(name, extra, L):
    rng = np.random.default_rng(L)
    x = rng.random((N, L)) < 0.5
    x[:8] = True          # all ones: the traps' and roads' full scores
    x[8:16] = False
    fn = getattr(jbin, name)
    want = jax.jit(jax.vmap(lambda xi: fn(xi, *extra)))(jnp.asarray(x))
    _within(getattr(tbin, name)(torch.from_numpy(x), *extra), want, 0.0)


def test_bin2float_decodes_as_jax():
    x = np.random.default_rng(3).random((N, 40)) < 0.5
    jdec = jbin.bin2float(-5.0, 5.0, 10)(lambda v: v)
    tdec = tbin.bin2float(-5.0, 5.0, 10)(lambda v: v)
    _within(tdec(torch.from_numpy(x)), jax.vmap(jdec)(jnp.asarray(x)), 0.0)
    want = jax.vmap(jbin.bin2float(-5.0, 5.0, 10)(jbm.sphere))(
        jnp.asarray(x))
    got = tbin.bin2float(-5.0, 5.0, 10)(tbm.sphere)(torch.from_numpy(x))
    _within(got, want, 1e-6)


def test_rand_draws_from_the_generator():
    x = torch.zeros(50, 3)
    a = tbm.rand(make_generator(4, "cpu"), x)
    assert a.shape == (50, 1) and bool(((a >= 0) & (a < 1)).all())
    assert torch.equal(a, torch.rand((50, 1),
                                     generator=make_generator(4, "cpu")))


def _rotation(d, seed):
    q, _ = np.linalg.qr(np.random.default_rng(seed).normal(size=(d, d)))
    return q.astype(np.float32)


TRANSFORMS = ["translate", "rotate", "scale", "noise_none", "bound_clip",
              "bound_wrap", "bound_mirror"]


@pytest.mark.parametrize("kind", TRANSFORMS)
def test_transform_matches_jax(kind):
    d = 6
    x = _uniform(11, -3, 3, d)
    if kind == "translate":
        v = np.linspace(-1, 1, d).astype(np.float32)
        j, t = jtools.translate(v), ttools.translate(v)
    elif kind == "rotate":
        j, t = jtools.rotate(_rotation(d, 5)), ttools.rotate(_rotation(d, 5))
    elif kind == "scale":
        f = np.linspace(0.5, 2.0, d).astype(np.float32)
        j, t = jtools.scale(f), ttools.scale(f)
    elif kind == "noise_none":
        j, t = jtools.noise(None), ttools.noise(None)
    else:
        j = jtools.bound(([-1.0] * d, [2.0] * d), kind[6:])
        t = ttools.bound(([-1.0] * d, [2.0] * d), kind[6:])
    if kind.startswith("bound"):
        want = jax.vmap(j(lambda v: v * 1.5))(jnp.asarray(x))
        got = t(lambda v: v * 1.5)(torch.from_numpy(x))
        _within(got, want, 1e-6)
        return
    if kind == "noise_none":
        want = jax.vmap(j(jbm.rastrigin))(jnp.asarray(x),
                                          jax.random.split(
                                              jax.random.key(0), N))
        got = t(tbm.rastrigin)(torch.from_numpy(x), make_generator(0, "cpu"))
    else:
        want = jax.vmap(j(jbm.sphere))(jnp.asarray(x))
        got = t(tbm.sphere)(torch.from_numpy(x))
    # rotate: torch's inverse and product are not XLA's
    _within(got, want, 1e-5 if kind == "rotate" else 1e-6)


def test_transform_updates_and_noise_draws():
    v = np.ones(3, np.float32)
    f = ttools.translate(v)(tbm.sphere)
    x = torch.zeros(4, 3)
    assert torch.equal(f(x), torch.full((4, 1), 3.0))
    f.translate(np.zeros(3, np.float32))
    assert torch.equal(f(x), torch.zeros(4, 1))
    noisy = ttools.noise([0.5])(tbm.sphere)
    got = noisy(x, make_generator(9, "cpu"))
    want = 0.5 * torch.randn((4, 1), generator=make_generator(9, "cpu"))
    assert torch.equal(got, want)
    noisy.noise(None)
    assert torch.equal(noisy(x, make_generator(9, "cpu")), torch.zeros(4, 1))


def test_igd_matches_jax():
    a = _uniform(20, 0, 1, 2)[:40]
    z = np.asarray(jtools.optimal_front("zdt1", 50))
    assert abs(ttools.igd(a, z) - jtools.igd(a, z)) <= 1e-6 * jtools.igd(a, z)


FRONTS = [("zdt1", 2), ("zdt2", 2), ("zdt3", 2), ("zdt4", 2), ("zdt6", 2),
          ("dtlz1", 3), ("dtlz2", 3), ("dtlz3", 4), ("dtlz4", 3)]


@pytest.mark.parametrize("name,nobj", FRONTS, ids=[f[0] for f in FRONTS])
def test_optimal_front_matches_jax(name, nobj):
    want = jtools.optimal_front(name, 60, nobj)
    _within(ttools.optimal_front(name, 60, nobj), want, 1e-6)


def test_wvalues_matches_jax():
    rng = np.random.default_rng(12)
    v = rng.normal(size=(30, 3)).astype(np.float32)
    wt = np.asarray([-1.0, 1.0, 0.5], np.float32)
    _within(tfit.wvalues(torch.from_numpy(v), torch.from_numpy(wt)),
            jfit.wvalues(jnp.asarray(v), jnp.asarray(wt)), 0.0)
    assert tcore.wvalues is tfit.wvalues


def _public(module):
    return {n for n, v in vars(module).items() if not n.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and v.__module__.startswith("deap_tpu")}


@pytest.mark.parametrize("pair", [(jbm, tbm), (jbin, tbin), (jgp, tgp),
                                  (jtools, ttools)],
                         ids=["benchmarks", "binary", "gp", "tools"])
def test_the_port_holds_every_benchmark_name(pair):
    jmod, tmod = pair
    assert _public(jmod) <= set(dir(tmod)), _public(jmod) - set(dir(tmod))
    assert set(tmod.__all__) <= set(dir(tmod))


def test_native_and_core_exports_match_jax():
    assert tnative.__all__ == jnative.__all__
    assert set(jcore.__all__) <= set(tcore.__all__)
