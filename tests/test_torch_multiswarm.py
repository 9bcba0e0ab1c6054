"""Multi-swarm and speciation PSO (``deap_tpu_torch.strategies.
multiswarm``) against the JAX package's, on the CPU.

Each step of the port (``step_from_draws``) takes the JAX package's own
draws, rebuilt from the step's key as its ``step`` splits it, and is held
bitwise, state by state, over chains of steps that spawn, kill, exclude
and detect changes. The objectives here add their squares left to right
with a correctly rounded root in both packages and the JAX steps run
eagerly, one rounding an operation. ``jnp.linalg.norm`` is jitted, and
XLA then fuses the squares into the sum for some widths and not for
others: the step chains and ``species_seeds`` give the JAX module a
``jnp`` whose ``linalg.norm`` is the eager ``sqrt(sum(x ** 2))``, the
port's ``ops.linalg.norm_rn`` (a test-time attribute of the module, the
JAX package untouched), and the quantum cloud is held against the
unchanged function within ``NORM_ULPS`` (and ``POW_ULPS`` where its
radius goes through ``** (1/dim)``). The JAX package's quality gates hold
on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import types

import deap_tpu.strategies.multiswarm as jm
from deap_tpu import strategies as jst
from deap_tpu_torch import convert
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.strategies import multiswarm as tms


def _norm_jax(x):
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * x[..., c]
    return jnp.sqrt(acc)


def _norm_torch(x):
    acc = x[..., 0] * x[..., 0]
    for c in range(1, x.shape[-1]):
        acc = acc + x[..., c] * x[..., c]
    return torch.sqrt(acc.double()).float()


def two_peaks_jax(x, shift=0.0):
    """Maxima 10 at -3·1 and 8 at +3·1 (moved by ``shift``)."""
    return jnp.maximum(10.0 - _norm_jax(x - (-3.0 + shift)),
                       8.0 - _norm_jax(x - (3.0 + shift)))


def two_peaks_torch(x, shift=0.0):
    return torch.maximum(10.0 - _norm_torch(x - (-3.0 + shift)),
                         8.0 - _norm_torch(x - (3.0 + shift)))


def _t(a):
    return torch.from_numpy(np.array(a))


class _UnfusedNormJnp:
    """``jax.numpy`` with ``linalg.norm`` as eager ``sqrt(sum(x ** 2))``."""
    linalg = types.SimpleNamespace(
        norm=lambda x, axis=-1, keepdims=False: jnp.sqrt(
            jnp.sum(x ** 2, axis=axis, keepdims=keepdims)))

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def unfused_norm(monkeypatch):
    monkeypatch.setattr(jm, "jnp", _UnfusedNormJnp())


def _fresh_jax(key, shape, pmin, pmax):
    kx, kv = jax.random.split(key)
    half = (pmax - pmin) / 2.0
    return (jax.random.uniform(kx, shape, minval=pmin, maxval=pmax),
            jax.random.uniform(kv, shape, minval=-half, maxval=half))


def _cloud_jax(key, shape, dist):
    k_pos, k_u = jax.random.split(key)
    ushape = shape[:-1] + (1,)
    u = (jax.random.uniform(k_u, ushape) if dist == "uvd"
         else jax.random.normal(k_u, ushape))
    return jax.random.normal(k_pos, shape), u


def multiswarm_draws(key, S, P, D, ms):
    """``MultiSwarmPSO.step``'s draws from ``key``, as its step splits
    it."""
    k_spawn, k_quant, k_move, k_excl = jax.random.split(key, 4)
    fx, fv = _fresh_jax(k_spawn, (P, D), ms.pmin, ms.pmax)
    pos, u = jax.vmap(lambda k: _cloud_jax(k, (P, D), ms.dist))(
        jax.random.split(k_quant, S))
    k1, k2 = jax.random.split(k_move)
    ce1 = ms.c * jax.random.uniform(k1, (S, P, D))
    ce2 = ms.c * jax.random.uniform(k2, (S, P, D))
    rx, rv = jax.vmap(lambda k: _fresh_jax(k, (P, D), ms.pmin, ms.pmax))(
        jax.random.split(k_excl, S))
    return tms.MultiSwarmDraws(*(_t(a) for a in (fx, fv, pos, u, ce1, ce2,
                                                 rx, rv)))


def speciation_draws(key, n, d, sp):
    k_q, k_move, k_over, k_worst = jax.random.split(key, 4)
    pos, u = _cloud_jax(k_q, (n, d), "nuvd")
    k1, k2 = jax.random.split(k_move)
    half = (sp.pmax - sp.pmin) / 2.0
    return tms.SpeciationDraws(*(_t(a) for a in (
        pos, u, sp.c * jax.random.uniform(k1, (n, d)),
        sp.c * jax.random.uniform(k2, (n, d)),
        jax.random.uniform(k_over, (n, d), minval=sp.pmin, maxval=sp.pmax),
        jax.random.uniform(k_worst, (n, d), minval=-half, maxval=half))))


def _same(ts, js, fields):
    for f in fields:
        np.testing.assert_array_equal(ts[f], np.asarray(getattr(js, f)),
                                      err_msg=f)


def _ms_pair(dist, rcloud, nexcess, shift):
    kw = dict(pmin=-6.0, pmax=6.0, rcloud=rcloud, nexcess=nexcess,
              dist=dist)
    return (jst.MultiSwarmPSO(lambda x: two_peaks_jax(x, shift["v"]), **kw),
            tms.MultiSwarmPSO(lambda x: two_peaks_torch(x, shift["v"]),
                              device="cpu", **kw))


def _ms_chain(jms, tms_, js, steps, shift, move_at, seed):
    """Steps of both packages on the JAX package's draws, each state
    bitwise; returns the events seen."""
    S, P, D = js.x.shape
    ts = convert.multiswarm_state_from_arrays(
        **{f: np.asarray(getattr(js, f)) for f in convert.MULTISWARM_FIELDS},
        device="cpu")
    seen = set()
    for g in range(steps):
        if g == move_at:
            shift["v"] = 0.5
        key = jax.random.key(seed + g)
        before = np.asarray(js.active)
        js = jms.step(key, js)
        ts = tms_.step_from_draws(ts, multiswarm_draws(key, S, P, D, jms))
        _same(convert.multiswarm_state_to_arrays(ts), js,
              convert.MULTISWARM_FIELDS)
        after = np.asarray(js.active)
        f = np.asarray(js.sbest_f)
        seen |= {"spawn"} if (after & ~before).any() else set()
        seen |= {"kill"} if (before & ~after).any() else set()
        seen |= {"reset"} if np.isinf(f[after & before]).any() else set()
    bx, bf = tms_.best(ts)
    jx, jf = jms.best(js)
    assert float(bf) == float(jf)
    np.testing.assert_array_equal(bx.numpy(), np.asarray(jx))
    return seen


def test_multiswarm_steps_bitwise(unfused_norm):
    """Chains of steps through every rule: every swarm converged (a
    spawn), two swarms on one peak (exclusion), the landscape moving
    (change detection, quantum clouds); every slot roaming (a kill)."""
    shift = {"v": 0.0}
    jms, tms_ = _ms_pair("nuvd", 0.5, 3, shift)
    js = jms.init(jax.random.key(1), nswarms=3, nparticles=4, dim=2,
                  capacity=6)
    # swarms 0 and 1 collapsed on the best peak, 2 on the other
    js = js.replace(x=js.x.at[0].set(-3.0).at[1].set(-2.99).at[2].set(3.0))
    seen = _ms_chain(jms, tms_, js, 4, shift, 2, 200)
    assert {"spawn", "reset"} <= seen, seen
    shift["v"] = 0.0
    js = jms.init(jax.random.key(2), nswarms=6, nparticles=4, dim=2,
                  capacity=6)
    assert "kill" in _ms_chain(jms, tms_, js, 1, shift, -1, 400)


@pytest.mark.parametrize("dist", ["nuvd", "gaussian", "uvd"])
def test_quantum_cloud_against_the_reference(dist, monkeypatch):
    """Clouds on the JAX package's draws: within ``NORM_ULPS`` (+
    ``POW_ULPS`` through ``** (1/dim)``) of the JAX function; with the
    eager norm, bitwise (``'nuvd'``) or within ``POW_ULPS``."""
    key = jax.random.key(5)
    centre = jnp.asarray([1.0, -2.0, 0.5])
    pos, u = _cloud_jax(key, (64, 3), dist)
    got = tms._quantum_cloud(_t(pos), _t(u), _t(centre), 0.7, dist).numpy()
    pow_ulps = 0 if dist == "nuvd" else tms.POW_ULPS

    def within(want, ulps):
        rel = np.abs(want - centre) + 1e-30   # the cloud's own offsets
        assert np.all(np.abs(got - want) <= ulps * np.spacing(
            rel.astype(np.float32)) + np.spacing(np.abs(want))), dist

    within(np.asarray(jm._quantum_cloud(key, 64, 3, centre, 0.7, dist)),
           tms.NORM_ULPS + pow_ulps)
    monkeypatch.setattr(jm, "jnp", _UnfusedNormJnp())
    want = np.asarray(jm._quantum_cloud(key, 64, 3, centre, 0.7, dist))
    if dist == "nuvd":
        np.testing.assert_array_equal(got, want)
    else:
        within(want, pow_ulps)
    with pytest.raises(ValueError):
        tms._quantum_cloud(_t(pos), _t(u), _t(centre), 0.7, "cauchy")


def test_exclusion_sweep_is_the_pair_scan():
    """The host sweep against the JAX package's scan of all S² pairs, on
    random symmetric closeness and ties."""
    rng = np.random.default_rng(0)
    for S in (1, 2, 5, 12, 40):
        for _ in range(20):
            c = rng.random((S, S)) < rng.random()
            c = np.triu(c, 1)
            close = c | c.T
            f = rng.integers(0, 4, S).astype(np.float32)
            marked = np.zeros(S, bool)
            for t in range(S * S):
                s1, s2 = divmod(t, S)
                if s2 > s1 and close[s1, s2] and not (marked[s1]
                                                      or marked[s2]):
                    marked[s1 if f[s1] <= f[s2] else s2] = True
            np.testing.assert_array_equal(tms._exclusion_sweep(close, f),
                                          marked)


def test_multiswarm_static_gate():
    """The JAX package's gate: two peaks, 3 swarms of 8 in capacity 8,
    40 steps, best > 9."""
    ms = tms.MultiSwarmPSO(two_peaks_torch, pmin=-6.0, pmax=6.0, rcloud=0.5,
                           device="cpu")
    gen = make_generator(0, "cpu")
    s = ms.init(gen, nswarms=3, nparticles=8, dim=2, capacity=8)
    for _ in range(40):
        s = ms.step(gen, s)
    assert float(ms.best(s)[1]) > 9.0 and int(s.nevals) > 0


@pytest.mark.parametrize("seed,n,d,rs", [(0, 24, 2, 1.5), (1, 24, 2, 4.0)])
def test_species_seeds_bitwise(seed, n, d, rs, unfused_norm):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-6, 6, (n, d)).astype(np.float32)
    f = rng.integers(0, 5, n).astype(np.float32)   # ties: a stable order
    f[: n // 4] = -np.inf
    want = jst.species_seeds(jnp.asarray(x), jnp.asarray(f), rs)
    got = tms.species_seeds(_t(x), _t(f), rs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_species_seeds_two_clusters():
    rng = np.random.default_rng(6)
    a = rng.standard_normal((10, 2)).astype(np.float32) * 0.1 + 3.0
    b = rng.standard_normal((10, 2)).astype(np.float32) * 0.1 - 3.0
    x = torch.from_numpy(np.concatenate([a, b]))
    is_seed, species = tms.species_seeds(x, torch.arange(20.0), rs=1.0)
    assert int(is_seed.sum()) == 2
    sp = species.numpy()
    assert len(set(sp[:10])) == 1 and len(set(sp[10:])) == 1
    assert sp[0] != sp[10]
    for i in np.flatnonzero(is_seed.numpy()):
        assert sp[i] == i
    one = tms.species_seeds(torch.ones(1, 3), torch.zeros(1), rs=1.0)
    assert one[0].tolist() == [True] and one[1].tolist() == [0]


def test_speciation_steps_bitwise(unfused_norm):
    shift = {"v": 0.0}
    kw = dict(pmin=-6.0, pmax=6.0, rs=2.0, pmax_size=5, rcloud=1.0)
    jsp = jst.SpeciationPSO(lambda x: two_peaks_jax(x, shift["v"]), **kw)
    tsp = tms.SpeciationPSO(lambda x: two_peaks_torch(x, shift["v"]),
                            device="cpu", **kw)
    js = jsp.init(jax.random.key(8), n=24, dim=2)
    ts = convert.speciation_state_from_arrays(
        **{f: np.asarray(getattr(js, f)) for f in convert.SPECIATION_FIELDS},
        device="cpu")
    for g in range(4):
        if g == 2:
            shift["v"] = 0.3  # a change: every species becomes a cloud
        key = jax.random.key(300 + g)
        dr = speciation_draws(key, 24, 2, jsp)
        js = jsp.step(key, js)
        ts = tsp.step_from_draws(ts, dr)
        _same(convert.speciation_state_to_arrays(ts), js,
              convert.SPECIATION_FIELDS)
    bx, bf = tsp.best(ts)
    assert float(bf) == float(jsp.best(js)[1])


def test_speciation_gate():
    """The JAX package's gate: n 60, rs 3, 30 steps: best > 9 and a
    particle within 1.5 of the second peak."""
    sp = tms.SpeciationPSO(two_peaks_torch, pmin=-6.0, pmax=6.0, rs=3.0,
                           pmax_size=10, device="cpu")
    gen = make_generator(8, "cpu")
    s = sp.init(gen, n=60, dim=2)
    for _ in range(30):
        s = sp.step(gen, s)
    assert float(s.pbest_f.max()) > 9.0
    assert float(_norm_torch(s.pbest_x - 3.0).min()) < 1.5
    # the draws' shapes and ranges
    dr = sp.draws(gen, s)
    assert dr.cloud_u.shape == (60, 1)
    assert float(dr.fresh_x.min()) >= -6.0 and float(dr.fresh_x.max()) <= 6.0
    assert float(dr.fresh_v.abs().max()) <= 6.0
