"""The cart-pole benchmark of the port against the JAX package's on the CPU.

- The constants are the float32 roundings of the JAX module's doubles;
  :data:`TANH_ONE` is the bisected float32 edge where ``jnp.tanh`` returns
  exactly 1; :func:`tanh_sat` gives ±1 exactly where ``jnp.tanh`` does and
  is within ``TANH_ULPS`` ulp of it elsewhere.
- ``fma_rn`` rounds ``a·b + c`` once, double-rounding ties included.
- ``cartpole_step`` against ``jax.vmap(cartpole_step)`` jitted (as the JAX
  rollout compiles it): ``x``, ``θ`` and ``failed`` equal, ``ẋ`` and ``θ̇``
  within ``STEP_ULPS`` ulp of their largest term, NaN rows NaN, on random
  states, states at the limits and NaN.
- ``mlp_policy``'s hidden layer equals XLA's dot bit for bit; its logits
  are within ``LOGIT_ULPS · (1 + Σ_j |W2_ja|)`` ulp of 1 of the JAX
  policy's and saturate where it does.
- Whole rollouts (P 256, E 3, the JAX package's starts, ``max_steps`` 200
  and 500, genomes N(0, σ²) from numpy at σ 0.5 and 3): the tolerance
  class. Until two rollouts part they agree step for step (returns equal
  where they never part). Where they first part, either one has failed
  and the other not, with the limit between the two states the drift
  separates, or their actions differ, where the JAX logits are within a
  stated distance of a tie: the change the state's drift can make to them
  (``2 L · drift``, ``L`` the policy's Lipschitz bound ``max_a Σ_j |W2_ja|
  Σ_k |W1_kj|`` over the ∞-norm, ``drift`` the largest difference of the
  two states at that step) plus the rounding bound of the logits. XLA's
  sin, cos and tanh are not torch's and its loop contracts other products,
  so two rollouts drift apart by ulps a step and, in the long episodes,
  chaotically: at σ 0.5 the rollouts part only after step 100, at σ 3
  at near ties.
- The port's ``rollout_population`` (the torch path, several ``chunk``
  and ``min_size``) equals its ``rollout`` and J5's plain version, and
  raises the JAX package's ``ValueError``.
- One generation of ``bench_suite.py``'s ``cartpole_neuro_pop10k`` at pop
  128 on the JAX package's draws (aspirants, ``var_and``'s gates, blend
  uniforms, Gaussian masks and noise; the JAX step run eagerly, one
  rounding an operation): the same offspring bit for bit and
  the same fitness on every row whose episodes end alike (the rest in the
  rollout class above); K1 is not on the path (blend has no fused form).
- The one-device mesh.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deap_tpu.benchmarks import cartpole as jc
from deap_tpu_torch import FitnessSpec, algorithms, ops, parallel
from deap_tpu_torch.benchmarks import cartpole as tc
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import crossover as tcx
from deap_tpu_torch.ops import mutation as tmut
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.ops.linalg import fma_rn
from deap_tpu_torch.support.stats import mean0

SIZES = (4, 16, 2)
JPOLICY, NPARAM = jc.mlp_policy(SIZES)
TPOLICY, _ = tc.mlp_policy(SIZES)
ULP1 = 2.0 ** -23


def T(a):
    return torch.from_numpy(np.array(a))


def _ordered(x):
    i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _ulps(a, b):
    return np.abs(_ordered(a) - _ordered(b))


def _starts(seed=123, episodes=3):
    keys = jax.random.split(jax.random.key(seed), episodes)
    return np.asarray(jax.vmap(jc.initial_state)(keys)), keys


# ------------------------------------------------------------ constants ----

def test_constants_are_the_float32_roundings_of_the_jax_module():
    want = [np.float32(v) for v in (
        jc.FORCE_MAG, jc.POLEMASS_LENGTH, jc.TOTAL_MASS, jc.GRAVITY,
        jc.HALF_LENGTH, 4.0 / 3.0, jc.MASS_POLE, jc.DT, jc.X_LIMIT,
        float(jc.THETA_LIMIT))]
    assert [np.float32(v) for v in tc.J5_CONSTANTS[:-1]] == want
    assert np.float32(tc.J5_CONSTANTS[-1]) == np.float32(tc.TANH_ONE)
    assert (tc.GRAVITY, tc.TOTAL_MASS, tc.POLEMASS_LENGTH, tc.DT) == (
        jc.GRAVITY, jc.TOTAL_MASS, jc.POLEMASS_LENGTH, jc.DT)
    assert tc.THETA_LIMIT == float(jc.THETA_LIMIT)


@pytest.mark.parametrize("compiled", [True, False])
def test_tanh_one_is_the_bisected_edge_of_xla_tanh(compiled):
    f = jax.jit(jnp.tanh) if compiled else jnp.tanh
    def as_float(i):
        return np.array(i, np.int32).view(np.float32)[()]

    lo = int(np.float32(1.0).view(np.int32))     # tanh(1) < 1
    hi = int(np.float32(20.0).view(np.int32))    # tanh(20) == 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if float(f(as_float(mid))) == 1.0:
            hi = mid
        else:
            lo = mid
    edge = as_float(hi)
    assert edge == np.float32(tc.TANH_ONE)
    assert float(f(-edge)) == -1.0
    assert float(f(np.nextafter(edge, np.float32(0)))) < 1.0
    assert float(torch.tanh(torch.tensor(edge))) < 1.0  # torch's is later


TANH_WIDEST = np.float32(5.9685426)


def test_tanh_sat_saturates_where_xla_does_and_is_within_ulps():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        (rng.normal(size=400_000) * 3).astype(np.float32),
        np.linspace(-12, 12, 400_001, dtype=np.float32),
        np.float32(tc.TANH_ONE) + np.arange(-64, 65, dtype=np.float32)
        * np.spacing(np.float32(tc.TANH_ONE)),
        np.array([0.0, -0.0, 1e-30, -1e-30, np.inf, -np.inf, 1e4,
                  TANH_WIDEST], np.float32)])
    x = np.concatenate([x, -x])
    want = np.asarray(jax.jit(jnp.tanh)(x))
    got = tc.tanh_sat(T(x)).numpy()
    one = np.abs(want) == 1.0
    assert np.array_equal(got[one], want[one])
    assert not np.any(np.abs(got[~one]) == 1.0)
    assert _ulps(got, want).max() <= tc.TANH_ULPS
    # the widest gap found, past the 4 ulp the first probes saw
    assert _ulps(got[x == TANH_WIDEST], want[x == TANH_WIDEST]).max() == 5
    nan = tc.tanh_sat(torch.tensor([np.nan]))
    assert torch.isnan(nan).all()


# --------------------------------------------------------------- fma_rn ----

def _fma_exact(a, b, c):
    """``a·b + c`` rounded once to float32 (nearest, ties to even)."""
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(v))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    cands = [x for x in cands if np.isfinite(x)]
    best = min(abs(Fraction(float(x)) - v) for x in cands)
    near = [x for x in cands if abs(Fraction(float(x)) - v) == best]
    return min(near, key=lambda x: int(np.float32(x).view(np.int32)) & 1)


def test_fma_rn_rounds_once_and_breaks_double_rounding_ties():
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(size=(3, 4000)) * np.array([[1], [1e-3], [1]])
               ).astype(np.float32)
    got = fma_rn(T(a), T(b), T(c)).numpy()
    want = np.array([_fma_exact(*t) for t in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    # exact a·b + c = 1 + 2^-23 + 2^-24 - 2^-54: float64 rounds it to the
    # float32 tie 1 + 2^-23 + 2^-24, which then rounds to even (up, 1 +
    # 2^-22); the single rounding goes down, to 1 + 2^-23
    a = np.float32(1 - 2.0 ** -15) * np.float32(2.0 ** -12)
    b = np.float32(1 + 2.0 ** -15) * np.float32(2.0 ** -12)
    c = np.float32(1 + 2.0 ** -23)
    got = fma_rn(T([a]), T([b]), T([c])).numpy()[0]
    assert got == _fma_exact(a, b, c) == np.float32(1 + 2.0 ** -23)
    assert np.float32(float(a) * float(b) + float(c)) != got
    # and its mirror below zero
    got = fma_rn(T([-a]), T([b]), T([-c])).numpy()[0]
    assert got == -np.float32(1 + 2.0 ** -23)


# ---------------------------------------------------------------- step ----

def _step_states(rng, n):
    s = (rng.normal(size=(n, 4)) * np.array([1, 1, 0.1, 1])).astype(
        np.float32)
    lim = np.float32(jc.THETA_LIMIT)
    s[:50, 0] = np.float32(jc.X_LIMIT)
    s[50:100, 0] = -np.float32(jc.X_LIMIT)
    s[100:150, 2] = lim
    s[150:200, 2] = -lim
    s[200:250, 0] = np.nextafter(np.float32(jc.X_LIMIT), np.float32(0))
    s[250:260, 1:] = 0.0
    s[260:270] = np.nan
    s[270:275, 3] = np.nan
    s[275:280, 1] = np.inf
    return s


def test_cartpole_step_against_jax():
    rng = np.random.default_rng(2)
    s = _step_states(rng, 20_000)
    a = rng.integers(0, 2, s.shape[0]).astype(np.int32)
    jn, jf = (np.asarray(v) for v in
              jax.jit(jax.vmap(jc.cartpole_step))(jnp.asarray(s),
                                                  jnp.asarray(a)))
    tn, tf = (v.numpy() for v in tc.cartpole_step(T(s), T(a)))
    assert np.array_equal(tf, jf)
    assert np.array_equal(np.isnan(tn), np.isnan(jn))
    fin = np.isfinite(jn).all(1) & np.isfinite(tn).all(1)
    assert np.array_equal(tn[fin][:, [0, 2]], jn[fin][:, [0, 2]])
    # ẋ and θ̇ within STEP_ULPS ulp of their largest term (float64 terms)
    x, xd, th, thd = (s[fin][:, i].astype(np.float64) for i in range(4))
    force = np.where(a[fin] > 0, 10.0, -10.0)
    c, sn = np.cos(th), np.sin(th)
    temp = (force + 0.05 * thd * thd * sn) / 1.1
    den = 0.5 * (4 / 3 - 0.1 * c * c / 1.1)
    tacc = (9.8 * sn - c * temp) / den
    q = 0.05 * tacc * c / 1.1
    scale1 = np.maximum.reduce([np.abs(xd), 0.02 * np.abs(temp),
                                0.02 * np.abs(q)])
    scale3 = np.maximum.reduce([np.abs(thd), 0.02 * np.abs(9.8 * sn) / den,
                                0.02 * np.abs(c * temp) / den])
    for col, scale in ((1, scale1), (3, scale3)):
        err = np.abs(tn[fin][:, col].astype(np.float64) - jn[fin][:, col])
        ulp = np.spacing(scale.astype(np.float32)).astype(np.float64)
        assert np.all(err <= tc.STEP_ULPS * ulp), col


# -------------------------------------------------------------- policy ----

def test_hidden_layer_is_xla_dot_bit_for_bit():
    rng = np.random.default_rng(3)
    B = 20_000
    x = (rng.normal(size=(B, 4)) * 0.05).astype(np.float32)
    W = (rng.normal(size=(B, 4, 16)) * 0.5).astype(np.float32)
    b = (rng.normal(size=(B, 16)) * 0.5).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(lambda a, w, c: a @ w + c))(x, W, b))
    got = fma_rn(T(x)[:, 3, None], T(W)[:, 3], fma_rn(
        T(x)[:, 2, None], T(W)[:, 2], fma_rn(T(x)[:, 1, None], T(W)[:, 1],
                                             T(x)[:, 0, None] * T(W)[:, 0])))
    assert np.array_equal((got + T(b)).numpy(), want)


@pytest.mark.parametrize("sigma", [0.5, 3.0])
def test_policy_logits_against_jax(sigma):
    rng = np.random.default_rng(4)
    B = 50_000
    g = (rng.normal(size=(B, NPARAM)) * sigma).astype(np.float32)
    st = (rng.normal(size=(B, 4)) * np.array([0.5, 0.5, 0.05, 0.5])
          ).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(JPOLICY))(jnp.asarray(g),
                                                 jnp.asarray(st)))
    got = TPOLICY(T(g), T(st)).numpy()
    assert got.shape == want.shape == (B, 2)
    assert np.array_equal(np.abs(got) == 1.0, np.abs(want) == 1.0)
    w2 = np.abs(g[:, 80:112].reshape(B, 16, 2)).sum(1)
    bound = tc.LOGIT_ULPS * (1 + w2) * ULP1
    assert np.all(np.abs(got.astype(np.float64) - want) <= bound)


def test_argmax_first_is_jnp_argmax():
    nan, one = np.nan, 1.0
    rows = np.array([[0.5, 0.5], [0.2, 0.7], [0.7, 0.2], [nan, 0.3],
                     [0.3, nan], [nan, nan], [-one, -one], [one, one],
                     [-0.0, 0.0], [0.0, -0.0]], np.float32)
    want = np.asarray(jnp.argmax(jnp.asarray(rows), axis=-1))
    assert tc.argmax_first(T(rows)).tolist() == want.tolist()
    wide = np.random.default_rng(5).integers(0, 3, (500, 5)).astype(
        np.float32)
    wide[::7, 2] = np.nan
    assert tc.argmax_first(T(wide)).tolist() == np.asarray(
        jnp.argmax(jnp.asarray(wide), axis=-1)).tolist()


# ------------------------------------------------------------ rollouts ----

@jax.jit
def _jax_trace(genomes, starts):
    """The JAX rollout a step at a time (``rollout_population``'s chunk
    step, uncompacted), recording each step's state, logits, action and
    alive flag."""
    P, E = genomes.shape[0], starts.shape[0]
    params = jnp.repeat(genomes, E, axis=0)
    state = jnp.tile(starts, (P, 1))

    def step(carry, _):
        s, alive = carry
        logits = jax.vmap(JPOLICY)(params, s)
        action = jnp.argmax(logits, axis=-1)
        new, failed = jax.vmap(jc.cartpole_step)(s, action)
        s2 = jnp.where(alive[:, None], new, s)
        return (s2, alive & ~failed), (s, logits, action, alive)

    _, trace = jax.lax.scan(step, (state, jnp.ones(P * E, bool)), None,
                            length=500)
    return trace


def _port_trace(genomes, starts, steps=500):
    P, E = genomes.shape[0], starts.shape[0]
    params = T(genomes).repeat_interleave(E, 0)
    s = T(starts).repeat(P, 1)
    alive = torch.ones(P * E, dtype=torch.bool)
    out = []
    for _ in range(steps):
        logits = TPOLICY(params, s)
        action = tc.argmax_first(logits)
        new, failed = tc.cartpole_step(s, action)
        out.append((s, logits, action, alive))
        s = torch.where(alive[:, None], new, s)
        alive = alive & ~failed
    return [torch.stack(z).numpy() for z in zip(*out)]


def _lipschitz(genomes, E):
    g = np.repeat(genomes, E, 0).astype(np.float64)
    W1 = np.abs(g[:, :64].reshape(-1, 4, 16)).sum(1)       # [B, 16]
    W2 = np.abs(g[:, 80:112].reshape(-1, 16, 2))
    return (W2 * W1[:, :, None]).sum(1).max(1), W2.sum(1).max(1)


@pytest.fixture(scope="module")
def traces():
    starts, keys = _starts()
    out = {}
    for sigma in (0.5, 3.0):
        g = (np.random.default_rng(0).normal(size=(256, NPARAM)) * sigma
             ).astype(np.float32)
        jt = [np.asarray(v) for v in _jax_trace(jnp.asarray(g),
                                                jnp.asarray(starts))]
        out[sigma] = (g, starts, keys, jt, _port_trace(g, starts))
    return out


def _check_divergences(g, starts, jt, pt, max_steps):
    """Each episode's first divergence between the JAX trace ``jt`` and
    the port's ``pt`` (the first step where their actions differ while
    both are alive, or where one has failed and the other not) in the
    rollout class; returns ``(same [B] bool, first step [B])``."""
    js, jl, ja, jal = (v[:max_steps] for v in jt)
    ts, tl, ta, tal = (v[:max_steps] for v in pt)
    split = ((ja != ta) & jal & tal) | (jal != tal)
    first = np.where(split.any(0), split.argmax(0), max_steps)
    lip, w2 = _lipschitz(g, starts.shape[0])
    limits = np.array([jc.X_LIMIT, np.float32(jc.THETA_LIMIT)], np.float64)
    for e in np.where(first < max_steps)[0]:
        t = first[e]
        assert np.array_equal(ja[:t, e], ta[:t, e])
        drift = np.abs(js[t, e].astype(np.float64) - ts[t, e])
        if jal[t, e] != tal[t, e]:
            # one failed a step earlier: the limit lies between the two
            # states that the drift separates
            near = np.abs(np.abs(js[t, e][[0, 2]].astype(np.float64))
                          - limits) <= drift[[0, 2]]
            assert near.any(), (e, t, js[t, e], ts[t, e])
            continue
        gap = abs(float(jl[t, e, 1]) - float(jl[t, e, 0]))
        tol = (2 * lip[e] * drift.max()
               + 2 * tc.LOGIT_ULPS * (1 + w2[e]) * ULP1)
        assert gap <= tol, (e, t, gap, drift.max())
    return first == max_steps, first


@pytest.mark.parametrize("max_steps", [200, 500])
@pytest.mark.parametrize("sigma", [0.5, 3.0])
def test_rollout_population_against_jax(traces, sigma, max_steps):
    g, starts, keys, jt, pt = traces[sigma]
    want = np.asarray(jax.jit(lambda x: jc.rollout_population(
        JPOLICY, x, keys, max_steps))(jnp.asarray(g))).reshape(-1)
    got = tc.rollout_population(TPOLICY, T(g), T(starts),
                                max_steps).numpy().reshape(-1)
    # each package's rollout is its traced steps
    assert np.array_equal(jt[3][:max_steps].sum(0).astype(np.float32), want)
    assert np.array_equal(pt[3][:max_steps].sum(0).astype(np.float32), got)
    same, first = _check_divergences(g, starts, jt, pt, max_steps)
    # returns equal wherever the rollouts never part
    assert np.array_equal(got[same], want[same])
    assert (~same).sum() <= 0.02 * same.size
    if sigma == 0.5:  # drift needs its steps to grow to a flip
        assert first.min() > 100


def test_rollout_population_torch_path_equals_rollout():
    starts, _ = _starts(7, 3)
    g = (np.random.default_rng(8).normal(size=(5, NPARAM)) * 0.5).astype(
        np.float32)
    g[0] = 0.0
    g[1, :64:16] = (0.5, 1.0, 10.0, 2.0)   # a balancing controller
    g[1, 80:82] = (-4.0, 4.0)

    def plain_policy(params, state):      # the torch path, not J5's
        return TPOLICY(params, state)

    want = np.array([[float(tc.rollout(TPOLICY, T(gi), T(s), 60))
                      for s in starts] for gi in g], np.float32)
    assert want[1].tolist() == [60.0] * 3
    for chunk, min_size in ((10, 512), (1, 1), (20, 8), (30, 0), (60, 64)):
        got = tc.rollout_population(plain_policy, T(g), T(starts), 60,
                                    chunk=chunk, min_size=min_size)
        assert np.array_equal(got.numpy(), want), (chunk, min_size)
    assert np.array_equal(
        tc.rollout_population(TPOLICY, T(g), T(starts), 60).numpy(), want)
    assert np.array_equal(
        tc.cartpole_rollout_plain(T(g), T(starts), 60).numpy(), want)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tc.rollout_population(TPOLICY, T(g), T(starts), 65, chunk=10)
    with pytest.raises(ValueError, match="multiple of chunk"):
        tc.rollout_population(plain_policy, T(g), T(starts), 7, chunk=2)
    assert float(tc.rollout(TPOLICY, T(g[2]), T(starts[0]), 0)) == 0.0


def test_cartpole_rollout_cpu_path_and_its_checks():
    starts, _ = _starts(9, 3)
    g = (np.random.default_rng(10).normal(size=(5, NPARAM))).astype(
        np.float32)
    out = tc.cartpole_rollout(T(g), T(starts), 50)
    assert out.dtype == torch.float32 and out.shape == (5, 3)
    assert torch.equal(out, tc.rollout_population(TPOLICY, T(g), T(starts),
                                                  50))
    with pytest.raises(ValueError, match="parameters"):
        tc.cartpole_rollout(T(g[:, :100]), T(starts), 50)
    with pytest.raises(ValueError, match="card"):
        tc.cartpole_rollout(T(g), T(starts), 50,
                            clocks=torch.zeros(15, dtype=torch.int64))
    with pytest.raises(ValueError, match="no kernel"):
        tc.cartpole_rollout(T(g).to("meta"), T(starts).to("meta"), 50)
    # the card's checks, on tensors that never reach a launch
    with pytest.raises(ValueError, match=r"\(4, H, 2\)"):
        tc._j5_hidden((4, 8, 8, 2), T(g), T(starts))
    with pytest.raises(ValueError, match=r"\(4, H, 2\)"):
        tc._j5_hidden((4, tc.J5_MAX_HIDDEN + 1, 2), T(g), T(starts))
    with pytest.raises(ValueError, match="float32"):
        tc._j5_hidden(SIZES, T(g).double(), T(starts))
    assert tc._j5_hidden(SIZES, T(g), T(starts)) == 16


def test_the_port_holds_every_cartpole_name():
    names = {n for n in dir(jc) if not n.startswith("_")
             and callable(getattr(jc, n)) and getattr(
                 getattr(jc, n), "__module__", "") == jc.__name__}
    assert names == {"cartpole_step", "initial_state", "rollout",
                     "rollout_population", "mlp_policy"}
    assert names <= set(tc.__all__)


def test_initial_state_draws_uniform_starts():
    s = tc.initial_state(make_generator(0, "cpu"), 20_000)
    assert s.shape == (20_000, 4) and s.dtype == torch.float32
    assert float(s.min()) >= -0.05 and float(s.max()) < 0.05
    assert abs(float(s.mean())) < 1e-3
    assert torch.equal(tc.initial_state(make_generator(0, "cpu"), 20_000), s)


def test_mlp_policy_layout_and_deeper_layers():
    policy, n = tc.mlp_policy((4, 8, 3, 2))
    jpol, jn_ = jc.mlp_policy((4, 8, 3, 2))
    assert n == jn_ == 4 * 8 + 8 + 8 * 3 + 3 + 3 * 2 + 2
    rng = np.random.default_rng(11)
    g = (rng.normal(size=(300, n))).astype(np.float32)
    st = (rng.normal(size=(300, 4)) * 0.1).astype(np.float32)
    want = np.asarray(jax.jit(jax.vmap(jpol))(jnp.asarray(g),
                                              jnp.asarray(st)))
    got = policy(T(g), T(st)).numpy()
    assert np.abs(got.astype(np.float64) - want).max() < 1e-5
    assert policy.sizes == (4, 8, 3, 2) and TPOLICY.sizes == SIZES


# ------------------------------------------------- one bench generation ----

POP, NGEN_ALPHA, CXPB, MUTPB = 128, 0.1, 0.5, 0.5


def _jax_toolbox(keys):
    from deap_tpu import ops as jops
    from deap_tpu.core.toolbox import Toolbox
    tb = Toolbox()
    # jitted once (its loops compile either way; the mean rounds alike)
    tb.register("evaluate", jax.jit(lambda g: jc.rollout_population(
        JPOLICY, g, keys, 500).mean(axis=1)))
    tb.register("mate", jops.cx_blend, alpha=NGEN_ALPHA)
    tb.register("mutate", jops.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.1)
    tb.register("select", jops.sel_tournament, tournsize=3)
    return tb


def _blend_u(k):
    return jax.random.uniform(k, (NPARAM,))


def _gauss_draws(k):
    km, kn = jax.random.split(k)
    return (jax.random.bernoulli(km, 0.1, (NPARAM,)),
            jax.random.normal(kn, (NPARAM,)))


def _jax_generation(k0, k):
    """bench_suite.py's start and step at pop 128 (bench_cartpole), and the
    draws that step takes. The start, the selection and the draws are
    jitted (no rounding there that the port recomputes); the variation
    runs eagerly, one rounding an operation, as the port's blend computes
    it (jitted, XLA contracts blend's products into fused multiply-adds,
    an ulp apart on some genes)."""
    from deap_tpu import ops as jops
    from deap_tpu.algorithms import evaluate_invalid, var_and
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    from deap_tpu.core.population import gather, init_population as jinit
    keys = jax.random.split(jax.random.key(123), 3)
    tb = _jax_toolbox(keys)
    k1, k2 = jax.random.split(k)

    @jax.jit
    def start_and_draws(k0, k1, k2):
        pop = jinit(k0, POP, jops.normal_genome(NPARAM, sigma=0.5),
                    JSpec((1.0,)))
        pop = evaluate_invalid(pop, tb.evaluate)
        idx = tb.select(k1, pop.wvalues, POP)
        k_pair, k_cx, k_ind, k_mut = jax.random.split(k2, 4)
        draws = (jax.random.randint(k1, (POP, 3), 0, POP),
                 jax.random.bernoulli(k_pair, CXPB, (POP // 2,)),
                 jax.vmap(_blend_u)(jax.random.split(k_cx, POP // 2)),
                 jax.random.bernoulli(k_ind, MUTPB, (POP,)),
                 jax.vmap(_gauss_draws)(jax.random.split(k_mut, POP)))
        return pop, idx, draws

    pop, idx, draws = start_and_draws(k0, k1, k2)
    off = var_and(k2, gather(pop, idx), tb, CXPB, MUTPB)
    off = evaluate_invalid(off, tb.evaluate)
    return pop, idx, off, draws, keys


def test_one_cartpole_generation_on_the_jax_draws():
    pop, idx, off, draws, keys = _jax_generation(jax.random.key(90),
                                                 jax.random.key(5))
    asp, do_cx, u, do_mut, (mask, z) = (np.asarray(d) if not isinstance(
        d, tuple) else tuple(np.asarray(x) for x in d) for d in draws)
    starts = T(np.asarray(jax.vmap(jc.initial_state)(keys)))

    def evaluate(genomes):
        return mean0(tc.rollout_population(TPOLICY, genomes, starts,
                                           500).T)

    # gen 0: the JAX genomes, evaluated by the port
    g0 = T(pop.genomes)
    f0 = evaluate(g0).numpy()
    tidx = tsel._tournament_winners(T(pop.wvalues), T(asp).long())
    assert np.array_equal(tidx.numpy(), np.asarray(idx))

    parents = g0[tidx]
    even, odd = parents[0::2], parents[1::2]
    c1, c2 = tcx._blend(even, odd, NGEN_ALPHA, T(u))
    cx = T(do_cx)[:, None]
    kids = torch.stack([torch.where(cx, c1, even), torch.where(cx, c2, odd)],
                       1).reshape(POP, NPARAM)
    mutated = tmut._gaussian(kids, 0.0, 0.3, T(mask), T(z))
    kids = torch.where(T(do_mut)[:, None], mutated, kids)
    assert np.array_equal(kids.numpy(), np.asarray(off.genomes))
    touched = np.repeat(np.asarray(do_cx), 2) | np.asarray(do_mut)
    assert touched.any() and not touched.all()

    # fitness: the port's rollout of the same genomes; the JAX mean is the
    # sum times float32(1/3) (jnp.mean), as mean0 computes it
    f1 = evaluate(kids).numpy()
    want0 = np.asarray(pop.fitness)[:, 0]
    want1 = np.asarray(off.fitness)[:, 0]
    for got, want, g in ((f0, want0, g0), (f1, want1, kids)):
        ok = got == want
        assert ok.mean() >= 0.97
        if not ok.all():  # those rows' episodes in the rollout class
            rows, st = g.numpy()[~ok], starts.numpy()
            jt = [np.asarray(v) for v in _jax_trace(jnp.asarray(rows),
                                                    jnp.asarray(st))]
            same, _ = _check_divergences(rows, st, jt, _port_trace(rows, st),
                                         500)
            assert not same.all()
    # K1 is not on this path: blend has no fused form
    tb = chip_smoke.cartpole_toolbox(starts)
    assert ops.variation.resolve_plan(tb) is None
    before = ops.kernels.fused_variation.launches
    g = make_generator(0, "cpu")
    p = init_population(g, 16, ops.normal_genome(NPARAM, sigma=0.5),
                        FitnessSpec((1.0,)), device="cpu")
    p = algorithms.evaluate_invalid(p, tb.evaluate)
    p = chip_smoke.cartpole_generation(g, p, tb)
    assert ops.kernels.fused_variation.launches == before
    assert bool(p.valid.all())


def test_mean_of_three_returns_rounds_as_jnp_mean():
    r = np.random.default_rng(12).integers(1, 501, (10_000, 3)).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda x: x.mean(axis=1))(r))
    assert np.array_equal(mean0(T(r).T).numpy(), want)


# --------------------------------------------------------------- mesh ----

def test_one_device_mesh_places_the_population():
    mesh = parallel.population_mesh(device="cpu")
    assert mesh.devices == (torch.device("cpu"),)
    assert mesh.axis_names == ("pop",) and mesh.shape == (1,)
    pop = init_population(make_generator(0, "cpu"), 8,
                          ops.normal_genome(5), FitnessSpec((1.0,)),
                          device="cpu")
    placed = parallel.shard_population(pop, mesh)
    assert torch.equal(placed.genomes, pop.genomes)
    assert placed.fitness.device == mesh.device
    with pytest.raises(ValueError, match="axis"):
        parallel.shard_population(pop, mesh, axis="island")
    m2 = parallel.population_mesh(axis_names=("island", "genome"),
                                  device="cpu")
    assert m2.shape == (1, 1)
    with pytest.raises(ValueError, match="initialize"):
        parallel.population_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        parallel.population_mesh(shape=(2,), device="cpu")


def test_mesh_of_several_cards_raises(monkeypatch):
    """Four visible cards and no process group give the one-card mesh (a
    mesh of several cards is a process group's, one rank a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mesh = parallel.population_mesh()
    assert mesh.devices == (torch.device("cuda", 0),) and mesh.shape == (1,)
    with pytest.raises(ValueError, match="initialize"):
        parallel.population_mesh(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.population_mesh()
