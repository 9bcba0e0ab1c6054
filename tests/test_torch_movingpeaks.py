"""Moving Peaks (``deap_tpu_torch.benchmarks.movingpeaks``) against the
JAX package's, on the CPU.

The port's changes take the JAX package's draws (its key split in four:
the next key, a uniform shift, two normals), injected through
``change_peaks_draws``. Bounds (``movingpeaks.CHANGE_ULPS``,
``EXACT_ULPS``, ``SUM_RTOL``):

- bitwise: :func:`change_peaks_from_draws` against ``change_peaks``
  called alone, the landscape's values, ``maximums`` and
  ``global_maximum``, and ``mp_evaluate``'s batched values, running error
  and counts, a crossing batch included;
- a change inside the JAX package's ``mp_evaluate`` is compiled under
  ``lax.cond`` (XLA contracts its ``a·b + c``): the landscape after it
  within ``CHANGE_ULPS`` ulps of each field's largest magnitude;
- ``exact=True`` evaluates in a compiled scan: values within
  ``EXACT_ULPS`` ulps of the batch's largest value;
- the offline error sums in another order: within ``SUM_RTOL``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.benchmarks import movingpeaks as jmp
from deap_tpu_torch import convert
from deap_tpu_torch.benchmarks import movingpeaks as tmp
from deap_tpu_torch.device import make_generator

FIELDS = ("position", "height", "width", "last_change")


def _cfgs(scenario, dim, **over):
    js = {**getattr(jmp, scenario), **over}
    ts = {**getattr(tmp, scenario),
          **{k: getattr(tmp, v.__name__) if callable(v) else v
             for k, v in over.items()}}
    return (jmp.MovingPeaksConfig(dim=dim, **js),
            tmp.MovingPeaksConfig(dim=dim, **ts))


def _to_port(js, seed=0):
    return convert.movingpeaks_state_from_arrays(
        *(np.asarray(getattr(js, f)) for f in FIELDS), int(js.nevals),
        np.asarray(js.current_error), np.asarray(js.offline_error_sum),
        seed=seed, device="cpu")


def _jax_draws(key, js):
    """``change_peaks``' draws from ``key``, and the key after."""
    key, ks, kh, kw = jax.random.split(key, 4)
    return key, tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(ks, js.position.shape),
        jax.random.normal(kh, js.height.shape),
        jax.random.normal(kw, js.width.shape)))


@pytest.fixture
def inject(monkeypatch):
    """Make the port's changes take the JAX package's draws from a key
    chain starting at ``key``."""
    def start(key, js):
        chain = {"key": key}

        def draws(generator, state):
            chain["key"], d = _jax_draws(chain["key"], js)
            return d
        monkeypatch.setattr(tmp, "change_peaks_draws", draws)
    return start


def _ulps(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.spacing(
        np.float32(np.abs(want).max()))


def _landscape_close(ts, js):
    for f in FIELDS:
        assert _ulps(getattr(ts, f).numpy(), getattr(js, f)) \
            <= tmp.CHANGE_ULPS, f


def _points(seed, n, dim):
    return np.random.default_rng(seed).uniform(0, 100, (n, dim)).astype(
        np.float32)


#: S1 with each of its peak functions at one shape, S2 and S3 (cone, λ
#: 0.5, S3's basis; S3 at S2's 10 peaks); 64 points a batch throughout,
#: so the JAX package compiles each program once
SCENARIOS = [("SCENARIO_1", 2, {}), ("SCENARIO_1", 2, {"pfunc": jmp.cone}),
             ("SCENARIO_1", 2, {"pfunc": jmp.sphere_peak}),
             ("SCENARIO_2", 5, {}), ("SCENARIO_3", 5, {"npeaks": 10})]
N = 64


@pytest.mark.parametrize("scenario,dim,over", SCENARIOS)
def test_change_peaks_and_landscape_bitwise(scenario, dim, over):
    jc, tc = _cfgs(scenario, dim, **over)
    js = jmp.mp_init(jax.random.key(3), jc)
    ts = _to_port(js)
    x = _points(1, N, dim)
    for _ in range(2):
        want = np.asarray(jax.vmap(lambda r: jmp._landscape(jc, js, r))(
            jnp.asarray(x)))
        got = tmp._landscape(tc, ts, torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)
        wv, wp = jmp.maximums(jc, js)
        gv, gp = tmp.maximums(tc, ts)
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
        assert float(tmp.global_maximum(tc, ts)) == float(
            jmp.global_maximum(jc, js))
        _, d = _jax_draws(js.key, js)
        js = jmp.change_peaks(jc, js)
        ts = tmp.change_peaks_from_draws(tc, ts, *d)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                          np.asarray(getattr(js, f)), f)
    lo, hi = tc.min_coord, tc.max_coord
    assert float(ts.position.min()) >= lo and float(ts.position.max()) <= hi


def test_batched_evaluate_through_a_change(inject):
    """Batches before, across and after a boundary: values, running
    error and counts bitwise before the change; after it, on a landscape
    one contracted change apart, within ``CHANGE_ULPS``."""
    jc, tc = _cfgs("SCENARIO_2", 5)
    js = jmp.mp_init(jax.random.key(5), jc)
    js = js.replace(nevals=jnp.int32(jc.period - 100))
    ts = _to_port(js).replace(nevals=jc.period - 100)
    inject(js.key, js)
    for seed in range(3):
        x = _points(seed, N, 5)
        js_next, want = jmp.mp_evaluate(jc, js, jnp.asarray(x))
        ts_next, got = tmp.mp_evaluate(tc, ts, torch.from_numpy(x))
        if seed < 2:  # the old landscape (the change comes after a batch)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert float(ts_next.current_error) == float(
                js_next.current_error)
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5)
            np.testing.assert_allclose(float(ts_next.current_error),
                                       float(js_next.current_error),
                                       rtol=1e-4, atol=1e-4)
        if seed == 1:  # the change: the running error restarts
            assert float(ts_next.current_error) == np.inf
            assert float(js_next.current_error) == np.inf
        assert ts_next.nevals == int(js_next.nevals)
        np.testing.assert_allclose(float(ts_next.offline_error_sum),
                                   float(js_next.offline_error_sum),
                                   rtol=tmp.SUM_RTOL)
        _landscape_close(ts_next, js_next)
        js, ts = js_next, ts_next
    assert float(tmp.offline_error(ts)) == pytest.approx(
        float(jmp.offline_error(js)), rel=tmp.SUM_RTOL)
    assert float(tmp.current_error(ts)) == pytest.approx(
        float(jmp.current_error(js)), rel=1e-4, abs=1e-4)


@pytest.mark.parametrize("scenario,dim,period,start", [
    ("SCENARIO_1", 2, 50, 10),   # 2 boundaries inside the batch
    ("SCENARIO_2", 5, 64, 0),    # one inside, one at its end
])
def test_exact_evaluate_per_individual(scenario, dim, period, start,
                                       inject):
    n = 2 * N
    jc, tc = _cfgs(scenario, dim, period=period)
    js = jmp.mp_init(jax.random.key(11), jc)
    js = js.replace(nevals=jnp.int32(start))
    ts = _to_port(js).replace(nevals=start)
    inject(js.key, js)
    x = _points(4, n, dim)
    js2, want = jmp.mp_evaluate(jc, js, jnp.asarray(x), exact=True)
    ts2, got = tmp.mp_evaluate(tc, ts, torch.from_numpy(x), exact=True)
    assert got.shape == (n, 1)
    assert _ulps(got.numpy(), want) <= tmp.EXACT_ULPS
    assert ts2.nevals == int(js2.nevals) == start + n
    np.testing.assert_allclose(float(ts2.offline_error_sum),
                               float(js2.offline_error_sum),
                               rtol=tmp.SUM_RTOL)
    np.testing.assert_allclose(float(ts2.current_error),
                               float(js2.current_error), rtol=1e-5)
    _landscape_close(ts2, js2)
    # a batch that crosses none: the batched bookkeeping, no change
    js3, want3 = jmp.mp_evaluate(jc, js2, jnp.asarray(x[:8]), exact=True)
    ts3, got3 = tmp.mp_evaluate(tc, ts2, torch.from_numpy(x[:8]), exact=True)
    assert _ulps(got3.numpy(), want3) <= tmp.EXACT_ULPS
    assert torch.equal(ts3.position, ts2.position)
    # the same batch without exact= changes once, at its end
    ts4, _ = tmp.mp_evaluate(tc, ts, torch.from_numpy(x))
    assert ts4.nevals == start + n
    assert not torch.equal(ts4.position, ts.position)


def test_init_draws_and_round_trip():
    _, tc = _cfgs("SCENARIO_2", 4)
    st = tmp.mp_init(make_generator(0, "cpu"), tc)
    assert st.position.shape == (10, 4) and st.nevals == 0
    assert 30.0 <= float(st.height.min()) <= float(st.height.max()) <= 70.0
    assert 1.0 <= float(st.width.min()) <= float(st.width.max()) <= 12.0
    assert float(st.last_change.abs().max()) <= 0.5
    assert float(st.current_error) == np.inf
    # change_peaks draws from the state's generator
    replay = make_generator(0, "cpu")
    replay.set_state(st.generator.get_state())
    got = tmp.change_peaks(tc, st)
    want = tmp.change_peaks_from_draws(
        tc, st, *tmp.change_peaks_draws(replay, st))
    assert all(torch.equal(getattr(got, f), getattr(want, f))
               for f in FIELDS)
    arrays = convert.movingpeaks_state_to_arrays(got)
    back = convert.movingpeaks_state_from_arrays(
        *(arrays[f] for f in FIELDS), arrays["nevals"],
        arrays["current_error"], arrays["offline_error_sum"],
        generator_state=arrays["generator_state"], device="cpu")
    assert all(torch.equal(getattr(back, f), getattr(got, f))
               for f in FIELDS)
    assert torch.equal(torch.rand(3, generator=back.generator),
                       torch.rand(3, generator=got.generator))
    assert dataclasses.replace(back, nevals=7).nevals == 7


def test_dynamic_examples_run():
    """``examples/pso/multiswarm.py``, ``speciation.py`` and
    ``de/dynamic.py`` as ``chip_smoke.py`` times them, a few steps each:
    finite bests, never above the landscape's optimum."""
    import chip_smoke
    cpu = torch.device("cpu")
    for fn, kw in ((chip_smoke.multiswarm_example, dict(epochs=2, gens=4)),
                   (chip_smoke.speciation_example, dict(steps=4)),
                   (chip_smoke.de_dynamic_example, dict(epochs=2, gens=4))):
        best, gens, detail = fn(cpu, **kw)
        assert np.isfinite(best) and gens > 0, (fn.__name__, detail)
