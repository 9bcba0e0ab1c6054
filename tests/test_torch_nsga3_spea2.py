"""NSGA-III and dense SPEA2 (``deap_tpu_torch.mo.emo``) against the JAX
package's, on the CPU.

- ``sel_nsga3``: the port's plan (:func:`nsga3_plan`) gives the rows to
  fill and the partial front; the niching draws are rebuilt from the JAX
  package's key as its loop folds it (iteration ``i``: ``fold_in(key,
  i)`` for the niches, ``fold_in`` of that with 1 for the rows, the
  latter gathered at the partial front's rows), and the chosen indices
  and the memory are held bitwise. ``jnp.linalg.norm`` is jitted and XLA fuses its
  squares into the sum at some widths, which moves a distance by an ulp
  and, on fronts of exact ties, which of two tied rows a niche takes:
  on tied fronts the JAX module gets a ``jnp`` whose ``linalg.norm`` is
  the eager ``sqrt(sum(x ** 2))`` (the port's ``ops.linalg.norm_rn``; a
  test-time attribute of the module, the JAX package untouched); random
  fronts are held against the unchanged function.
- ``sel_spea2``: bitwise on a random front, an over-full front, a tied
  front and an under-full cascade (the fronts of
  ``tests/test_spea2_divergence.py``), its double-float32 distances
  bitwise too.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deap_tpu.mo.emo as jemo
from deap_tpu import mo as jmo
from deap_tpu_torch import mo
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.mo import emo


def _t(a):
    return torch.from_numpy(np.array(a))


class _UnfusedNormJnp:
    """``jax.numpy`` with ``linalg.norm`` as eager ``sqrt(sum(x ** 2))``."""
    linalg = types.SimpleNamespace(
        norm=lambda x, axis=-1, keepdims=False: jnp.sqrt(
            jnp.sum(x ** 2, axis=axis, keepdims=keepdims)),
        solve=jnp.linalg.solve)

    def __getattr__(self, name):
        return getattr(jnp, name)


@jax.jit
def _fold_draws(key, nref, n):
    """Iteration i's draws for every i < n (the arrays give the sizes)."""
    def one(i):
        kk = jax.random.fold_in(key, i)
        return (jax.random.uniform(kk, (nref.shape[0],)),
                jax.random.uniform(jax.random.fold_in(kk, 1), (n.shape[0],)))
    return jax.vmap(one)(jnp.arange(n.shape[0]))


def _jax_niching_draws(key, plan, nref, n):
    """The JAX package's draws of the first ``n_fill`` iterations, the row
    draws at the partial front's rows."""
    a, b = _fold_draws(key, jnp.zeros(nref), jnp.zeros(n))
    return (_t(np.asarray(a)[:plan.n_fill]),
            _t(np.asarray(b)[:plan.n_fill][:, plan.partial_idx.numpy()]))


def _front(kind, seed, n, nobj):
    rng = np.random.default_rng(seed)
    w = -rng.uniform(0, 1, (n, nobj))
    if kind == "tied":
        w = np.round(w * 4) / 4
    elif kind == "sphere":  # DTLZ2-like: most rows on one front
        w = -np.abs(rng.standard_normal((n, nobj)))
        w /= np.linalg.norm(w, axis=1, keepdims=True)
        w *= 1.0 + 0.2 * rng.random((n, 1))
    return w.astype(np.float32)


#: one shape (200 rows, 3 objectives, k 100, 28 reference points): the
#: JAX package compiles its niching loop once a shape
NSGA3_CASES = [("random", 0, 200, 3, 100, 6), ("sphere", 3, 200, 3, 100, 6),
               ("tied", 1, 200, 3, 100, 6)]


@pytest.mark.parametrize("kind,seed,n,nobj,k,p", NSGA3_CASES)
def test_sel_nsga3_bitwise_on_the_reference_draws(kind, seed, n, nobj, k, p,
                                                  monkeypatch):
    if kind == "tied":
        monkeypatch.setattr(jemo, "jnp", _UnfusedNormJnp())
    w = _front(kind, seed, n, nobj)
    ref = jmo.uniform_reference_points(nobj, p)
    key = jax.random.key(seed)
    want, mem = jemo.sel_nsga3(key, jnp.asarray(w), k, ref,
                               return_memory=True)
    plan = emo.nsga3_plan(_t(w), k, _t(ref))
    niche_u, member_u = _jax_niching_draws(key, plan, ref.shape[0], n)
    assert plan.n_fill > 0
    got = emo.nsga3_select(plan, k, niche_u, member_u)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for a, b in zip(plan.memory, mem):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sel_nsga3_with_memory_bitwise():
    """Two generations carrying the memory, as ``SelNSGA3WithMemory``."""
    ref = jmo.uniform_reference_points(3, 6)
    jsel, tsel = jemo.SelNSGA3WithMemory(ref), emo.SelNSGA3WithMemory(_t(ref))
    for g in range(2):
        w = _front("sphere", 10 + g, 200, 3)
        key = jax.random.key(20 + g)
        want = jsel(key, jnp.asarray(w), 100)
        mem = tsel.memory
        plan = emo.nsga3_plan(_t(w), 100, _t(ref), *(
            (None,) * 3 if mem is None else mem))
        got = emo.nsga3_select(plan, 100,
                               *_jax_niching_draws(key, plan, 28, 200))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        tsel.memory = plan.memory
        for a, b in zip(tsel.memory, jsel.memory):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the wrapper draws from its generator and keeps the memory
    sel = emo.SelNSGA3WithMemory(_t(ref))
    idx = sel(make_generator(0, "cpu"), _t(_front("sphere", 3, 60, 3)), 20)
    assert idx.shape == (20,) and sel.memory is not None
    assert len(set(idx.tolist())) == 20


def test_intercepts_fall_back_on_a_singular_hyperplane():
    """Duplicated extreme points: a singular system; ``solve_ex`` does not
    raise and the intercepts fall back to the front's worst, as the JAX
    package's non-finite solution does."""
    ext = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                   np.float32)
    best = np.zeros(3, np.float32)
    worst = np.array([2.0, 3.0, 4.0], np.float32)
    want = jemo._find_intercepts(jnp.asarray(ext), jnp.asarray(best),
                                 jnp.asarray(worst), jnp.asarray(worst))
    got = emo._find_intercepts(_t(ext), _t(best), _t(worst), _t(worst))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), worst)


def test_nsga3_draws_and_exports():
    ref = mo.uniform_reference_points(3, 4)
    w = _t(_front("sphere", 5, 80, 3))
    plan = emo.nsga3_plan(w, 40, ref)
    u = emo.nsga3_draws(make_generator(1, "cpu"), plan)
    assert u.shape == (plan.n_fill, 2)
    got = mo.sel_nsga3(make_generator(1, "cpu"), w, 40, ref)
    assert torch.equal(got, emo.nsga3_select_scaled(plan, 40, u))
    assert mo.selNSGA3 is mo.sel_nsga3 and mo.selSPEA2 is mo.sel_spea2
    assert mo.NSGA3Memory is emo.NSGA3Memory


def _plan(kind, seed):
    ref = mo.uniform_reference_points(3, 6)
    return emo.nsga3_plan(_t(_front(kind, seed, 200, 3)), 100, ref), ref


@pytest.mark.parametrize("kind,seed", [("random", 0), ("sphere", 3),
                                       ("tied", 1)])
def test_nsga3_scaled_draws_take_the_reference_loops_choices(kind, seed):
    """Each iteration's two draws at their ends: ``u`` 0 takes the first
    candidate, as a decreasing uniform an index does, and ``u`` just
    below 1 the last, as an increasing one does, so both forms choose
    the same rows on such draws."""
    plan, ref = _plan(kind, seed)
    nf, m, nref = plan.n_fill, plan.partial_idx.shape[0], ref.shape[0]
    ends = torch.from_numpy(np.random.default_rng(seed).random((nf, 2))
                            < 0.5)
    u = torch.where(ends, 1.0 - 2.0 ** -24, 0.0)
    niche_u = torch.where(ends[:, :1], torch.arange(nref) + 1.0,
                          nref - torch.arange(nref).float()) / (nref + 1)
    member_u = torch.where(ends[:, 1:], torch.arange(m) + 1.0,
                           m - torch.arange(m).float()) / (m + 1)
    want = emo.nsga3_select(plan, 100, niche_u, member_u)
    assert torch.equal(emo.nsga3_select_scaled(plan, 100, u), want)


def test_nsga3_scaled_draws_choose_in_the_reference_distribution():
    """``sel_nsga3``'s draws against the JAX package's (a uniform an
    index, the largest taken; ``nsga3_select`` holds that form bitwise):
    over 300 seeds each, the mean summed distance and the mean summed
    position of the chosen partial-front rows within 3 standard
    errors."""
    plan, ref = _plan("sphere", 3)
    nf, m, nref = plan.n_fill, plan.partial_idx.shape[0], ref.shape[0]
    pos = torch.arange(m, dtype=torch.float64)
    stats = {"scaled": [], "reference": []}
    for seed in range(300):
        g = make_generator(seed, "cpu")
        for form, chosen in (
                ("scaled", emo.nsga3_select_scaled(
                    plan, 100, emo.nsga3_draws(g, plan))),
                ("reference", emo.nsga3_select(
                    plan, 100, torch.rand((nf, nref), generator=g),
                    torch.rand((nf, m), generator=g)))):
            taken = torch.isin(plan.partial_idx, chosen)
            stats[form].append([float(plan.dist[taken].double().sum()),
                                float(pos[taken].sum())])
    a, b = np.array(stats["scaled"]), np.array(stats["reference"])
    se = np.sqrt(a.var(0, ddof=1) / len(a) + b.var(0, ddof=1) / len(b))
    assert (np.abs(a.mean(0) - b.mean(0)) <= 3 * se).all(), (
        a.mean(0), b.mean(0), se)


# ------------------------------------------------------------------ SPEA2 --

def _spea2_fronts():
    """The fronts of tests/test_spea2_divergence.py at 120 rows: random
    mixed, over-full (mutually non-dominated), tied (duplicated spaced
    points) and an under-full dominated cascade."""
    rng = np.random.default_rng(1)
    out = [("random", rng.uniform(0.0, 10.0, (120, 2)), 40)]
    f1 = np.sort(np.random.default_rng(5).uniform(0.0, 10.0, 120))
    out.append(("overfull", np.stack([f1, 10.0 - f1], 1), 40))
    f1 = np.linspace(0.0, 10.0, 60)
    out.append(("tied", np.repeat(np.stack([f1, 10.0 - f1], 1), 2, 0), 80))
    rng = np.random.default_rng(11)
    base = rng.uniform(0, 1, (120, 1))
    w = np.concatenate([base, base], 1) * 10.0
    out.append(("underfull", w + rng.uniform(0, 0.05, w.shape), 40))
    return [(name, w.astype(np.float32), k) for name, w, k in out]


@pytest.mark.parametrize("name,w,k", _spea2_fronts(),
                         ids=[f[0] for f in _spea2_fronts()])
def test_sel_spea2_bitwise(name, w, k):
    want = np.asarray(jemo.sel_spea2(jax.random.key(0), jnp.asarray(w), k))
    got = mo.sel_spea2(None, _t(w), k).numpy()
    np.testing.assert_array_equal(got, want)
    assert len(set(got.tolist())) == k
    if name in ("overfull", "tied"):
        # the double-float32 truncation picks the float64 set
        got64 = mo.sel_spea2(None, _t(w.astype(np.float64)), k).numpy()
        assert set(got64.tolist()) == set(got.tolist())


def test_d2_compensated_bitwise():
    w = _spea2_fronts()[1][1]
    hi, lo = jemo._d2_compensated(jnp.asarray(w))
    thi, tlo = emo._d2_compensated(_t(w))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(hi))
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(lo))
    exact = ((w[:, None, :].astype(np.float64)
              - w[None, :, :].astype(np.float64)) ** 2).sum(-1)
    got = thi.numpy().astype(np.float64) + tlo.numpy().astype(np.float64)
    assert np.abs(got - exact).max() <= 1e-12 * exact.max()


# ------------------------------------------------- gates and the example --

@pytest.mark.parametrize("seed", [12, 13])
def test_nsga3_zdt1_hypervolume_gate(seed):
    """The JAX package's gate (tests/test_mo.py): µ 16, 5 genes, 100
    generations, 13 reference points, hypervolume of [11, 11] > 116."""
    import chip_smoke
    from deap_tpu_torch.native import hypervolume
    pop = chip_smoke.nsga3_zdt1_run(make_generator(seed, "cpu"),
                                    torch.device("cpu"))
    assert hypervolume(pop.fitness.numpy(), [11.0, 11.0]) > 116.0
    assert float(pop.genomes.min()) >= 0.0 and float(pop.genomes.max()) <= 1.0


def test_nsga3_example_runs():
    """``examples/ga/nsga3.py`` as ``chip_smoke.py`` times it, a few
    generations: 92 rows on DTLZ2's front."""
    import chip_smoke
    spread, gens, detail = chip_smoke.nsga3_example(torch.device("cpu"),
                                                    ngen=5)
    assert gens == 5 and np.isfinite(spread) and "population 92" in detail
