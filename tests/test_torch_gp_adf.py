"""Automatically defined functions: the port's ``gp.adf`` held against the
JAX package's.

Branches are ``examples/gp/adf_symbreg.py``'s: MAIN (one argument) calls
ADF0-ADF2, ADF0 calls ADF1 and ADF2, ADF1 calls ADF2, every ADF of two
arguments. Populations come from the JAX package's ADF generator; the
port's generator core on each branch's JAX draws gives them bit for bit.

- The batch interpreters (``specialize`` ``'auto'`` and ``'none'``) equal
  the JAX package's bit for bit where no trigonometry is live (every
  element one IEEE operation or a select). With MAIN's ``cos``/``sin``
  live, torch's and XLA's CPU ``cos``/``sin`` differ by up to 2 ulp on
  their own (``TRIG_ULPS`` of tests/test_torch_gp_interp.py); through the
  programs that follow them the difference grows, and the values are held
  within ``TRIG_PROGRAM_RTOL`` of each other (relative to the population's
  largest magnitude, the bound found), the non-finite values in the same
  places. The one-individual interpreter equals the batch bit for bit.
- ``branch_wise_cx`` over one-point crossover on each branch's JAX
  draws: bitwise; ``branch_wise_mut`` hands each branch to its own
  operator with the one generator.

The JAX package's ``arity_table`` calls ``jax.core.trace_state_clean``
(moved by jax 0.9); the fixture aliases it in this test process only.
"""

import functools

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu_torch import Toolbox, FitnessSpec, algorithms, ops
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import (adf_genomes_from_arrays,
                                    adf_genomes_to_arrays)
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.gp import tree as ttree

#: whole programs with cos/sin live: the bound found on these
#: populations, relative to the largest finite magnitude
TRIG_PROGRAM_RTOL = 1e-5
MAIN_LEN, ADF_LEN, N = 32, 16, 24


@pytest.fixture(autouse=True)
def _trace_state_shim(monkeypatch):
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)


def build_branches(m, trig):
    adf2 = m.math_set(n_args=2, trig=False, erc=False, name="ADF2")
    adf1 = m.math_set(n_args=2, trig=False, erc=False, name="ADF1")
    adf1.add_adf("ADF2", 2, branch=3)
    adf0 = m.math_set(n_args=2, trig=False, erc=False, name="ADF0")
    adf0.add_adf("ADF1", 2, branch=2)
    adf0.add_adf("ADF2", 2, branch=3)
    main = m.math_set(n_args=1, trig=trig, erc=True, name="MAIN")
    main.add_adf("ADF0", 2, branch=1)
    main.add_adf("ADF1", 2, branch=2)
    main.add_adf("ADF2", 2, branch=3)
    return [(main, MAIN_LEN), (adf0, ADF_LEN), (adf1, ADF_LEN),
            (adf2, ADF_LEN)]


def _keys(seed, n):
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    return jax.random.split(jax.random.key(base), n)


def _gen_draws(jps, keys, S, min_d, max_d):
    """The JAX untyped generator's draws (half and half)."""

    def one(key):
        k_h, k_mode, k_scan = jax.random.split(key, 3)
        height = jax.random.randint(k_h, (), min_d, max_d + 1)
        grow = jax.random.bernoulli(k_mode, 0.5)

        def slot(k):
            k_t, k_term, k_op = jax.random.split(k, 3)
            k_c, k_v = jax.random.split(k_term)
            choice = jax.random.randint(k_c, (), 0, jps.n_terminal_choices)
            erc = jps.erc_sampler(k_v) if jps.has_erc else jnp.float32(0.0)
            op = jax.random.randint(k_op, (), 0, jps.n_ops, jnp.int32)
            return jax.random.uniform(k_t), choice, erc, op

        u, c, e, o = jax.vmap(slot)(jax.random.split(k_scan, S))
        return height, grow, u, c, e, o

    h, g, u, c, e, o = (torch.from_numpy(np.array(a))
                        for a in jax.vmap(one)(keys))
    return {"height": h, "grow": g, "u_term": u, "term_choice": c,
            "erc": e, "op_choice": o}


@functools.lru_cache(maxsize=None)
def _population(trig, seed):
    """The JAX ADF generator's population (depth 1-3) and its keys."""
    jb = build_branches(jgp, trig)
    keys = _keys(seed, N)
    pop = jax.vmap(jgp.make_adf_generator(jb, 1, 3))(keys)
    return keys, tuple({k: np.asarray(v) for k, v in b.items()} for b in pop)


def _same(got, want):
    for g, w in zip(adf_genomes_to_arrays(got), want):
        for k in ("nodes", "consts", "length"):
            assert g[k].tobytes() == np.asarray(w[k]).tobytes(), k


def _X(P=9):
    return np.linspace(-1.0, 1.0, P, endpoint=False, dtype=np.float32)[:, None]


@functools.lru_cache(maxsize=None)
def _jax_values_without_trig():
    _, pop = _population(False, 2)
    return np.asarray(jgp.make_adf_batch_interpreter(
        build_branches(jgp, False))(pop, _X()))


def test_adf_generator_core_bitwise():
    tb = build_branches(tgp, True)
    jb = build_branches(jgp, True)
    keys, want = _population(True, 1)
    gen = tgp.make_adf_generator(tb, 1, 3)
    branch_keys = jax.vmap(lambda k: jax.random.split(k, len(jb)))(keys)
    draws = tuple(
        _gen_draws(jps, branch_keys[:, b], ttree.generator_scan_len(
            jps, ml, 3), 1, 3) for b, (jps, ml) in enumerate(jb))
    _same(gen.from_draws(draws), want)
    # the operator on a torch generator: one population a branch
    pop = gen(torch.Generator().manual_seed(0), 5)
    assert [p["nodes"].shape for p in pop] == [
        (5, MAIN_LEN), (5, ADF_LEN), (5, ADF_LEN), (5, ADF_LEN)]


@pytest.mark.parametrize("specialize", ["auto", "none"])
def test_adf_batch_interpreter_bitwise_without_trig(specialize):
    """Both policies against the JAX package's ``'auto'`` (its two
    policies are bitwise equal)."""
    _, pop = _population(False, 2)
    want = _jax_values_without_trig()
    interp = tgp.make_adf_batch_interpreter(build_branches(tgp, False),
                                            specialize)
    tpop = adf_genomes_from_arrays(pop, "cpu")
    got = interp(tpop, torch.from_numpy(_X())).numpy()
    assert got.tobytes() == want.tobytes()
    # a second call (the masks only grow) gives the same values
    assert interp(tpop, torch.from_numpy(_X())).numpy().tobytes() == \
        want.tobytes()
    # the calls are live: some MAIN trees call ADFs
    main = tpop[0]
    live = torch.arange(MAIN_LEN) < main["length"][:, None]
    assert bool(((main["nodes"] >= 5) & (main["nodes"] < 8) & live).any())


def test_adf_interpreters_with_trig_within_the_stated_bound():
    _, pop = _population(True, 3)
    jb, tb = build_branches(jgp, True), build_branches(tgp, True)
    want = np.asarray(jgp.make_adf_batch_interpreter(jb)(pop, _X()))
    tpop = adf_genomes_from_arrays(pop, "cpu")
    got = tgp.make_adf_batch_interpreter(tb)(tpop,
                                             torch.from_numpy(_X())).numpy()
    fin = np.isfinite(want)
    assert np.array_equal(fin, np.isfinite(got))
    scale = np.abs(want[fin]).max()
    assert np.abs(got[fin] - want[fin]).max() <= TRIG_PROGRAM_RTOL * scale
    # one individual at a time equals the batch bit for bit
    one = tgp.make_adf_interpreter(tb)
    for r in (0, 5, 11):
        ind = tuple({k: v[r] for k, v in b.items()} for b in tpop)
        assert one(ind, torch.from_numpy(_X())).numpy().tobytes() == \
            got[r].tobytes()


def test_branch_wise_cx_bitwise():
    jb, tb = build_branches(jgp, True), build_branches(tgp, True)
    _, g1 = _population(True, 4)
    _, g2 = _population(True, 5)
    cx_keys = _keys(6, N)
    w1, w2 = jax.vmap(jgp.branch_wise_cx(
        [jgp.make_cx_one_point(ps) for ps, _ in jb]))(cx_keys, g1, g2)

    def cx_points(key, a, b):
        out = []
        for k, x, y in zip(jax.random.split(key, len(jb)), a, b):
            k1, k2 = jax.random.split(k)
            l1, l2 = x["length"], y["length"]
            out.append((
                jnp.where(l1 >= 2, jax.random.randint(
                    k1, (), 1, jnp.maximum(l1, 2)), 0),
                jnp.where(l2 >= 2, jax.random.randint(
                    k2, (), 1, jnp.maximum(l2, 2)), 0)))
        return out

    th = lambda a: torch.from_numpy(np.array(a))
    cx_ops = [functools.partial(
        lambda gen, a, b, ar, i1, i2: ttree.cx_one_point_core(ar, a, b, i1,
                                                              i2),
        ar=ps.arity_table(), i1=th(i1), i2=th(i2))
        for (ps, _), (i1, i2) in zip(tb, jax.vmap(cx_points)(cx_keys, g1,
                                                             g2))]
    c1, c2 = tgp.branch_wise_cx(cx_ops)(
        None, adf_genomes_from_arrays(g1, "cpu"),
        adf_genomes_from_arrays(g2, "cpu"))
    _same(c1, w1)
    _same(c2, w2)


def test_branch_wise_mut_applies_each_operator_to_its_branch():
    _, g = _population(True, 4)
    t = adf_genomes_from_arrays(g, "cpu")
    seen = []

    def op(k):
        def mut(gen, b):
            seen.append((k, gen, b["nodes"].shape[1]))
            return {**b, "length": b["length"] + k}
        return mut

    gen = torch.Generator().manual_seed(1)
    out = tgp.branch_wise_mut([op(k) for k in range(4)])(gen, t)
    assert [(k, w) for k, _, w in seen] == [
        (0, MAIN_LEN), (1, ADF_LEN), (2, ADF_LEN), (3, ADF_LEN)]
    assert all(s[1] is gen for s in seen)
    for k, (a, b) in enumerate(zip(out, t)):
        assert torch.equal(a["length"], b["length"] + k)
    back = adf_genomes_to_arrays(t)
    for a, b in zip(back, g):
        for key in a:
            assert a[key].tobytes() == b[key].tobytes()


def test_adf_ea_simple_runs_on_the_cpu():
    """adf_symbreg.py's program at a small size through the port's
    ea_simple: the tuple genomes flow through selection, var_and and the
    evaluation, and the best MSE does not rise."""
    tb = build_branches(tgp, True)
    X = torch.linspace(-1.0, 1.0, 20)[:-1, None]
    y = X[:, 0] ** 4 + X[:, 0] ** 3 + X[:, 0] ** 2 + X[:, 0]
    interp = tgp.make_adf_batch_interpreter(tb)
    tbx = Toolbox()
    tbx.register("evaluate", lambda gs: -((interp(gs, X) - y) ** 2).mean(-1))
    tbx.register("mate", tgp.branch_wise_cx(
        [tgp.make_cx_one_point(ps) for ps, _ in tb]))
    tbx.register("mutate", tgp.branch_wise_mut(
        [tgp.make_mut_uniform(ps, tgp.make_generator(ps, 8, 0, 2, "full"))
         for ps, _ in tb]))
    tbx.register("select", ops.sel_tournament, tournsize=3)
    g = torch.Generator().manual_seed(7)
    pop = init_population(g, 40, tgp.make_adf_generator(tb, 1, 2),
                          FitnessSpec((1.0,)), device="cpu")
    pop, logbook, hof = algorithms.ea_simple(g, pop, tbx, 0.5, 0.2, 4,
                                             halloffame_size=1, device="cpu")
    assert len(logbook) == 5 and bool(pop.valid.all())
    assert [p["nodes"].shape[1] for p in pop.genomes] == [
        MAIN_LEN, ADF_LEN, ADF_LEN, ADF_LEN]
    assert float(hof.fitness[0, 0]) >= float(pop.fitness.max()) - 1e-6


def test_adf_branches_are_validated():
    main = tgp.math_set(1, name="MAIN")
    adf = tgp.math_set(2, erc=False, name="ADF")
    adf.add_adf("BACK", 1, branch=0)
    with pytest.raises(ValueError):
        tgp.make_adf_interpreter([(main, 8), (adf, 8)])
    main2 = tgp.math_set(1, name="MAIN")
    main2.add_adf("ADF", 3, branch=1)
    with pytest.raises(ValueError):
        tgp.make_adf_batch_interpreter([(main2, 8),
                                        (tgp.math_set(2, erc=False), 8)])
    with pytest.raises(ValueError):
        main.add_adf("NONE", 0, branch=1)
    assert main2.has_adf and not tgp.math_set(1).has_adf
