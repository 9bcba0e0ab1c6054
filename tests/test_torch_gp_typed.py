"""Strongly typed GP: the port's ``gp.typed`` held bit for bit against the
JAX package's, and typed trees through K9's plain version.

- The typed generator's core on the JAX package's draws (height, grow
  flag, and per slot the terminal test, terminal scores, one value of
  each ERC pool and operator scores, split from the same keys as
  ``make_generator_typed`` splits them), with the set's return type and
  with a per-tree return type (the donors of typed subtree mutation).
- Typed crossover and the five typed mutations on the JAX operators'
  draws. Tolerance: bitwise (tree arithmetic is integer; constants are
  moved or taken from the draws).
- ``spam_set`` trees evaluate through the grouped mode (K9's plain
  version, ``lt`` and ``eq`` live) and the scan mode bit for bit like the
  JAX package's interpreter: each element is one IEEE operation, a
  comparison or a select. The data are integers in [0, 4), so ``eq``
  holds often.

Sets: ``spam_set(3)``, and for the generator, node replacement and
ephemeral resampling also a set with an ERC pool of each of two types.
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
from deap_tpu.gp import typed as jtyped
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import gp_genomes_from_arrays, gp_genomes_to_arrays
from deap_tpu_torch.gp import tree as ttree
from deap_tpu_torch.gp import typed as ttyped


@pytest.fixture(autouse=True)
def _trace_state_shim(monkeypatch):
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)


def _two_pools(m, torch_side):
    """A typed set with an ERC pool of each of two types (and an integer
    type with no operator returning it)."""
    ps = m.PrimitiveSetTyped("TWO", ["float", "int"], "float")
    ps.add_primitive(lambda a, b: a + b, ["float", "float"], "float", "add")
    ps.add_primitive(lambda a, b: a * b, ["float", "int"], "float", "scale")
    ps.add_primitive(lambda a: -a, ["float"], "float", "neg")
    ps.add_terminal(2.0, "int", "two")
    if torch_side:
        ps.add_ephemeral_constant(
            "u", lambda g, s: torch.rand(s, generator=g), "float")
        ps.add_ephemeral_constant(
            "k", lambda g, s: torch.rand(s, generator=g) * 9, "int")
    else:
        ps.add_ephemeral_constant(
            "u", lambda k: jax.random.uniform(k, ()), "float")
        ps.add_ephemeral_constant(
            "k", lambda k: jax.random.uniform(k, (), maxval=9.0), "int")
    return ps


PSETS = {
    "spam3": lambda m, t: m.spam_set(3),
    "two_pools": _two_pools,
}
ML, N = 48, 40


def _psets(name):
    return PSETS[name](jgp, False), PSETS[name](tgp, True)


def _keys(seed, n):
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    return jax.random.split(jax.random.key(base), n)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _th(a):
    return torch.from_numpy(np.array(a))


def _t(pop):
    return gp_genomes_from_arrays(pop, "cpu")


def _same_trees(got, want):
    got = gp_genomes_to_arrays(got)
    for k in ("nodes", "consts", "length"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        assert got[k].astype(w.dtype).tobytes() == w.tobytes(), k


def _terminal_draws(jps, key):
    """The draws of ``sample_terminal_typed``: scores over the terminal
    choices and one value of each ERC pool."""
    k_c, k_v = jax.random.split(key)
    scores = jax.random.uniform(k_c, (max(jps.n_terminal_choices, 1),))
    ercs = jnp.stack([s(jax.random.fold_in(k_v, j))
                      for j, (_, s, _) in enumerate(jps.erc_entries)]) \
        if jps.erc_entries else jnp.zeros((0,))
    return scores, jnp.asarray(ercs, jnp.float32)


def _gen_draws(jps, keys, S, min_d, max_d, mode="half_and_half"):
    """The JAX typed generator's draws from ``keys``."""
    n_o = max(jps.n_ops, 1)

    def one(key):
        k_h, k_mode, k_scan = jax.random.split(key, 3)
        height = jax.random.randint(k_h, (), min_d, max_d + 1)
        grow = (jax.random.bernoulli(k_mode, 0.5) if mode == "half_and_half"
                else jnp.bool_(mode == "grow"))

        def slot(k):
            k_t, k_term, k_op = jax.random.split(k, 3)
            ts, te = _terminal_draws(jps, k_term)
            return (jax.random.uniform(k_t), ts, te,
                    jax.random.uniform(k_op, (n_o,)))

        u, ts, te, ops = jax.vmap(slot)(jax.random.split(k_scan, S))
        return height, grow, u, ts, te, ops

    h, g, u, ts, te, ops = (_th(a) for a in jax.vmap(one)(keys))
    return {"height": h, "grow": g, "u_term": u, "term_scores": ts,
            "erc": te, "op_scores": ops}


@functools.lru_cache(maxsize=None)
def _pop_cached(name, seed):
    jps, _ = _psets(name)
    gen = jtyped.make_generator_typed(jps, ML, 1, 4)
    return _np(jax.vmap(gen)(_keys(seed, N)))


def _pop(name, seed):
    return {k: v.copy() for k, v in _pop_cached(name, seed).items()}


# ------------------------------------------------------------ generator --

@pytest.mark.parametrize("name", sorted(PSETS))
def test_typed_generator_core_bitwise(name):
    jps, tps = _psets(name)
    keys = _keys(1, N)
    want = _pop(name, 1)  # the JAX generator on these keys
    gen = tgp.make_generator_typed(tps, ML, 1, 4)
    got = gen.from_draws(_gen_draws(jps, keys, gen.scan_len, 1, 4))
    _same_trees(got, want)
    # well typed: every operand's return type is its argument's type
    rett = tps.ret_type_table()
    nodes = got["nodes"].long()
    assert bool((rett[nodes[:, 0]] == tps.ret).all())


@pytest.mark.parametrize("name", ["spam3"])
def test_mut_uniform_typed_bitwise(name):
    """The donors come from the typed generator's core with a per-tree
    return type (the replaced subtree's)."""
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(3, N)
    jexpr = jtyped.make_generator_typed(jps, 16, 0, 2, "full")
    want = _np(jax.vmap(jtyped.make_mut_uniform_typed(jps, jexpr))(keys, g))
    rett_j = jps.ret_type_table()

    def split(key, nodes, length):
        k_i, k_e = jax.random.split(key)
        i = jax.random.randint(k_i, (), 0, jnp.maximum(length, 1))
        return i, k_e, rett_j[nodes[i]]

    i, k_e, ret = jax.vmap(split)(keys, g["nodes"], g["length"])
    texpr = tgp.make_generator_typed(tps, 16, 0, 2, "full")
    draws = _gen_draws(jps, k_e, texpr.scan_len, 0, 2, "full")
    donor = texpr.from_draws(draws, ret_type=_th(ret).long())
    got = ttree.mut_uniform_core(tps.arity_table(), _t(g), _th(i), donor)
    _same_trees(got, want)


# ---------------------------------------------------------- variation --

@pytest.mark.parametrize("name", ["spam3"])
def test_cx_one_point_typed_core_bitwise(name):
    jps, tps = _psets(name)
    g1, g2 = _pop(name, 2), _pop(name, 4)
    keys = _keys(5, N)
    w1, w2 = jax.vmap(jtyped.make_cx_one_point_typed(jps))(keys, g1, g2)

    def draws(key):
        k1, k2 = jax.random.split(key)
        return jax.random.uniform(k1, (ML,)), jax.random.uniform(k2, (ML,))

    s1, s2 = (_th(a) for a in jax.vmap(draws)(keys))
    c1, c2 = ttyped.cx_one_point_typed_core(tps, _t(g1), _t(g2), s1, s2)
    _same_trees(c1, _np(w1))
    _same_trees(c2, _np(w2))


@pytest.mark.parametrize("name", sorted(PSETS))
def test_mut_node_replacement_typed_core_bitwise(name):
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(6, N)
    want = jax.vmap(jtyped.make_mut_node_replacement_typed(jps))(keys, g)

    def draws(key, length):
        k_i, k_t, k_o = jax.random.split(key, 3)
        i = jax.random.randint(k_i, (), 0, jnp.maximum(length, 1))
        ts, te = _terminal_draws(jps, k_t)
        return i, ts, te, jax.random.uniform(k_o, (max(jps.n_ops, 1),))

    i, ts, te, ops = (_th(a) for a in jax.vmap(draws)(keys, g["length"]))
    got = ttyped.mut_node_replacement_typed_core(tps, _t(g), i, ts, te, ops)
    _same_trees(got, _np(want))


@pytest.mark.parametrize("name,mode", [("spam3", "one"),
                                       ("two_pools", "one"),
                                       ("two_pools", "all")])
def test_mut_ephemeral_typed_core_bitwise(name, mode):
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(7, N)
    want = jax.vmap(jtyped.make_mut_ephemeral_typed(jps, mode))(keys, g)

    def draws(key):
        k_pick, k_val = jax.random.split(key)
        pools = jnp.stack([
            jax.vmap(s)(jax.random.split(jax.random.fold_in(k_val, j), ML))
            for j, (_, s, _) in enumerate(jps.erc_entries)])
        return jax.random.uniform(k_pick, (ML,)), pools

    pick, pools = (_th(a) for a in jax.vmap(draws)(keys))
    gt = _t(g)
    got = ttree.mut_ephemeral_core(
        gt, gt["nodes"] >= tps.erc_id, mode, pick,
        ttyped.ephemeral_values_typed(tps, gt, pools))
    _same_trees(got, _np(want))


@pytest.mark.parametrize("name", ["spam3"])
def test_mut_insert_typed_core_bitwise(name):
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(8, N)
    want = jax.vmap(jtyped.make_mut_insert_typed(jps))(keys, g)
    max_ar = max(jps.max_arity, 1)
    n_o = max(jps.n_ops, 1)

    def draws(key, length):
        k_i, k_op, k_slot, k_terms = jax.random.split(key, 4)
        i = jax.random.randint(k_i, (), 0, jnp.maximum(length, 1))
        ts, te = jax.vmap(lambda j: _terminal_draws(
            jps, jax.random.fold_in(k_terms, j)))(jnp.arange(max_ar))
        return (i, jax.random.uniform(k_op, (n_o,)),
                jax.random.uniform(k_slot, (max_ar,)), ts, te)

    i, ops, slots, ts, te = (_th(a) for a in
                             jax.vmap(draws)(keys, g["length"]))
    got = ttyped.mut_insert_typed_core(tps, _t(g), i, ops, slots, ts, te)
    _same_trees(got, _np(want))


@pytest.mark.parametrize("name", ["spam3"])
def test_mut_shrink_typed_core_bitwise(name):
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(9, N)
    want = jax.vmap(jtyped.make_mut_shrink_typed(jps))(keys, g)
    max_ar = max(jps.max_arity, 1)

    def draws(key):
        k_i, k_c = jax.random.split(key)
        return (jax.random.uniform(k_i, (ML,)),
                jax.random.uniform(k_c, (max_ar,)))

    scores, child = (_th(a) for a in jax.vmap(draws)(keys))
    got = ttyped.mut_shrink_typed_core(tps, _t(g), scores, child)
    _same_trees(got, _np(want))
    assert bool((got["length"] < _t(g)["length"]).any())


def test_typed_operators_keep_trees_well_typed():
    """The operators on a torch generator: every child is a complete
    prefix tree whose every operand returns its argument's type."""
    tps = tgp.spam_set(3)
    g = torch.Generator().manual_seed(10)
    pop = tgp.make_generator_typed(tps, ML, 1, 4)(g, 64)
    a = {k: v[:32] for k, v in pop.items()}
    b = {k: v[32:] for k, v in pop.items()}
    expr = tgp.make_generator_typed(tps, 16, 0, 2, "full")
    outs = list(tgp.make_cx_one_point_typed(tps)(g, a, b))
    outs += [tgp.make_mut_uniform_typed(tps, expr)(g, pop),
             tgp.make_mut_node_replacement_typed(tps)(g, pop),
             tgp.make_mut_ephemeral_typed(tps, "all")(g, pop),
             tgp.make_mut_insert_typed(tps)(g, pop),
             tgp.make_mut_shrink_typed(tps)(g, pop)]
    rett = tps.ret_type_table().tolist()
    arg_types = tps.arg_type_table().tolist()
    ar = tps.arity_list()
    for t in outs:
        for nodes, length in zip(t["nodes"].tolist(), t["length"].tolist()):
            # walk the prefix with a stack of required types
            need = [tps.ret]
            for node in nodes[:length]:
                assert need and rett[node] == need.pop()
                need += reversed(arg_types[node][:ar[node]]) \
                    if ar[node] else []
            assert not need


def test_validate_refuses_a_type_without_terminal():
    ps = tgp.PrimitiveSetTyped("BAD", ["float"], "float")
    ps.add_primitive(lambda a: a, ["str"], "float", "f")
    with pytest.raises(ValueError):
        tgp.make_generator_typed(ps, 16, 1, 2)
    with pytest.raises(TypeError):
        ps.add_adf("ADF", ["float"], "float")


# --------------------------------------------------- evaluation (K9) --

def test_spam_trees_through_k9_plain_equal_the_jax_interpreter():
    jps, tps = _psets("spam3")
    pop = {k: np.concatenate([_pop("spam3", 2)[k], _pop("spam3", 4)[k]])
           for k in ("nodes", "consts", "length")}
    rng = np.random.default_rng(11)
    X = np.floor(rng.random((37, 3)) * 4).astype(np.float32)
    want = np.asarray(jgp.make_batch_interpreter(jps, ML)(pop, X))
    trees = _t(pop)
    assert {"lt", "eq"} <= _used_names(tps, trees)
    for mode in ("grouped", "scan"):
        interp = tgp.make_batch_interpreter(tps, ML, mode=mode)
        got = interp(trees, torch.from_numpy(X)).numpy()
        assert got.tobytes() == want.tobytes(), mode
    assert {0.0, 1.0} <= set(np.unique(want).tolist())


def _used_names(pset, trees):
    live = torch.arange(trees["nodes"].shape[1]) < trees["length"][:, None]
    ids = trees["nodes"][live]
    return {pset.primitives[i].name for i in ids[ids < pset.n_ops].tolist()}


def test_gp_all_contains_every_name_of_the_jax_package():
    assert set(jgp.__all__) <= set(tgp.__all__)
    for name in tgp.__all__:
        assert hasattr(tgp, name), name
    for alias in ("genFull", "genGrow", "genHalfAndHalf", "staticLimit"):
        assert getattr(tgp, alias) is getattr(tgp, {
            "genFull": "gen_full", "genGrow": "gen_grow",
            "genHalfAndHalf": "gen_half_and_half",
            "staticLimit": "static_limit"}[alias])
