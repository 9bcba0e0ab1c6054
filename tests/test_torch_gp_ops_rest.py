"""The rest of the untyped tree operators and ``to_graph``: the port held
bit for bit against the JAX package.

Leaf-biased crossover, node replacement, ephemeral resampling (both
modes), insertion and shrinking run through their draw-taking cores on
the JAX package's own draws, split from the same keys as the JAX
operators split them; every output must equal the vmapped JAX operator's
bit for bit (tree arithmetic is integer, constants are only moved or
taken from the draws). ``to_graph`` must give the JAX package's nodes,
edges and labels.

The JAX package's ``PrimitiveSet.arity_table`` calls
``jax.core.trace_state_clean``, which jax 0.9 moved to ``jax._src.core``;
the fixture aliases it in this test process only.
"""

import functools

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
from deap_tpu.gp import string as jstring
from deap_tpu.gp import tree as jtree
from deap_tpu_torch import gp as tgp
from deap_tpu_torch.convert import gp_genomes_from_arrays, gp_genomes_to_arrays
from deap_tpu_torch.gp import tree as ttree


@pytest.fixture(autouse=True)
def _trace_state_shim(monkeypatch):
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)


PSETS = {
    "math1": lambda m: m.math_set(1),
    "bool3": lambda m: m.bool_set(3),
}
#: each set's genome width: at 24, bool3's arity-3 trees overflow some
#: crossover and insertion children (they keep the parent)
WIDTH = {"math1": 40, "bool3": 24}
N = 48


def _psets(name):
    return PSETS[name](jgp), PSETS[name](tgp)


def _keys(seed, n):
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    return jax.random.split(jax.random.key(base), n)


def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _pop_cached(name, seed):
    jps = PSETS[name](jgp)
    gen = jtree.make_generator(jps, WIDTH[name], 0, 4, "half_and_half")
    return _np(jax.vmap(gen)(_keys(seed, N)))


def _pop(name, seed):
    """``N`` trees of the JAX package's generator (depth 0-4), shared by
    the tests (each JAX compile costs seconds)."""
    return {k: v.copy() for k, v in _pop_cached(name, seed).items()}


def _t(pop):
    return gp_genomes_from_arrays(pop, "cpu")


def _same_trees(got, want):
    got = gp_genomes_to_arrays(got)
    for k in ("nodes", "consts", "length"):
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, (k, got[k].shape, w.shape)
        assert got[k].astype(w.dtype).tobytes() == w.tobytes(), k


def _th(a):
    return torch.from_numpy(np.array(a))


def _sample_terminal(jps, key):
    """``(choice, erc)``: the draws of the JAX package's sample_terminal."""
    k_c, k_v = jax.random.split(key)
    choice = jax.random.randint(k_c, (), 0, jps.n_terminal_choices)
    erc = jps.erc_sampler(k_v) if jps.has_erc else jnp.float32(0.0)
    return choice, erc


@pytest.mark.parametrize("name", sorted(PSETS))
def test_cx_leaf_biased_core_bitwise(name):
    """termpb 0.5, so both classes and the empty-class fallback occur."""
    jps, tps = _psets(name)
    ml = WIDTH[name]
    g1, g2 = _pop(name, 1), _pop(name, 2)
    keys = _keys(3, N)
    w1, w2 = jax.vmap(jtree.make_cx_one_point_leaf_biased(jps, 0.5))(
        keys, g1, g2)

    def draws(key):
        k_b1, k_b2, k1, k2 = jax.random.split(key, 4)
        return (jax.random.bernoulli(k_b1, 0.5),
                jax.random.bernoulli(k_b2, 0.5),
                jax.random.uniform(k1, (ml,)), jax.random.uniform(k2, (ml,)))

    l1, l2, s1, s2 = (_th(a) for a in jax.vmap(draws)(keys))
    c1, c2 = ttree.cx_leaf_biased_core(tps.arity_table(), _t(g1), _t(g2),
                                       l1, l2, s1, s2)
    _same_trees(c1, _np(w1))
    _same_trees(c2, _np(w2))


@pytest.mark.parametrize("name", sorted(PSETS))
def test_mut_node_replacement_core_bitwise(name):
    jps, tps = _psets(name)
    g = _pop(name, 1)
    keys = _keys(5, N)
    want = jax.vmap(jtree.make_mut_node_replacement(jps))(keys, g)

    def draws(key, length):
        k_i, k_t, k_o = jax.random.split(key, 3)
        i = jax.random.randint(k_i, (), 0, jnp.maximum(length, 1))
        choice, erc = _sample_terminal(jps, k_t)
        return i, choice, erc, jax.random.uniform(k_o, (max(jps.n_ops, 1),))

    i, c, e, o = (_th(a) for a in jax.vmap(draws)(keys, g["length"]))
    got = ttree.mut_node_replacement_core(tps, _t(g), i, c, e, o)
    _same_trees(got, _np(want))
    # the tree keeps its shape: every node keeps its arity
    ar = np.asarray(tps.arity_list())
    assert (ar[got["nodes"].numpy()] == ar[g["nodes"]]).all()


@pytest.mark.parametrize("mode", ["one", "all"])
def test_mut_ephemeral_core_bitwise(mode):
    jps, tps = _psets("math1")
    ml = WIDTH["math1"]
    g = _pop("math1", 1)
    keys = _keys(7, N)
    want = jax.vmap(jtree.make_mut_ephemeral(jps, mode))(keys, g)

    def draws(key):
        k_pick, k_val = jax.random.split(key)
        vals = jax.vmap(jps.erc_sampler)(jax.random.split(k_val, ml))
        return jax.random.uniform(k_pick, (ml,)), vals

    pick, vals = (_th(a) for a in jax.vmap(draws)(keys))
    gt = _t(g)
    got = ttree.mut_ephemeral_core(gt, gt["nodes"] == tps.erc_id, mode, pick,
                                   vals)
    _same_trees(got, _np(want))
    changed = (got["consts"] != gt["consts"]).sum(1)
    assert int(changed.max()) >= (2 if mode == "all" else 1)
    if mode == "one":
        assert int(changed.max()) == 1


def test_mut_ephemeral_needs_an_erc():
    with pytest.raises(ValueError):
        tgp.make_mut_ephemeral(tgp.bool_set(2))
    with pytest.raises(ValueError):
        tgp.make_mut_ephemeral(tgp.math_set(1), "some")


@pytest.mark.parametrize("name", sorted(PSETS))
def test_mut_insert_core_bitwise(name):
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(9, N)
    want = jax.vmap(jtree.make_mut_insert(jps))(keys, g)
    ar_j = jps.arity_table()
    max_ar = max(jps.max_arity, 1)

    def draws(key, length):
        k_i, k_op, k_slot, k_terms = jax.random.split(key, 4)
        i = jax.random.randint(k_i, (), 0, jnp.maximum(length, 1))
        op = jps.sample_op(k_op)
        pos = jax.random.randint(k_slot, (), 0, jnp.maximum(ar_j[op], 1))
        c, e = jax.vmap(lambda k: _sample_terminal(jps, k))(
            jax.random.split(k_terms, max_ar))
        return i, op, pos, c, e

    i, op, pos, c, e = (_th(a) for a in jax.vmap(draws)(keys, g["length"]))
    t_nodes, t_vals = tps.terminal_of_choice(c.to(torch.int64), e)
    got = ttree.insert_core(tps.arity_table(), _t(g), i, op, pos, t_nodes,
                            t_vals, 1)
    _same_trees(got, _np(want))


@pytest.mark.parametrize("name", sorted(PSETS))
def test_mut_shrink_core_bitwise(name):
    """Includes trees with no operator below the root and trees shorter
    than 3 nodes (they pass through)."""
    jps, tps = _psets(name)
    g = _pop(name, 2)
    keys = _keys(11, N)
    want = jax.vmap(jtree.make_mut_shrink(jps))(keys, g)
    ar_j = jps.arity_table()

    def draws(key, nodes, length):
        k_i, k_c = jax.random.split(key)
        L = nodes.shape[0]
        in_tree = (jnp.arange(L) >= 1) & (jnp.arange(L) < length)
        is_op = (ar_j[nodes] > 0) & in_tree
        scores = jax.random.uniform(k_i, (L,))
        i = jnp.argmax(jnp.where(is_op, scores, -1.0))
        child = jax.random.randint(k_c, (), 0, jnp.maximum(ar_j[nodes][i], 1))
        return scores, child

    scores, child = (_th(a) for a in jax.vmap(draws)(keys, g["nodes"],
                                                     g["length"]))
    gt = _t(g)
    arity = tps.arity_table()
    got = ttree.shrink_core(arity, max(tps.max_arity, 1), gt,
                            ttree.shrinkable_slots(arity, gt), scores, child)
    _same_trees(got, _np(want))
    assert bool((got["length"] <= gt["length"]).all())
    assert bool((got["length"] < gt["length"]).any())


@pytest.mark.parametrize("name", ["math1", "bool3"])
def test_random_operators_keep_trees_well_formed(name):
    """The operators on a torch generator: every child is a complete
    prefix tree within its width."""
    _, tps = _psets(name)
    g = torch.Generator().manual_seed(12)
    ml = 32
    pop = tgp.gen_half_and_half(tps, ml, 1, 4)(g, 64)
    a = {k: v[:32] for k, v in pop.items()}
    b = {k: v[32:] for k, v in pop.items()}
    outs = list(tgp.make_cx_one_point_leaf_biased(tps)(g, a, b))
    outs.append(tgp.make_mut_node_replacement(tps)(g, pop))
    outs.append(tgp.make_mut_insert(tps)(g, pop))
    outs.append(tgp.make_mut_shrink(tps)(g, pop))
    if tps.has_erc:
        outs.append(tgp.make_mut_ephemeral(tps, "all")(g, pop))
    ar = tps.arity_table()
    for t in outs:
        live = torch.arange(ml) < t["length"][:, None]
        need = 1 + torch.where(live, ar[t["nodes"].long()] - 1, 0).sum(1)
        assert bool((need == 0).all())
        assert bool((t["length"] <= ml).all())


@pytest.mark.parametrize("name", ["math1", "bool3"])
def test_to_graph_matches_the_jax_package(name):
    jps, tps = _psets(name)
    pop = _pop(name, 1)
    tpop = _t(pop)
    for r in range(N):
        jg = jstring.to_graph({k: v[r] for k, v in pop.items()}, jps)
        tg = tgp.to_graph({k: v[r] for k, v in tpop.items()}, tps)
        assert tg == jg
        nodes, edges, _ = tg
        # a tree: one edge into every node but the root
        assert len(edges) == len(nodes) - 1
        assert sorted(c for _, c in edges) == list(range(1, len(nodes)))
