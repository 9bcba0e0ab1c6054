"""GP prefix trees: the port's ``gp.tree`` held bit for bit against the
JAX package's.

Populations come from the JAX package's generator on keys seeded from
numpy and cross to the port through ``convert.gp_genomes_from_arrays``.
The random operators are held through their draw-taking cores: the JAX
package's own draws (heights, grow flags and the per-slot terminal
tests, terminal choices, ERC values and op choices of the generator;
crossover's cut points; mutation's point and donor tree) are computed
from the same keys as the JAX operator splits them, handed to the port as
numpy arrays, and the outputs must then be equal bit for bit. Tolerance:
bitwise throughout — tree arithmetic is integer, and constants are only
moved.

The JAX package's ``PrimitiveSet.arity_table`` calls
``jax.core.trace_state_clean``, which jax 0.9 moved to ``jax._src.core``;
the fixture below aliases it in this test process only.
"""

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import gp as jgp
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
    "math2_notrig": lambda m: m.math_set(2, trig=False),
    "bool3": lambda m: m.bool_set(3),
}


def _psets(name):
    return PSETS[name](jgp), PSETS[name](tgp)


def _keys(seed, n):
    """``n`` JAX keys from a numpy-seeded integer."""
    base = int(np.random.default_rng(seed).integers(0, 2 ** 31))
    return jax.random.split(jax.random.key(base), n)


def _jax_pop(jps, keys, ml, min_d, max_d, mode="half_and_half"):
    gen = jtree.make_generator(jps, ml, min_d, max_d, mode)
    return {k: np.array(v) for k, v in jax.vmap(gen)(keys).items()}


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.astype(want.dtype).tobytes() == want.tobytes()


def _same_trees(got, want):
    got = gp_genomes_to_arrays(got)
    for k in ("nodes", "consts", "length"):
        _same(got[k], want[k])


def _t(pop):
    return gp_genomes_from_arrays(pop, "cpu")


# ----------------------------------------------------- tree arithmetic --

@pytest.mark.parametrize("name", sorted(PSETS))
def test_subtree_ends_depths_heights_bitwise(name):
    jps, tps = _psets(name)
    ml = 40
    pop = _jax_pop(jps, _keys(1, 96), ml, 0, 5)
    jar = jps.arity_table()
    tar = tps.arity_table()
    rng = np.random.default_rng(2)
    begin = (rng.random(96) * pop["length"]).astype(np.int32)
    je = jax.vmap(lambda n, b: jtree.subtree_end(n, jar, b))(
        pop["nodes"], begin)
    _same(ttree.subtree_end(torch.from_numpy(pop["nodes"]), tar,
                            torch.from_numpy(begin)), je)
    live = np.arange(ml)[None, :] < pop["length"][:, None]
    nodes, length = torch.from_numpy(pop["nodes"]), torch.from_numpy(
        pop["length"])
    ja = np.asarray(jax.vmap(lambda n, l: jtree.subtree_ends_all(n, l, jar))(
        pop["nodes"], pop["length"]))
    ta = tgp.subtree_ends_all(nodes, length, tar).numpy()
    # slots past the length hold garbage in both: compare the live ones
    _same(np.where(live, ta, 0), np.where(live, ja, 0).astype(ta.dtype))
    jd = np.asarray(jax.vmap(lambda n, l: jtree.prefix_depths(n, l, jar))(
        pop["nodes"], pop["length"]))
    td = tgp.prefix_depths(nodes, length, tar).numpy()
    _same(np.where(live, td, 0), np.where(live, jd, 0))
    jh = jax.vmap(lambda g: jtree.tree_height(g, jps))(pop)
    _same(tgp.tree_height(_t(pop), tps), jh)


# --------------------------------------------------------- generation --

def _gen_draws(jps, keys, S, min_d, max_d, mode):
    """The draws the JAX package's generator makes from ``keys``, split
    the way ``make_generator`` splits them."""

    def one(key):
        k_h, k_mode, k_scan = jax.random.split(key, 3)
        height = jax.random.randint(k_h, (), min_d, max_d + 1)
        grow = (jax.random.bernoulli(k_mode, 0.5) if mode == "half_and_half"
                else jnp.bool_(mode == "grow"))

        def slot(k):
            k_t, k_term, k_op = jax.random.split(k, 3)
            k_c, k_v = jax.random.split(k_term)
            choice = jax.random.randint(k_c, (), 0, jps.n_terminal_choices)
            erc = (jps.erc_sampler(k_v) if jps.has_erc
                   else jnp.float32(0.0))
            op = jax.random.randint(k_op, (), 0, jps.n_ops, jnp.int32)
            return jax.random.uniform(k_t), choice, erc, op

        u, c, e, o = jax.vmap(slot)(jax.random.split(k_scan, S))
        return height, grow, u, c, e, o

    h, g, u, c, e, o = (np.array(a) for a in jax.vmap(one)(keys))
    return {"height": h, "grow": g, "u_term": u, "term_choice": c,
            "erc": e, "op_choice": o}


@pytest.mark.parametrize("name,mode,min_d,max_d,ml", [
    ("math1", "half_and_half", 1, 2, 48),
    ("math1", "full", 0, 2, 32),
    ("math2_notrig", "grow", 0, 6, 24),   # the space guard binds
    ("bool3", "half_and_half", 2, 4, 48),
    ("bool3", "full", 3, 3, 16),          # arity 3 overflows the width
])
def test_generator_core_bitwise_with_injected_draws(name, mode, min_d, max_d,
                                                    ml):
    jps, tps = _psets(name)
    keys = _keys(sum(map(ord, name + mode)) + ml, 128)
    want = _jax_pop(jps, keys, ml, min_d, max_d, mode)
    gen = tgp.make_generator(tps, ml, min_d, max_d, mode)
    draws = _gen_draws(jps, keys, gen.scan_len, min_d, max_d, mode)
    got = gen.from_draws({k: torch.from_numpy(v) for k, v in draws.items()})
    _same_trees(got, want)


def test_generator_draws_are_shaped_for_the_core():
    tps = tgp.math_set(1)
    gen = tgp.gen_half_and_half(tps, 48, 1, 2)
    g = torch.Generator().manual_seed(0)
    pop = gen(g, 64)
    assert pop["nodes"].shape == (64, 48) and pop["length"].dtype == torch.int32
    heights = tgp.tree_height(pop, tps)
    assert int(heights.min()) >= 1 and int(heights.max()) <= 2
    # every tree is a complete prefix expression
    ar = tps.arity_table()
    live = torch.arange(48) < pop["length"][:, None]
    need = 1 + torch.where(live, ar[pop["nodes"].long()] - 1, 0).sum(1)
    assert bool((need == 0).all())


# ---------------------------------------------------------- variation --

def _cut_points(keys, len1, len2):
    """make_cx_one_point's cut points for each pair key."""

    def one(key, l1, l2):
        k1, k2 = jax.random.split(key)
        i1 = jnp.where(l1 >= 2, jax.random.randint(k1, (), 1,
                                                   jnp.maximum(l1, 2)), 0)
        i2 = jnp.where(l2 >= 2, jax.random.randint(k2, (), 1,
                                                   jnp.maximum(l2, 2)), 0)
        return i1, i2

    return (np.array(a) for a in jax.vmap(one)(keys, len1, len2))


def _pairs(jps, seed, n, ml, min_d=0, max_d=5):
    pop = _jax_pop(jps, _keys(seed, 2 * n), ml, min_d, max_d)
    g1 = {k: v[:n] for k, v in pop.items()}
    g2 = {k: v[n:] for k, v in pop.items()}
    return g1, g2


@pytest.mark.parametrize("name,ml", [("math1", 48), ("bool3", 32),
                                     ("math2_notrig", 20)])
def test_cx_one_point_core_bitwise(name, ml):
    """Includes single-terminal trees (pass through) and, at width 20,
    children that would overflow (keep the parent)."""
    jps, tps = _psets(name)
    n = 128
    g1, g2 = _pairs(jps, 5, n, ml)
    keys = _keys(6, n)
    w1, w2 = jax.vmap(jtree.make_cx_one_point(jps))(keys, g1, g2)
    i1, i2 = _cut_points(keys, g1["length"], g2["length"])
    c1, c2 = ttree.cx_one_point_core(tps.arity_table(), _t(g1), _t(g2),
                                     torch.from_numpy(i1),
                                     torch.from_numpy(i2))
    _same_trees(c1, {k: np.asarray(v) for k, v in w1.items()})
    _same_trees(c2, {k: np.asarray(v) for k, v in w2.items()})


@pytest.mark.parametrize("name,ml", [("math1", 48), ("bool3", 24)])
def test_mut_uniform_core_bitwise(name, ml):
    jps, tps = _psets(name)
    n = 128
    g = _jax_pop(jps, _keys(7, n), ml, 0, 5)
    jexpr = jtree.gen_full(jps, 16, 0, 2)
    keys = _keys(8, n)
    want = jax.vmap(jtree.make_mut_uniform(jps, jexpr))(keys, g)

    def draws(key, length):
        k_i, k_e = jax.random.split(key)
        return (jax.random.randint(k_i, (), 0, jnp.maximum(length, 1)),
                jexpr(k_e))

    i, donor = jax.vmap(draws)(keys, g["length"])
    got = ttree.mut_uniform_core(
        tps.arity_table(), _t(g), torch.from_numpy(np.asarray(i)),
        _t({k: np.asarray(v) for k, v in donor.items()}))
    _same_trees(got, {k: np.asarray(v) for k, v in want.items()})


def test_static_limit_keeps_the_parent_bitwise():
    """staticLimit around one-point crossover, Koza-style on tree height
    (limit 3 so that many children break it)."""
    jps, tps = _psets("math1")
    n = 128
    g1, g2 = _pairs(jps, 9, n, 48, 1, 4)
    keys = _keys(10, n)
    jcx = jtree.static_limit(lambda g: jtree.tree_height(g, jps), 3)(
        jtree.make_cx_one_point(jps))
    w1, w2 = jax.vmap(jcx)(keys, g1, g2)
    i1, i2 = (torch.from_numpy(a) for a in
              _cut_points(keys, g1["length"], g2["length"]))
    arity = tps.arity_table()
    tcx = tgp.static_limit(lambda g: tgp.tree_height(g, tps), 3)(
        lambda gen, a, b: ttree.cx_one_point_core(arity, a, b, i1, i2))
    c1, c2 = tcx(None, _t(g1), _t(g2))
    _same_trees(c1, {k: np.asarray(v) for k, v in w1.items()})
    _same_trees(c2, {k: np.asarray(v) for k, v in w2.items()})
    # every row is a child within the limit or its parent, and both occur
    low = tgp.tree_height(c1, tps) <= 3
    parent = (c1["nodes"] == _t(g1)["nodes"]).all(1)
    assert bool((low | parent).all())
    assert 0 < int(parent.sum()) < n


def test_random_operators_draw_on_the_generator_device():
    tps = tgp.math_set(1)
    g = torch.Generator().manual_seed(3)
    pop = tgp.gen_half_and_half(tps, 32, 1, 3)(g, 40)
    a = {k: v[:20] for k, v in pop.items()}
    b = {k: v[20:] for k, v in pop.items()}
    c1, c2 = tgp.make_cx_one_point(tps)(g, a, b)
    m = tgp.make_mut_uniform(tps, tgp.gen_full(tps, 16, 0, 2))(g, c1)
    for t in (c1, c2, m):
        ar = tps.arity_table()
        live = torch.arange(32) < t["length"][:, None]
        need = 1 + torch.where(live, ar[t["nodes"].long()] - 1, 0).sum(1)
        assert bool((need == 0).all())
    # total node count is conserved by a crossover
    assert int(c1["length"].sum() + c2["length"].sum()) == int(
        a["length"].sum() + b["length"].sum())


def test_gp_genomes_round_trip():
    jps, _ = _psets("math1")
    pop = _jax_pop(jps, _keys(11, 16), 24, 1, 3)
    back = gp_genomes_to_arrays(_t(pop))
    for k in pop:
        _same(back[k], pop[k])
