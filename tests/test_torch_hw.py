"""The ``prng='hw'`` paths of K2-K5 on the CPU: their plain versions (the
bits-input plain versions fed the Philox streams ``ops.philox`` expands
from a key), held to the counter layout's invariants bitwise, to the
probabilities they draw with (4 standard errors; cut points and aspirants
uniform by a chi-squared test at 1%), and, in whole runs, to the JAX
package's bits-input kernels in interpret mode in distribution (means of
the final best and average fitness over seeds within 3 standard errors:
the JAX package's own ``'hw'`` raises under the interpreter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from scipy import stats

from deap_tpu import ops as jops
from deap_tpu.ops import packed as jp
from deap_tpu.ops.kernels import fused_variation_eval as j_fused
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels as tk
from deap_tpu_torch.ops import packed as tp
from deap_tpu_torch.ops import philox

PROBS = dict(cxpb=0.5, mutpb=0.2, indpb=0.05)


def _key(seed):
    return tk.philox_key(make_generator(seed, "cpu"))


def _bools(seed, n, L):
    return torch.from_numpy(np.random.default_rng(seed).random((n, L)) < 0.5)


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------- invariants --

@pytest.mark.parametrize("n,L", [(1, 5), (2, 33), (101, 100), (256, 64),
                                 (77, 70)])
def test_k3_hw_is_k2_hw_packed(n, L):
    g, key = _bools(n, n, L), _key(n + L)
    byte = tk.fused_variation_eval(g, prng="hw", key=key, **PROBS)
    words = tp.fused_variation_eval_packed(tp.pack_genomes(g), L, prng="hw",
                                           key=key, **PROBS)
    assert _same(words[0], tp.pack_genomes(byte[0]))
    assert _same(words[1], byte[1])
    # float32 genomes take the same draws
    flt = tk.fused_variation_eval(g.float(), prng="hw", key=key, **PROBS)
    assert torch.equal(flt[0], byte[0].float()) and _same(flt[1], byte[1])


@pytest.mark.parametrize("n,L,tournsize", [(1, 100, 3), (64, 33, 2),
                                           (301, 100, 3), (120, 70, 5)])
def test_k5_hw_is_k4_hw_then_k3_hw(n, L, tournsize):
    pk = tp.pack_genomes(_bools(n, n, L))
    fit = tp.packed_fitness(pk)
    key = _key(n)
    one = tp.evolve_packed(pk, fit, L, ngen=1, tournsize=tournsize,
                           prng="hw", key=key, **PROBS)
    parents = tp.sel_tournament_gather_packed(pk, fit, prng="hw", key=key,
                                              tournsize=tournsize)
    two = tp.fused_variation_eval_packed(parents, L, prng="hw", key=key,
                                         **PROBS)
    assert _same(one[0], two[0]) and _same(one[1], two[1])
    # more generations: the same loop with the counter's g word
    W = pk.shape[1]
    got = tp.evolve_packed(pk, fit, L, ngen=4, tournsize=tournsize,
                           prng="hw", key=key, **PROBS)
    p, f = pk, fit
    for g in range(4):
        parents = tp.sel_tournament_gather_packed_plain(
            p, f, philox.hw_tournament_bits(key, tournsize, n, g))
        p, f = tp.fused_variation_eval_packed_plain(
            parents, L, *philox.hw_packed_bits(key, n, W, L, g), **PROBS)
    assert _same(got[0], p) and _same(got[1], f)


@pytest.mark.parametrize("tournsize", [1, 3, 5, 9])
def test_tournament_winners_index_the_rows_k4_gathers(tournsize):
    """``chip_smoke.tournament_winners`` (the indices the card times
    ``torch.index_select`` with, as K4-hw's floor): the rows they pick are
    the plain K4's, first-drawn winning ties, on K4-hw's streams."""
    import chip_smoke
    n, L = 257, 70
    pk = tp.pack_genomes(_bools(tournsize, n, L))
    fit = torch.from_numpy(np.random.default_rng(tournsize).integers(
        0, 4, n).astype(np.float32))  # many ties
    draws = philox.hw_tournament_bits(_key(tournsize), tournsize, n)
    winners = chip_smoke.tournament_winners(fit, draws)
    rows = torch.index_select(pk.view(torch.int32), 0, winners)
    assert _same(rows.view(torch.uint32),
                 tp.sel_tournament_gather_packed_plain(pk, fit, draws))


def test_same_key_same_result_other_key_or_generation_other_result():
    n, L = 400, 100
    g = _bools(1, n, L)
    pk = tp.pack_genomes(g)
    fit = tp.packed_fitness(pk)
    key, other = _key(1), _key(2)
    run = lambda k: tk.fused_variation_eval(g, prng="hw", key=k, **PROBS)
    assert _same(run(key)[0], run(key)[0])
    assert not torch.equal(run(key)[0], run(other)[0])
    evo = lambda k: tp.evolve_packed(pk, fit, L, ngen=3, prng="hw", key=k,
                                     **PROBS)[0]
    assert _same(evo(key), evo(key)) and not _same(evo(key), evo(other))
    sel = lambda k: tp.sel_tournament_gather_packed(pk, fit, prng="hw", key=k)
    assert _same(sel(key), sel(key)) and not _same(sel(key), sel(other))
    # generation g is a word of every counter: each stream changes with it
    for a, b in ((philox.hw_tournament_bits(key, 3, n, 0),
                  philox.hw_tournament_bits(key, 3, n, 1)),
                 (philox.hw_packed_bits(key, n, 4, L, 0)[2],
                  philox.hw_packed_bits(key, n, 4, L, 1)[2]),
                 (philox.hw_fused_bits(key, n, L, 0)[0],
                  philox.hw_fused_bits(key, n, L, 1)[0])):
        assert not _same(a, b)
    # a generator gives the same key, and the same result, from the same state
    got = [tk.fused_variation_eval(g, prng="hw", generator=make_generator(
        9, "cpu"), **PROBS)[0] for _ in range(2)]
    assert _same(got[0], got[1])


def test_both_rows_of_a_pair_take_the_even_rows_cut_points():
    n, L = 2000, 100
    g = torch.zeros((n, L), dtype=torch.bool)
    g[1::2] = True  # each pair: zeros, then ones
    children, _ = tk.fused_variation_eval(g, prng="hw", key=_key(3),
                                          cxpb=1.0, mutpb=0.0, indpb=0.0)
    even, odd = children[0::2], children[1::2]
    # the segment [lo, hi) swapped both ways: the rows stay complements
    assert torch.equal(even, ~odd)
    assert bool(even.any(1).all())  # every pair mated


# ----------------------------------------------------------------- rates --

def _within(count, total, p, se_count=4):
    se = (p * (1 - p) / total) ** 0.5
    return abs(count / total - p) <= se_count * se


def test_rates_of_mutation_flips_and_mating():
    n, L = 20000, 100
    zeros = torch.zeros((n, L), dtype=torch.bool)
    # rows that mutate: with indpb 1 a mutating row becomes all ones
    out, _ = tk.fused_variation_eval(zeros, prng="hw", key=_key(4), cxpb=0.0,
                                     mutpb=0.2, indpb=1.0)
    assert bool((out.all(1) | ~out.any(1)).all())
    assert _within(int(out.all(1).sum()), n, 0.2)
    # genes that flip in mutating rows
    out, _ = tk.fused_variation_eval(zeros, prng="hw", key=_key(5), cxpb=0.0,
                                     mutpb=1.0, indpb=0.05)
    assert _within(int(out.sum()), n * L, 0.05)
    # pairs that mate
    pairs = zeros.clone()
    pairs[1::2] = True
    out, _ = tk.fused_variation_eval(pairs, prng="hw", key=_key(6), cxpb=0.5,
                                     mutpb=0.0, indpb=0.0)
    assert _within(int(out[0::2].any(1).sum()), n // 2, 0.5)
    # the packed kernels draw the same rates from the same streams
    pk = tp.pack_genomes(zeros)
    words, fit = tp.fused_variation_eval_packed(pk, L, prng="hw", key=_key(5),
                                                cxpb=0.0, mutpb=1.0,
                                                indpb=0.05)
    assert _within(int(fit.sum()), n * L, 0.05)


def test_cut_points_are_uniform():
    n, L = 40000, 100
    pair, _, _ = philox.hw_fused_bits(_key(7), n, L)
    u = tk._u01(tk._words(pair))
    p1 = 1 + (u[:, 1] * L).to(torch.int64)
    p2 = 1 + (u[:, 2] * (L - 1)).to(torch.int64)
    for points, k in ((p1, L), (p2, L - 1)):
        counts = torch.bincount(points - 1, minlength=k).numpy()
        assert counts.shape == (k,) and counts.sum() == n
        assert stats.chisquare(counts).pvalue > 0.01


def test_aspirants_are_uniform():
    n, tournsize = 37, 3
    draws = torch.cat([philox.hw_tournament_bits(_key(8), tournsize, n, g)
                       for g in range(600)], 1)
    idx = tk._words(draws) % n
    counts = torch.bincount(idx.flatten(), minlength=n).numpy()
    assert stats.chisquare(counts).pvalue > 0.01
    # aspirant t of child c is word t % 4 of call (c, t // 4, g, 2)
    key = _key(8)
    five = philox.hw_tournament_bits(key, 5, n, 2)
    assert five.shape == (5, n)
    words = philox.draws(key, torch.arange(n)[:, None], torch.arange(2), 2,
                         philox.TOURNAMENT).reshape(n, 8)
    assert torch.equal(tk._words(five), words[:, :5].T)


def test_dead_planes_are_zero_and_never_read():
    n, L = 500, 70  # W 3: genes 70-95 of the last word are padding
    key = _key(9)
    _, _, gene = philox.hw_packed_bits(key, n, 3, L)
    planes = tk._words(gene).reshape(n, 32, 3)
    assert int(planes[:, L - 64:, 2].abs().sum()) == 0
    # a zero draw is below indpb, so a read dead plane would set a tail bit
    out, fit = tp.fused_variation_eval_packed(
        torch.zeros((n, 3), dtype=torch.uint32), L, prng="hw", key=key,
        cxpb=0.0, mutpb=1.0, indpb=0.3)
    assert int(tk._words(out)[:, 2].max()) < 2 ** (L - 64)
    assert torch.equal(fit, tp.packed_fitness(out))
    # the packed gene planes are the byte genomes' draws, rearranged
    _, _, byte = philox.hw_fused_bits(key, n, L)
    assert torch.equal(tk._words(gene).reshape(n, 32, 3).transpose(1, 2)
                       .reshape(n, 96)[:, :L], tk._words(byte))


# ------------------------------------------------------ modes and errors --

def test_auto_resolves_to_input_on_the_cpu():
    assert tk._resolve_prng("auto", torch.device("cpu")) == "input"
    assert tk._resolve_prng("auto", torch.device("cuda")) == "hw"
    g = _bools(0, 10, 20)
    gen = make_generator(0, "cpu")
    bits = tk.fused_bits(gen, 10, 20)
    got = tk.fused_variation_eval(g, *bits, prng="auto", **PROBS)
    want = tk.fused_variation_eval_plain(g, *bits, **PROBS)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    # without bits, 'auto' (the default then) is 'input' on the CPU and
    # needs them
    with pytest.raises(tk.PrngError, match="must all be passed"):
        tk.fused_variation_eval(g, generator=gen, **PROBS)
    pk = tp.pack_genomes(g)
    with pytest.raises(tk.PrngError, match="must all be passed"):
        tp.evolve_packed(pk, tp.packed_fitness(pk), 20, ngen=1, prng="auto",
                         **PROBS)
    # the loop draws the bits itself: 'auto' runs there as 'input'
    want = talg.ea_simple_packed(make_generator(2, "cpu"), pk,
                                 tp.packed_fitness(pk), 20, 2, **PROBS,
                                 device="cpu")
    got = talg.ea_simple_packed(make_generator(2, "cpu"), pk,
                                tp.packed_fitness(pk), 20, 2, **PROBS,
                                prng="auto", device="cpu")
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_hw_with_bits_and_input_without_them_raise():
    gen = make_generator(0, "cpu")
    g = _bools(1, 8, 40)
    pk = tp.pack_genomes(g)
    fit = tp.packed_fitness(pk)
    key = tk.philox_key(gen)
    fbits = tk.fused_bits(gen, 8, 40)
    vbits = tp.variation_bits(gen, 8, 2)
    draws = tp.tournament_bits(gen, 3, 8)
    ebits = tp.evolve_bits(gen, 2, 3, 8, 2)
    hw = dict(prng="hw", key=key)
    for call in (lambda: tk.fused_variation_eval(g, *fbits, **hw, **PROBS),
                 lambda: tp.fused_variation_eval_packed(pk, 40, *vbits, **hw,
                                                        **PROBS),
                 lambda: tp.sel_tournament_gather_packed(pk, fit, draws, **hw),
                 lambda: tp.evolve_packed(pk, fit, 40, *ebits, **hw,
                                          **PROBS)):
        with pytest.raises(tk.PrngError, match="takes none"):
            call()
    for call in (lambda: tk.fused_variation_eval(g, *fbits[:2], prng="input",
                                                 **PROBS),
                 lambda: tp.fused_variation_eval_packed(pk, 40, prng="input",
                                                        **PROBS),
                 lambda: tp.sel_tournament_gather_packed(pk, fit,
                                                         prng="input"),
                 lambda: tp.evolve_packed(pk, fit, 40, *ebits[:3],
                                          prng="input", **PROBS)):
        with pytest.raises(tk.PrngError, match="must all be passed"):
            call()
    with pytest.raises(tk.PrngError, match="exactly one"):
        tk.fused_variation_eval(g, prng="hw", **PROBS)
    with pytest.raises(tk.PrngError, match="exactly one"):
        tk.fused_variation_eval(g, prng="hw", key=key, generator=gen, **PROBS)
    with pytest.raises(ValueError, match="uint32"):
        tk.fused_variation_eval(g, prng="hw", key=torch.zeros(2), **PROBS)
    with pytest.raises(ValueError, match="needs ngen"):
        tp.evolve_packed(pk, fit, 40, prng="hw", key=key, **PROBS)
    with pytest.raises(ValueError, match="unknown prng"):
        tp.sel_tournament_gather_packed(pk, fit, prng="philox", key=key)


def test_ea_simple_packed_hw_equals_its_plain_composition():
    n, L = 301, 100
    start = tp.pack_genomes(_bools(2, n, L))
    fit0 = tp.packed_fitness(start)
    got = talg.ea_simple_packed(make_generator(4, "cpu"), start, fit0, L, 3,
                                **PROBS, prng="hw", device="cpu")
    gen = make_generator(4, "cpu")
    p, f = start, fit0
    for _ in range(3):
        key = tk.philox_key(gen)
        parents = tp.sel_tournament_gather_packed_plain(
            p, f, philox.hw_tournament_bits(key, 3, n))
        p, f = tp.fused_variation_eval_packed_plain(
            parents, L, *philox.hw_packed_bits(key, n, 4, L), **PROBS)
    assert _same(got[0], p) and _same(got[1], f)


# ---------------------------------------- in distribution, against JAX --

SEEDS, POP, NGEN, LEN = 6, 1024, 5, 100


def _agree(jax_fits, port_fits):
    """Final best and average fitness: means over seeds within 3 SE."""
    for reduce in (np.max, np.mean):
        a = np.array([reduce(f) for f in jax_fits])
        b = np.array([reduce(f) for f in port_fits])
        se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
        assert abs(a.mean() - b.mean()) <= 3 * se, (reduce, a, b, se)
    assert np.mean([f.mean() for f in port_fits]) > 60  # both climb from 50


def _start(s):
    bits = np.random.default_rng(700 + s).random((POP, LEN)) < 0.5
    return bits


def test_fused_hw_agrees_with_jax_in_distribution():
    def gen_step(carry, key):
        genomes, fit = carry
        k_sel, k_var = jax.random.split(key)
        idx = jops.sel_tournament(k_sel, fit[:, None], POP, tournsize=3)
        children, newfit = j_fused(k_var, genomes[idx], **PROBS,
                                   prng="input", block_i=256, interpret=True)
        return (children, newfit), None

    @jax.jit
    def run(key, genomes, fit):
        return lax.scan(gen_step, (genomes, fit),
                        jax.random.split(key, NGEN))[0][1]

    import chip_smoke
    jfits, pfits = [], []
    for s in range(SEEDS):
        g = jnp.asarray(_start(s))
        jfits.append(np.asarray(run(jax.random.key(s), g,
                                    g.sum(1).astype(jnp.float32))))
        gen = make_generator(s, "cpu")
        genomes = torch.from_numpy(_start(s))
        fit = genomes.sum(1).to(torch.float32)
        for _ in range(NGEN):
            genomes, fit = chip_smoke.fused_onemax_generation(gen, genomes,
                                                              fit, prng="hw")
        pfits.append(fit.numpy())
    _agree(jfits, pfits)


def test_packed_hw_agrees_with_jax_in_distribution():
    """``bench.py``'s ``make_run_selgather`` (K4 then K3) against
    ``ea_simple_packed(select='gather', prng='hw')``."""
    def gen_step(carry, key):
        pk, fit = carry
        k_sel, k_var = jax.random.split(key)
        parents = jp.sel_tournament_gather_packed(k_sel, pk, fit, 3,
                                                  prng="input",
                                                  interpret=True)
        return jp.fused_variation_eval_packed(
            k_var, parents, LEN, **PROBS, prng="input", block_i=256,
            interpret=True), None

    @jax.jit
    def run(key, pk, fit):
        return lax.scan(gen_step, (pk, fit), jax.random.split(key, NGEN))[0][1]

    jfits, pfits = [], []
    for s in range(SEEDS):
        pk = jp.pack_genomes(jnp.asarray(_start(s)))
        jfits.append(np.asarray(run(jax.random.key(s), pk,
                                    jp.packed_fitness(pk))))
        tpk = tp.pack_genomes(torch.from_numpy(_start(s)))
        _, fit = talg.ea_simple_packed(
            make_generator(s, "cpu"), tpk, tp.packed_fitness(tpk), LEN, NGEN,
            **PROBS, prng="hw", device="cpu")
        pfits.append(fit.numpy())
    _agree(jfits, pfits)


def test_evolve_hw_agrees_with_jax_in_distribution():
    @jax.jit
    def run(key, pk, fit):
        return jp.evolve_packed(key, pk, fit, LEN, NGEN, **PROBS,
                                prng="input", chunk=256, interpret=True)[1]

    jfits, pfits = [], []
    for s in range(SEEDS):
        pk = jp.pack_genomes(jnp.asarray(_start(s)))
        jfits.append(np.asarray(run(jax.random.key(s), pk,
                                    jp.packed_fitness(pk))))
        tpk = tp.pack_genomes(torch.from_numpy(_start(s)))
        _, fit = tp.evolve_packed(tpk, tp.packed_fitness(tpk), LEN,
                                  ngen=NGEN, prng="hw",
                                  generator=make_generator(s, "cpu"),
                                  **PROBS)
        pfits.append(fit.numpy())
    _agree(jfits, pfits)
