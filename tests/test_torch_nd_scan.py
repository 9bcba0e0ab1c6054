"""J3 (the M = 2 staircase's row pass) and J4 (the M = 3 sweep's) on the
CPU: their plain versions against the JAX package's ``lax.scan`` engines,
numpy replays of the card kernels' order, and one ``bench_suite.py``
ZDT1 NSGA-II generation on the JAX package's draws.

- ``nd_rank_staircase`` and ``nd_rank_sweep3`` (the plain row passes on
  CPU tensors) bitwise against ``deap_tpu.mo``'s under ``jax.jit``, once
  per shape: continuous rows, ties, exact duplicates, ``-inf`` rows
  (rank n in the staircase), NaN rows (the staircase only; rank n where
  w1 is NaN), one front, a full chain (as many fronts as rows),
  ``max_rank`` and ``return_peels``.
- A numpy replay of ``csrc/nd_scan.cu::staircase_kernel``: rows in
  chunks of 32, a head's search 32 pivots a round at a stride of
  ``ceil(len / 32)`` (the ballot of pivots <= x is a prefix of the
  lanes), the front maxima split between a shared array of ``shared``
  slots and a device array past it; equal to the plain version at every
  split, with at most ``max_rounds(F)`` rounds a head (1 up to 32
  fronts, 2 up to 1,056, 3 up to 33,824).
- A numpy replay of ``sweep_kernel``: a thread a table column, reads of
  the row's state before its writes, the block max as warp maxima; equal
  to the plain version, and the tables keep within a row only the dump
  slot repeated.
- One generation of ``bench_suite.py``'s ZDT1 NSGA-II (DCD, bounded SBX
  η 20 with cxpb 0.9, polynomial η 20 with indpb 1/30 and mutpb 1.0,
  ZDT1 at 30 genes, ``sel_nsga2(nd='staircase')`` over the union) at mu
  64 on the JAX package's draws: the same parents and survivors bitwise,
  the offspring within 4 ulps of 1.0 and ZDT1 within 8 ulps (``**``,
  ``sqrt`` are another library's, as in ``test_torch_mo_ops.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import benchmarks as jbm
from deap_tpu import mo as jmo
from deap_tpu import ops as jops
from deap_tpu.algorithms import evaluate_invalid as j_evaluate_invalid
from deap_tpu.algorithms import var_and as j_var_and
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import gather as j_gather
from deap_tpu.core.population import init_population as j_init
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.mo import emo as jemo
from deap_tpu.mo import ndsort as jndsort
from deap_tpu_torch import benchmarks as tbm
from deap_tpu_torch import mo as tmo
from deap_tpu_torch.mo import emo as temo
from deap_tpu_torch.mo import ndsort as tndsort
from deap_tpu_torch.ops import crossover as tcx
from deap_tpu_torch.ops import mutation as tmut

N = 300
#: the sweep's rows: its JAX tables unroll (bit length of n)² steps, so a
#: compile costs seconds; 120 rows keep 7² of them
N_SWEEP = 120


def T(a):
    return torch.from_numpy(np.array(a))


def _rows(kind, n, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "random":
        w = rng.random((n, m))
    elif kind == "ties":           # a small grid: ties and duplicates
        w = rng.integers(0, 6, (n, m)).astype(np.float64)
    elif kind == "duplicates":     # few distinct rows, each many times
        w = rng.random((7, m))[rng.integers(0, 7, n)]
    elif kind == "neg_inf":        # invalid rows among random ones
        w = rng.random((n, m))
        w[rng.random(n) < 0.1, m - 1] = -np.inf
        w[::17] = -np.inf
    elif kind == "one_front":      # on the plane Σ w = 1: no dominance
        w = rng.random((n, m))
        w /= w.sum(1, keepdims=True)
    elif kind == "chain":          # each row dominated by the last
        w = np.repeat(-np.arange(n, dtype=np.float64)[:, None], m, 1)
        w = w[rng.permutation(n)]
    elif kind == "nan":            # NaN values and rows among random ones
        w = rng.random((n, m))
        w[rng.random(n) < 0.1, m - 1] = np.nan
        w[rng.random(n) < 0.05, 0] = np.nan
        w[::19] = np.nan
    return w.astype(np.float32)


KINDS = ["random", "ties", "duplicates", "neg_inf", "one_front", "chain",
         "nan"]
#: the JAX sweep places a NaN by a binary search over a sorted run that
#: ends in NaNs, where each compare is false: its ranks of NaN rows
#: follow that search's path, and the port's (NaN after every number, as
#: torch.searchsorted has it) are not held to them
SWEEP_KINDS = [k for k in KINDS if k != "nan"]


@functools.lru_cache(maxsize=None)
def _jit(fn, max_rank, return_peels):
    return jax.jit(lambda w: fn(w, max_rank=max_rank,
                                return_peels=return_peels))


def _check(jfn, tfn, w, max_rank=None, return_peels=False):
    want = _jit(jfn, max_rank, return_peels)(jnp.asarray(w))
    got = tfn(T(w), max_rank=max_rank, return_peels=return_peels)
    if return_peels:
        assert got[1] == int(want[1])
        got, want = got[0], want[0]
    assert got.dtype == torch.int32
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    return got


@pytest.mark.parametrize("kind", KINDS)
def test_staircase_plain_equals_jax_bitwise(kind):
    w = _rows(kind, N, 2, KINDS.index(kind))
    got = _check(jemo.nd_rank_staircase, temo.nd_rank_staircase, w)
    if kind in ("neg_inf", "nan"):     # w1 -inf or NaN: rank n
        invalid = torch.from_numpy(~(w[:, 1] > -np.inf))
        assert bool((got[invalid] == N).all()) and bool(invalid.any())
    if kind == "chain":
        assert int(got.max()) == N - 1
    if kind == "one_front":
        assert int(got.max()) == 0


@pytest.mark.parametrize("kind", SWEEP_KINDS)
def test_sweep_plain_equals_jax_bitwise(kind):
    w = _rows(kind, N_SWEEP, 3, 10 + KINDS.index(kind))
    _check(jndsort.nd_rank_sweep3, tndsort.nd_rank_sweep3, w)


@pytest.mark.parametrize("engine", ["staircase", "sweep"])
def test_max_rank_and_peels_equal_jax(engine):
    if engine == "staircase":
        w = _rows("ties", N, 2, 20)
        for max_rank, peels in ((None, True), (3, True), (3, False)):
            _check(jemo.nd_rank_staircase, temo.nd_rank_staircase, w,
                   max_rank, peels)
    else:  # one compile: the sweep's shares _finish with the staircase
        _check(jndsort.nd_rank_sweep3, tndsort.nd_rank_sweep3,
               _rows("ties", N_SWEEP, 3, 20), 3, True)


def test_small_and_empty_inputs():
    for m, fn in ((2, temo.nd_rank_staircase), (3, tndsort.nd_rank_sweep3)):
        assert fn(torch.zeros(0, m)).shape == (0,)
        assert fn(torch.zeros(0, m), return_peels=True)[1] == 0
        assert fn(torch.ones(1, m)).tolist() == [0]


# ------------------------------------------------------- J3's replay ----

def j3_replay(neg_f2, head, shared):
    """csrc/nd_scan.cu::staircase_kernel's order in numpy. Returns the
    sorted ranks, the search rounds of each head and the fronts."""
    n = neg_f2.shape[0]
    sm = np.full(shared, np.nan, np.float32)
    gm = np.full(max(n - shared, 1), np.nan, np.float32)
    lanes = np.arange(32)
    fronts, r = 0, 0
    ranks = np.empty(n, np.int32)
    rounds = []
    for base in range(0, n, 32):
        heads = head[base:base + 32]          # the chunk's ballot
        for j in range(min(32, n - base)):
            x = neg_f2[base + j]
            if heads[j]:
                if not x < np.inf:
                    r = n
                else:
                    before = fronts
                    lo, length, k_rounds = 0, fronts, 0
                    while length > 0:
                        step = (length + 31) // 32
                        p = lo + (lanes + 1) * step - 1
                        live = p < lo + length
                        pc = np.where(live, p, 0)
                        vals = np.where(pc < shared,
                                        sm[np.minimum(pc, shared - 1)],
                                        gm[np.maximum(pc - shared, 0)])
                        le = live & (vals <= x)
                        k = int(le.sum())
                        assert le[:k].all() and not le[k:].any()  # a prefix
                        lo += k * step
                        length = min(step - 1, length - k * step)
                        k_rounds += 1
                    r = lo
                    if r < shared:
                        sm[r] = x
                    else:
                        gm[r - shared] = x
                    fronts += r == fronts
                    rounds.append((k_rounds, before))
            ranks[base + j] = r
    return ranks, rounds, fronts


@pytest.mark.parametrize("kind", ["random", "ties", "neg_inf", "chain",
                                  "nan"])
def test_j3_replay_equals_plain_at_every_split(kind):
    n = 2000 if kind == "chain" else 700
    w = T(_rows(kind, n, 2, 30 + KINDS.index(kind)))
    _, neg_f2, head = temo.staircase_inputs(w)
    want = temo.staircase_rows_plain(neg_f2, head).numpy()
    fronts = int(want[want < n].max()) + 1
    for shared in sorted({1, 31, 32, 33, fronts // 2, fronts, n}):
        got, rounds, F = j3_replay(neg_f2.numpy(), head.numpy(),
                                   max(1, min(shared, n)))
        assert np.array_equal(got, want), shared
        assert F == fronts
        assert all(k <= max_rounds(f) for k, f in rounds)


def max_rounds(length):
    """The most rounds J3's search takes over ``length`` maxima."""
    return 0 if length == 0 else 1 + max_rounds((length + 31) // 32 - 1)


def test_j3_rounds_on_a_chain():
    # every head of a chain opens a front: all pivots cover it
    w = T(_rows("chain", 2000, 2, 5))
    _, neg_f2, head = temo.staircase_inputs(w)
    _, rounds, fronts = j3_replay(neg_f2.numpy(), head.numpy(), 2000)
    assert fronts == 2000
    assert all(k <= max_rounds(f) for k, f in rounds)
    by_f = {f: k for k, f in rounds}
    # a chain's search ends past the last pivot: one round while the
    # stride divides F, two otherwise, past 32 fronts
    assert [by_f[f] for f in (1, 32, 33, 64, 65, 1999)] == [1, 1, 2, 1, 2, 2]
    assert [max_rounds(f) for f in (0, 1, 32, 33, 1056, 1057, 1999)] == \
        [0, 1, 1, 2, 2, 3, 3]


def test_j3_wrapper_takes_the_plain_version_on_the_cpu():
    w = T(_rows("random", 200, 2, 3))
    before = temo.nd_rank_staircase.launches
    _, neg_f2, head = temo.staircase_inputs(w)
    assert torch.equal(temo.staircase_rows(neg_f2, head),
                       temo.staircase_rows_plain(neg_f2, head))
    assert temo.nd_rank_staircase.launches == before
    meta = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        temo.staircase_rows(meta, torch.ones(4, dtype=torch.bool,
                                             device="meta"))


# ------------------------------------------------------- J4's replay ----

def j4_replay(Q, U, head, F):
    """csrc/nd_scan.cu::sweep_kernel's order in numpy: a thread a
    column (padded to whole warps), every read of a row before its
    writes, the max as warp maxima then their max."""
    n, cols = Q.shape
    threads = -(-cols // 32) * 32
    state = np.zeros(F + 2, np.float32)
    ranks = np.empty(n, np.int32)
    r = np.float32(0)
    for i in range(n):
        q, u = Q[i], U[i]
        su = state[u].copy()
        if head[i]:
            v = np.zeros(threads, np.float32)
            v[:cols] = state[q]
            r = v.reshape(-1, 32).max(1).max()
        ranks[i] = int(r)
        state[u] = np.maximum(su, r + np.float32(1))
    return ranks


@pytest.mark.parametrize("kind", ["random", "ties", "neg_inf", "chain",
                                  "nan"])
def test_j4_replay_equals_plain(kind):
    w = T(_rows(kind, 400, 3, 40 + KINDS.index(kind)))
    _, Q, U, head, F = tndsort.sweep3_inputs(w)
    Qn, Un = Q.numpy(), U.numpy()
    # within a row only the scatter dump F repeats; Q never writes and U
    # never reads the other's dump
    for u in Un:
        real = u[u != F]
        assert np.unique(real).size == real.size
    assert not (Qn == F).any() and not (Un == F + 1).any()
    assert Qn.max() <= F + 1 and Un.max() <= F and Qn.min() >= 0
    want = tndsort.sweep3_rows_plain(Q, U, head, F).numpy()
    assert np.array_equal(j4_replay(Qn, Un, head.numpy(), F), want)


def test_j4_wrapper_takes_the_plain_version_on_the_cpu():
    w = T(_rows("random", 100, 3, 8))
    before = tndsort.nd_rank_sweep3.launches
    _, Q, U, head, F = tndsort.sweep3_inputs(w)
    assert torch.equal(tndsort.sweep3_rows(Q, U, head, F),
                       tndsort.sweep3_rows_plain(Q, U, head, F))
    assert tndsort.nd_rank_sweep3.launches == before
    with pytest.raises(ValueError):
        tndsort.sweep3_rows(Q.to("meta"), U.to("meta"), head.to("meta"), F)


# ------------------------------------ bench_suite.py's ZDT1 generation ----

MU, NDIM, CXPB, MUTPB, ETA = 64, 30, 0.9, 1.0, 20.0
GENE_TOL = 4 * float(np.finfo(np.float32).eps)


def _ulps(a, b):
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(ordered(a) - ordered(b)).max())


def _jax_toolbox():
    tb = JToolbox()
    tb.register("evaluate", jax.vmap(jbm.zdt1))
    tb.register("mate", jops.cx_simulated_binary_bounded, eta=ETA, low=0.0,
                up=1.0)
    tb.register("mutate", jops.mut_polynomial_bounded, eta=ETA, low=0.0,
                up=1.0, indpb=1.0 / NDIM)
    return tb


def _sbx_planes(k):
    kg, kr, ks = jax.random.split(k, 3)
    return (jax.random.bernoulli(kg, 0.5, (NDIM,)),
            jax.random.uniform(kr, (NDIM,)),
            jax.random.bernoulli(ks, 0.5, (NDIM,)))


def _poly_planes(k):
    km, kr = jax.random.split(k)
    return (jax.random.bernoulli(km, 1.0 / NDIM, (NDIM,)),
            jax.random.uniform(kr, (NDIM,)))


@jax.jit
def _jax_generation(k0, k1, k2):
    """The JAX package's start and step (bench_suite.py: bench_nsga2_50k's
    step), and the draws that step takes, compiled once (eager, each op
    would compile on its own)."""
    tb = _jax_toolbox()
    pop = j_init(k0, MU, jops.uniform_genome(NDIM, 0.0, 1.0),
                 JSpec((-1.0, -1.0)))
    pop = j_evaluate_invalid(pop, tb.evaluate)
    idx = jmo.sel_tournament_dcd(k1, pop.wvalues, MU)
    off = j_var_and(k2, j_gather(pop, idx), tb, CXPB, MUTPB)
    off = j_evaluate_invalid(off, tb.evaluate)
    wall = jnp.concatenate([pop.wvalues, off.wvalues])
    keep = jmo.sel_nsga2(None, wall, MU, nd="staircase")
    # DCD's draws, then var_and's unfused ones: pair gate, per-pair SBX
    # planes, row gate, per-row polynomial planes
    a1, a2, ac = jax.random.split(k1, 3)
    dcd = (jax.random.permutation(a1, MU), jax.random.permutation(a2, MU),
           jax.random.bernoulli(ac, 0.5, (MU,)))
    k_pair, k_cx, k_ind, k_mut = jax.random.split(k2, 4)
    npairs = MU // 2
    var = (jax.random.bernoulli(k_pair, CXPB, (npairs,)),
           jax.vmap(_sbx_planes)(jax.random.split(k_cx, npairs)),
           jax.random.bernoulli(k_ind, MUTPB, (MU,)),
           jax.vmap(_poly_planes)(jax.random.split(k_mut, MU)))
    return pop, idx, off, keep, dcd, var


def test_one_zdt1_generation_on_the_jax_draws():
    k1, k2 = jax.random.split(jax.random.key(7))
    pop, idx, off, keep, draws, var = _jax_generation(jax.random.key(1), k1,
                                                      k2)

    # the port on the same draws
    tw = T(pop.wvalues)
    tidx = temo._dcd_winners(tw, MU, *(T(d) for d in draws))
    assert np.array_equal(tidx.numpy(), np.asarray(idx))
    do_cx, (coin, rand, swap), do_mut, (mask, mrand) = var
    do_cx, do_mut = T(do_cx), T(do_mut)

    parents = T(pop.genomes)[tidx]
    even, odd = parents[0::2], parents[1::2]
    c1, c2 = tcx._sbx_bounded(even, odd, ETA, 0.0, 1.0, T(coin), T(rand),
                              T(swap))
    even = torch.where(do_cx[:, None], c1, even)
    odd = torch.where(do_cx[:, None], c2, odd)
    kids = torch.stack([even, odd], 1).reshape(MU, NDIM)
    mutated = tmut._polynomial_bounded(kids, ETA, 0.0, 1.0, T(mask),
                                       T(mrand))
    kids = torch.where(do_mut[:, None], mutated, kids)
    np.testing.assert_allclose(kids.numpy(), np.asarray(off.genomes),
                               rtol=0, atol=GENE_TOL)
    woff = -tbm.zdt1(T(off.genomes))
    assert _ulps(woff, off.wvalues) <= 8

    twall = torch.cat([tw, T(off.wvalues)])
    for nd in ("staircase", "standard"):
        got = tmo.sel_nsga2(None, twall, MU, nd=nd)
        assert np.array_equal(got.numpy(), np.asarray(keep)), nd
