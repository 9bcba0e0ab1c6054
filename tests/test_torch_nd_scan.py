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
  chunks of 32, every lane's bucket search against the front maxima as
  the chunk found them (32 pivots, then ceil(log2(B + 1)) steps; the
  maxima split between a shared array of ``shared`` slots and a device
  array past it), the
  mask of earlier writing lanes with x <= its own, the 31-step chain, the
  head rank carried across chunks and every writer's x min-stored at its
  slot (the kernel's atomicMin); equal to the plain version on every kind
  at n 1-2000 and at several splits, those at F and 2 F among them.
- A numpy replay of ``sweep_kernel``: chunks of 32 rows (12 at 1024
  columns), each row's bit at its U slots, each head's gather of the
  chunk-start state and of the owner masks at its Q slots, the bits moved
  to their rows' heads, the chain, the carried head rank and the scatter
  in any order; equal to the plain version on every kind at n 1-2000 and
  on random tables (wide ones, and ones whose U rows are 90% real
  slots). The owner masks equal the intersection of U[i'] and Q[i] on
  every in-chunk pair, and the tables keep within a row only the dump
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
from chip_smoke import nd_random_tables
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


@pytest.mark.parametrize("kind", KINDS)
def test_sweep_plain_equals_jax_bitwise(kind):
    # every row of every kind, the NaN rows' too: both packages search the
    # sorted values with NaN as the largest value
    w = _rows(kind, N_SWEEP, 3, 10 + KINDS.index(kind))
    _check(jndsort.nd_rank_sweep3, tndsort.nd_rank_sweep3, w)


def test_sweep_ranks_rows_beside_a_nan_as_the_jax_scan():
    # a number's query bound counts only the numbers of a sorted run that
    # ends in NaN (torch.searchsorted alone counts the NaN too, and ranked
    # the last row 1)
    w = np.array([[0.26161215, np.nan, 0.81422573],
                  [0.09191594, 0.6001005, 0.7285605],
                  [0.18790108, 0.05514663, 0.27496937]], np.float32)
    got = _check(jndsort.nd_rank_sweep3, tndsort.nd_rank_sweep3, w)
    assert got.tolist() == [0, 0, 0]
    # NaN-free rows of the nan kind rank as the dominance peel ranks them
    w = T(_rows("nan", 400, 3, 2))
    clean = ~torch.isnan(w).any(1)
    assert torch.equal(tmo.nd_rank(w, impl="sweep")[clean],
                       tmo.nd_rank(w, impl="tiled")[clean])


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

#: the row counts the replays run at on every kind (a chain runs at 2000)
REPLAY_NS = (1, 31, 32, 33, 63, 64, 65, 700, 2000)


def _last_at_or_before(bits, k):
    """The highest set bit of ``bits`` at or below ``k``, or -1."""
    upto = bits & ((2 << k) - 1)
    return upto.bit_length() - 1


def order_key(x):
    """csrc/nd_scan.cu::order_key: int32 keys that order as the float32
    values do (NaN aside), -0.0 and +0.0 as one."""
    b = np.where(x == 0, np.float32(0), x).astype(np.float32).view(np.int32)
    return np.where(b >= 0, b, b ^ np.int32(0x7FFFFFFF))


def j3_search(sm, gm, shared, fronts, key):
    """A lane's search in J3: the count of the maxima neg_m[0..F) <= key
    and its dependent steps: the pivots of 32 buckets of B = ceil(F / 32)
    maxima (one load, the lanes' pivots compared by shuffles; past F the
    last maximum again), then a search of ceil(log2(B + 1)) loads from the
    first bucket whose pivot is above it, unclamped (the slots past F are
    unopened: above every key that writes). Every slot it reads lies below
    F + 2 B, in the shared array below ``shared`` and in the device array
    past it."""
    if fronts == 0:
        return 0, 0

    def max_at(q):
        assert 0 <= q < fronts + 2 * B
        return sm[q] if q < shared else gm[q - shared]

    B = -(-fronts // 32)
    pivots = [max_at(min((lane + 1) * B, fronts) - 1) for lane in range(32)]
    r = min(sum(int(p <= key) for p in pivots) * B, fronts)
    s, k = 1 << (B.bit_length() - 1), 1
    while s:
        r = r + s if max_at(r + s - 1) <= key else r
        s >>= 1
        k += 1
    return r, k


def j3_replay(neg_f2, head, shared):
    """csrc/nd_scan.cu::staircase_kernel's order in numpy: 32-row chunks;
    every lane's bucket search against the front maxima as the chunk
    found them, as order keys in ``temo.j3_slots(n)`` slots split between
    a shared array of ``shared`` and a device array past it
    (:func:`j3_search`); the mask of
    earlier writing lanes with x <= its own; the 31-step chain; non-heads
    from the last head (carried across chunks); every writer's x
    min-stored at its slot (its atomicMin on order keys: the slot keeps
    its last writer's x). Returns the sorted ranks, the dependent steps of
    each search and the fronts."""
    n = neg_f2.shape[0]
    no_front = order_key(np.float32([np.inf]))[0]
    sm = np.full(shared, no_front, np.int32)       # maxima as order keys
    gm = np.full(max(temo.j3_slots(n) - shared, 1), no_front, np.int32)
    fronts, carry = 0, 0
    ranks = np.empty(n, np.int32)
    steps = []
    for base in range(0, n, 32):
        rows = min(32, n - base)
        x = neg_f2[base:base + rows]
        key = order_key(x)
        is_head = head[base:base + rows].astype(bool)
        writes = is_head & (x < np.inf)
        r = np.zeros(rows, np.int64)
        for j in range(rows):                # each lane's search
            r[j], k = j3_search(sm, gm, shared, fronts, key[j])
            steps.append((k, fronts))
        mask = [sum(1 << k for k in range(j) if writes[k] and x[k] <= x[j])
                if writes[j] else 0 for j in range(rows)]
        any_bits = functools.reduce(lambda a, b: a | b, mask, 0)
        for k in range(min(rows, 31)):       # the chain
            if any_bits >> k & 1:
                rk = r[k]
                for j in range(rows):
                    if mask[j] >> k & 1:
                        r[j] = max(r[j], rk + 1)
        r[is_head & ~writes] = n
        heads = sum(1 << j for j in range(rows) if is_head[j])
        for j in range(rows):
            src = _last_at_or_before(heads, j)
            ranks[base + j] = r[src] if src >= 0 else carry
        if heads:
            carry = int(r[heads.bit_length() - 1])
        for j in np.flatnonzero(writes)[::-1]:   # any order: a min
            if r[j] < shared:
                sm[r[j]] = min(sm[r[j]], key[j])
            else:
                gm[r[j] - shared] = min(gm[r[j] - shared], key[j])
        if writes.any():
            fronts = max(fronts, int(r[writes].max()) + 1)
    return ranks, steps, fronts


@pytest.mark.parametrize("kind", KINDS)
def test_j3_replay_equals_plain_at_every_split(kind):
    for n in REPLAY_NS:
        w = T(_rows(kind, n, 2, 30 + n + KINDS.index(kind)))
        _, neg_f2, head = temo.staircase_inputs(w)
        want = temo.staircase_rows_plain(neg_f2, head).numpy()
        fronts = int(want[want < n].max()) + 1 if (want < n).any() else 0
        slots = temo.j3_slots(n)
        # shared == F: the write that opens front F is the first to land
        # in device memory; past F + 2 B the search reads only shared slots
        edges = (1, 33, fronts // 2, fronts, fronts + 1, 2 * fronts - 1,
                 2 * fronts, n, slots)
        for shared in sorted({min(max(e, 1), slots) for e in edges}):
            got, steps, F = j3_replay(neg_f2.numpy(), head.numpy(), shared)
            assert np.array_equal(got, want), (n, shared)
            assert F == fronts
            # a search takes 1 + ceil(log2(B + 1)) dependent steps
            assert all(k == (1 + (-(-f // 32)).bit_length() if f else 0)
                       for k, f in steps)


def test_j3_rounds_on_a_chain():
    # every head of a chain opens a front: its search passes every maximum
    # and its mask holds every earlier lane of its chunk
    w = T(_rows("chain", 2000, 2, 5))
    _, neg_f2, head = temo.staircase_inputs(w)
    got, steps, fronts = j3_replay(neg_f2.numpy(), head.numpy(), 1000)
    assert fronts == 2000 and np.array_equal(got, np.arange(2000))
    # F 0, 32 (buckets of 1), 64 (of 2), 480 (of 15), 1984 (of 62: over
    # shared and device memory)
    assert [steps[i] for i in (0, 32, 64, 480, 1984)] == [
        (0, 0), (2, 32), (3, 64), (5, 480), (7, 1984)]


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

def j4_chunk_rows(cols, smem=232_448 - 1024):
    """csrc/nd_scan.cu::sweep_chunk_rows: 32 rows a chunk where two
    stages of the chunk's Q and U rows (and two mbarriers) fit, else the
    most that do, a multiple of 4."""
    R = 32
    while R > 4 and 16 + 16 * R * cols > smem:
        R -= 4
    return R


def j4_remap(mask, heads):
    """The chain warp's move of each bit of ``mask`` down to its row's head
    (a segmented doubling), and whether one lies before the chunk's first
    head (``carry``'s row)."""
    full = 0xFFFFFFFF
    down, s = ~heads & full, 1
    while s < 32:
        mask |= (mask & down) >> s
        down &= (down << s) & full
        s <<= 1
    first = ((heads & -heads) - 1) & full
    return mask & heads, bool(mask & first)


def _owner_masks(U, F, base, rows):
    """Each slot's owner mask of the chunk's rows (bit i: row base + i
    writes there), as the kernel's atomicOr leaves it."""
    owner = {}
    for i in range(rows):
        for u in U[base + i]:
            if u != F:
                owner[u] = owner.get(u, 0) | 1 << i
    return owner


def j4_replay(Q, U, head, F, R=None):
    """csrc/nd_scan.cu::sweep_kernel's order in numpy: chunks of R rows;
    every row's bit in the owner mask beside each of its U slots; each
    head's max over its Q slots of the state as the chunk found it and the
    OR of their owner masks (only the earlier rows'); each mask's bits
    moved to their rows' heads, a bit before the first head a bound carry
    + 1; the chain over heads; every row's r + 1 scatter-maxed at its U
    slots. Returns the sorted ranks."""
    n, cols = Q.shape
    R = R or j4_chunk_rows(cols)
    state = np.zeros(F, np.int64)
    ranks = np.empty(n, np.int32)
    carry = 0
    for base in range(0, n, R):
        rows = min(R, n - base)
        owner = _owner_masks(U, F, base, rows)
        is_head = head[base:base + rows].astype(bool)
        r = np.zeros(rows, np.int64)
        mask = [0] * rows
        for i in np.flatnonzero(is_head):
            q = Q[base + i]
            q = q[q != F + 1]
            r[i] = state[q].max(initial=0)
            m = functools.reduce(lambda a, s: a | owner.get(s, 0), q, 0)
            mask[i] = m & ((1 << i) - 1)
        heads = sum(1 << i for i in range(rows) if is_head[i])
        for i in range(rows):
            mask[i], before_first = j4_remap(mask[i], heads)
            if before_first:
                r[i] = max(r[i], carry + 1)
        any_bits = functools.reduce(lambda a, b: a | b, mask, 0)
        for k in range(31):                  # the chain, over heads
            if any_bits >> k & 1:
                rk = r[k]
                for i in range(rows):
                    if mask[i] >> k & 1:
                        r[i] = max(r[i], rk + 1)
        mine = np.empty(rows, np.int64)
        for i in range(rows):
            src = _last_at_or_before(heads, i)
            mine[i] = r[src] if src >= 0 else carry
        if heads:
            carry = int(r[heads.bit_length() - 1])
        ranks[base:base + rows] = mine
        for i in range(rows):                # the scatter, in any order
            u = U[base + i]
            u = u[u != F]
            np.maximum.at(state, u, mine[i] + 1)
    return ranks


def _sweep_tables(kind, n, seed):
    w = T(_rows(kind, n, 3, seed))
    _, Q, U, head, F = tndsort.sweep3_inputs(w)
    return Q, U, head, F


@pytest.mark.parametrize("kind", KINDS)
def test_j4_replay_equals_plain(kind):
    for n in REPLAY_NS:
        Q, U, head, F = _sweep_tables(kind, n, 40 + n + KINDS.index(kind))
        Qn, Un = Q.numpy(), U.numpy()
        # within a row only the scatter dump F repeats; Q never writes and
        # U never reads the other's dump
        for u in Un:
            real = u[u != F]
            assert np.unique(real).size == real.size
        assert not (Qn == F).any() and not (Un == F + 1).any()
        assert Qn.max() <= F + 1 and Un.max() <= F and Qn.min() >= 0
        want = tndsort.sweep3_rows_plain(Q, U, head, F).numpy()
        got = j4_replay(Qn, Un, head.numpy(), F)
        assert np.array_equal(got, want), n
    # the chunks the kernel takes past 2^21 rows (1024 columns: 12 rows)
    assert (j4_chunk_rows(289), j4_chunk_rows(441), j4_chunk_rows(484),
            j4_chunk_rows(1024)) == (32, 32, 28, 12)
    assert np.array_equal(j4_replay(Qn, Un, head.numpy(), F, R=12), want)


@pytest.mark.parametrize("cols,u_valid", [(484, 0.1), (1024, 0.1),
                                          (289, 0.9)])
def test_j4_replay_on_random_tables(cols, u_valid):
    Q, U, head = nd_random_tables(torch, "cpu", 300, cols, 3000, u_valid,
                                  cols)
    want = tndsort.sweep3_rows_plain(Q, U, head, 3000).numpy()
    got = j4_replay(Q.numpy(), U.numpy(), head.numpy(), 3000)
    assert np.array_equal(got, want) and int(want.max()) > 10


@pytest.mark.parametrize("kind", KINDS)
def test_j4_relation_is_the_table_intersection(kind):
    # the owner masks say row i' of a chunk writes at a slot that row i
    # gathers exactly where U[i'] and Q[i] share a slot (dumps aside), on
    # every in-chunk pair
    for n in (65, 700):
        Q, U, head, F = _sweep_tables(kind, n, 50 + KINDS.index(kind))
        Qn, Un = Q.numpy(), U.numpy()
        R = j4_chunk_rows(Qn.shape[1])
        pairs = 0
        for base in range(0, n, R):
            rows = min(R, n - base)
            owner = _owner_masks(Un, F, base, rows)
            for i in range(rows):
                q = Qn[base + i]
                m = functools.reduce(lambda a, s: a | owner.get(s, 0),
                                     q[q != F + 1], 0)
                want = set(q[q != F + 1])
                for k in range(i):
                    u = Un[base + k]
                    meets = bool(want & set(u[u != F]))
                    assert bool(m >> k & 1) == meets, (n, base, k, i)
                    pairs += meets
        # on one front no earlier row's writes reach a later row's gather
        assert (pairs == 0) == (kind == "one_front"), pairs


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
