"""K7 ``dominated_weight_sums`` and K8 ``dominated_weight_maxes`` held bit
for bit against the JAX package's Pallas kernels, on the CPU.

The JAX kernels run in interpret mode; the port's wrappers take their
plain versions for CPU tensors. Both get the same numpy inputs: integer
grids (exact ties), duplicated rows, rows of -inf (invalid individuals),
NaN rows, sign-mixed objectives, and integer-valued weights of both
signs. Tolerance: bitwise. Sums of integer-valued weights below 2**24
are exact in any order, and a maximum is exact in any order, so the
kernels' different summation orders cannot show.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import mo as jmo
from deap_tpu.ops import kernels as jk
from deap_tpu_torch import mo as tmo
from deap_tpu_torch.ops import kernels as tk


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes()


def fitness_set(seed, n, m, nan=False):
    """Weighted values with every tie structure the kernels must keep."""
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        w = rng.integers(0, 4, (n, m)).astype(np.float32)
    elif kind == 1:
        w = rng.normal(size=(n, m)).astype(np.float32)
    else:
        signs = rng.choice([-1.0, 1.0], m).astype(np.float32)
        w = rng.integers(0, 3, (n, m)).astype(np.float32) * signs
    if n > 4:
        w[rng.integers(0, n, n // 3)] = w[rng.integers(0, n, n // 3)]
        w[rng.random(n) < 0.05] = -np.inf
        if nan:
            w[rng.random(n) < 0.03] = np.nan
    return w


SHAPES = [(1, 3), (2, 1), (37, 2), (257, 3), (600, 5), (1024, 3)]


@pytest.mark.parametrize("n,m", SHAPES)
def test_k7_sums_equal_jax_kernel(n, m):
    w = fitness_set(n + m, n, m, nan=True)
    rng = np.random.default_rng(n)
    for weights in (rng.random(n) < 0.6,
                    rng.integers(-3, 4, n).astype(np.float32)):
        want = jk.dominated_weight_sums(jnp.asarray(w), jnp.asarray(weights),
                                        interpret=True)
        assert_bitwise(tk.dominated_weight_sums(T(w), T(weights)), want)
        assert_bitwise(tk.dominated_weight_sums_plain(T(w), T(weights),
                                                      chunk=7), want)
    want = jk.dominated_counts(jnp.asarray(w), jnp.asarray(weights > 0),
                               interpret=True)
    assert_bitwise(tk.dominated_counts(T(w), T(weights > 0)), want)
    assert_bitwise(tk.strengths_tiled(T(w)),
                   jk.strengths_tiled(jnp.asarray(w), interpret=True))


@pytest.mark.parametrize("n,m", SHAPES)
def test_k8_maxes_equal_jax_kernel(n, m):
    w = fitness_set(2 * n + m, n, m, nan=True)
    rng = np.random.default_rng(n + 1)
    weights = rng.integers(0, 6, n).astype(np.float32)
    nq = max(1, n // 2 + 3)
    queries = np.concatenate([w, fitness_set(n + 5, n, m)])[
        rng.integers(0, 2 * n, nq)]
    want = jk.dominated_weight_maxes(jnp.asarray(w), jnp.asarray(weights),
                                     jnp.asarray(queries), interpret=True)
    assert_bitwise(tk.dominated_weight_maxes(T(w), T(weights), T(queries)),
                   want)
    assert_bitwise(tk.dominated_weight_maxes_plain(T(w), T(weights),
                                                   T(queries), chunk=5), want)
    # queries default to w
    want = jk.dominated_weight_maxes(jnp.asarray(w), jnp.asarray(weights),
                                     interpret=True)
    assert_bitwise(tk.dominated_weight_maxes(T(w), T(weights)), want)


def test_k8_without_rows_is_the_zero_identity():
    q = torch.ones((3, 2))
    out = tk.dominated_weight_maxes(torch.zeros((0, 2)), torch.zeros(0), q)
    assert torch.equal(out, torch.zeros(3))


def _near_ordered(n, seed=7):
    """~n fronts: the peel loop's worst case."""
    base = np.arange(n, dtype=np.float32)
    jitter = 0.01 * np.random.default_rng(seed).normal(size=n)
    return np.stack([base, base + jitter.astype(np.float32)], axis=1)


@pytest.mark.parametrize("case", ["near_ordered", "grid3", "signed5"])
def test_nd_rank_tiled_equals_jax_kernel(case):
    w = {"near_ordered": lambda: _near_ordered(96),
         "grid3": lambda: fitness_set(0, 201, 3),
         "signed5": lambda: fitness_set(2, 150, 5)}[case]()
    n = w.shape[0]
    J, W = jnp.asarray(w), T(w)
    runs = [dict(), dict(max_fronts=3), dict(cover_k=n // 4),
            dict(max_fronts=4, fallback="count"),
            dict(max_fronts=2, cover_k=n // 2, fallback="count")]
    for kw in runs:
        want, want_peels = jk.nd_rank_tiled(J, interpret=True,
                                            return_peels=True, **kw)
        got, peels = tk.nd_rank_tiled(W, return_peels=True, **kw)
        assert_bitwise(got, want)
        assert peels == int(want_peels), kw
    # the oracle: the tiled peel ranks as the dominance-matrix peel
    assert_bitwise(tk.nd_rank_tiled(W), jmo.nd_rank(J, impl="matrix"))


def test_nd_rank_tiled_rejects_unknown_fallback():
    with pytest.raises(ValueError, match="fallback"):
        tk.nd_rank_tiled(torch.zeros((4, 2)), fallback="guess")


@pytest.mark.parametrize("n,m", [(64, 2), (300, 3), (257, 5)])
def test_spea2_fitness_stream_equals_jax(n, m):
    w = fitness_set(n, n, m)
    want_s, want_r = jmo.spea2_fitness_stream(jnp.asarray(w))
    got_s, got_r = tmo.spea2_fitness_stream(T(w))
    assert_bitwise(got_s, want_s)
    assert_bitwise(got_r, want_r)


def test_dominance_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="objectives"):
        tk._dominance_inputs("k", torch.zeros((3, 33)), torch.zeros(3))
    with pytest.raises(ValueError, match="shape"):
        tk._dominance_inputs("k", torch.zeros((3, 2)), torch.zeros(4))
    with pytest.raises(ValueError, match="no kernel"):
        tk.dominated_weight_sums(torch.zeros((3, 2), device="meta"),
                                 torch.zeros(3, device="meta"))


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("m", [1, 3, 5, 9, 32])
def test_k7_split_choice(sms, m):
    """K7's split of j: between 1 and min(tiles, the scratch cap), a count
    the launcher takes (no empty range), and at the NSGA-II path's sizes
    several blocks per SM."""
    for n in (1, 2, 129, 255, 256, 257, 1001, 8192, 50_000, 100_000):
        s = tk._k7_splits(n, m, sms)
        tiles = -(-n // tk._DOM_TILE)
        assert 1 <= s <= min(tiles, tk._K7_MAX_SPLITS)
        per = -(-tiles // s)
        assert -(-tiles // per) == s
        assert (s - 1) * per < tiles  # the last range holds a tile
        if n >= 50_000 and sms == 132 and m <= 8:
            rows = tk._DOM_THREADS * tk._k7_rows_per_thread(m)
            assert -(-n // rows) * s >= 16 * sms


@pytest.mark.parametrize("seed,n,m", [(0, 300, 3), (1, 257, 2), (2, 1001, 5),
                                      (3, 129, 1), (4, 700, 9)])
def test_k7_prune_limits_keep_every_dominator(seed, n, m):
    """K7 compares a block of queries only against the rows of its prune
    limit in its sorted order: every dominator of every query lies there
    (ties, duplicates, -inf and NaN rows included)."""
    w = fitness_set(seed, n, m, nan=True)
    w[:4, 0] = [-0.0, 0.0, -0.0, 0.0]     # equal in IEEE, not in bits
    if m > 1:
        w[n // 2, m - 1] = np.nan         # a NaN in one objective only
    w = T(w)
    for rows in (128, 512, 1024):
        order, limit = tk._k7_order(w, rows)
        ws = w[order]
        dom = tk._dominators(ws, ws)          # [query, row], sorted order
        pos = torch.arange(n)
        for b in range(limit.shape[0]):
            q = dom[b * rows:(b + 1) * rows]
            assert not bool((q & (pos >= int(limit[b]))).any())
        assert int(limit[-1]) <= n and bool((limit[1:] >= limit[:-1]).all())


@pytest.mark.parametrize("n,rows", [(1, 128), (300, 1), (300, 128),
                                    (1001, 512), (1001, 1024)])
def test_k7_pairs_counts_each_block_up_to_its_limit(n, rows):
    """``chip_smoke.k7_pairs``, the pair count of K7's bound: with
    distinct values in objective 0 a block's limit is the rows up to its
    last query, so block b of ``size_b`` queries compares
    ``size_b * min(n, (b + 1) * rows)`` pairs (one query per block:
    n (n + 1) / 2; one block: n²)."""
    import chip_smoke
    rng = np.random.default_rng(n + rows)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:, 0] = rng.permutation(n)
    blocks = -(-n // rows)
    want = sum(min(rows, n - b * rows) * min(n, (b + 1) * rows)
               for b in range(blocks))
    assert chip_smoke.k7_pairs(tk, T(w), rows) == want
