"""K1 ``fused_variation`` and K8 ``dominated_weight_maxes`` at the shapes
their card designs branch on, held bit for bit against the JAX
package's kernels on the CPU, and the pure-Python rules that plan their
launches.

K1's units (4 genes where ``L % 4 == 0``, else 1; rows of more than 32
units) and K8's blocks (R queries a thread, 128 threads a block, the
rows of ``w`` split in 32-row chunks, a generic kernel for m > 8) show
only on the card, where ``tests/test_torch_k1_k8_cuda.py`` holds them
against the plain versions; here the plain versions (what the wrappers
run on CPU tensors) meet the JAX package's Pallas kernels, run in
interpret mode, on the same numpy inputs at those shapes. Tolerance:
bitwise. K1 computes selects and IEEE adds only; K8 takes a maximum,
exact in any order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from deap_tpu.ops import kernels as jk
from deap_tpu.ops import variation as jv
from deap_tpu_torch.ops import kernels as tk
from deap_tpu_torch.ops import variation as tv


@pytest.fixture(autouse=True)
def _pallas_compiler_params(monkeypatch):
    """The JAX package's K1 wrapper names ``pltpu.TPUCompilerParams``,
    which jax 0.9 renamed ``CompilerParams``; alias it in this test
    process only (the JAX package itself is not edited)."""
    if not hasattr(pltpu, "TPUCompilerParams"):
        monkeypatch.setattr(pltpu, "TPUCompilerParams", pltpu.CompilerParams,
                            raising=False)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


# ------------------------------------------------------ K1 fused_variation --

def _k1_inputs(seed, n, N, L, dtype, kind, cxpb, mutpb):
    """n children of N parents: 0/1 genomes, random parents, segments drawn
    in [0, L] (``lo > hi`` among them) with ``lo = 0``, ``hi = L`` and
    ``lo == hi`` forced on every 5th/7th/9th row, a mask of density 0.3,
    and for add/set normal arguments with zeros (and, on bool genomes,
    -1s, so that ``x + arg`` reaches 0)."""
    rng = np.random.default_rng(seed)
    g = rng.random((N, L)) < 0.5
    g = g if dtype == "bool" else g.astype(np.float32)
    src = rng.integers(0, N, n).astype(np.int32)
    partner = rng.integers(0, N, n).astype(np.int32)
    cx = rng.random(n) < cxpb
    lo = rng.integers(0, L + 1, n).astype(np.int32)
    hi = rng.integers(0, L + 1, n).astype(np.int32)
    lo[::5] = 0
    hi[::7] = L
    hi[::9] = lo[::9]
    mut = rng.random(n) < mutpb
    mask = rng.random((n, L)) < 0.3
    arg = None
    if kind != "flip":
        arg = rng.normal(size=(n, L)).astype(np.float32)
        arg[rng.random((n, L)) < 0.2] = 0.0
        arg[rng.random((n, L)) < 0.1] = -1.0
    return g, src, partner, cx, lo, hi, mut, mask, arg


@pytest.mark.parametrize("L", [1, 3, 4, 5, 100, 101])
@pytest.mark.parametrize("dtype", ["bool", "float32"])
@pytest.mark.parametrize("kind", ["flip", "add", "set"])
def test_k1_plain_equals_jax_kernel_at_the_unit_shapes(L, dtype, kind):
    """Odd n above, below and equal to N, at every L the card's units
    branch on, each probability at 0, 1 and between."""
    seed = L * 100 + len(dtype) * 10 + len(kind)
    for n, N, cxpb, mutpb in ((37, 37, 0.7, 0.6), (21, 8, 1.0, 1.0),
                              (5, 40, 0.0, 1.0), (9, 9, 1.0, 0.0),
                              (1, 3, 0.0, 0.0)):
        g, src, partner, cx, lo, hi, mut, mask, arg = _k1_inputs(
            seed + n, n, N, L, dtype, kind, cxpb, mutpb)
        want = jk.fused_variation(
            jnp.asarray(g), jnp.asarray(src), jnp.asarray(partner),
            jnp.asarray(cx), jnp.asarray(lo), jnp.asarray(hi),
            jnp.asarray(mut), jnp.asarray(mask),
            None if arg is None else jnp.asarray(arg), mut_kind=kind,
            block_i=16, interpret=True)
        targ = None if arg is None else T(arg)
        args = (T(g), T(src), T(partner), T(cx), T(lo), T(hi), T(mut),
                T(mask), targ)
        assert_bitwise(tk.fused_variation(*args, mut_kind=kind), want)
        assert_bitwise(tv.apply_variation(*args, kind).to(args[0].dtype),
                       want)


def test_k1_jax_apply_agrees_on_empty_and_whole_segments():
    """``lo == hi``, ``lo = 0``, ``hi = L`` and ``lo > hi`` rows through
    the JAX package's plain apply too (the segment is empty or the whole
    row)."""
    L, n = 100, 45
    g, src, partner, cx, lo, hi, mut, mask, _ = _k1_inputs(
        5, n, n, L, "bool", "flip", 1.0, 0.5)
    lo[:9], hi[:9] = [0, 0, 5, 50, 100, 0, 100, 70, 3], \
        [0, 100, 5, 50, 100, 1, 99, 30, 2]
    want = jv.apply_variation(jnp.asarray(g), jnp.asarray(src),
                              jnp.asarray(partner), jnp.asarray(cx),
                              jnp.asarray(lo), jnp.asarray(hi),
                              jnp.asarray(mut), jnp.asarray(mask), None,
                              "flip")
    got = tv.apply_variation(T(g), T(src), T(partner), T(cx), T(lo), T(hi),
                             T(mut), T(mask), None, "flip")
    assert_bitwise(got, want)


def _k1_walk(n, L, width, sms, units_in_flight):
    """K1's walk as csrc/fused_variation.cu makes it: for each warp (a
    batch of 32 rows and a slice of their flattened run) and lane, the
    (row, unit) of each unit it takes, stepping by 32 units with the
    kernel's divide-free update, and the run index the kernel's mask,
    argument and output offsets use."""
    slices, per = tk._k1_plan(n, L, width, sms)
    U = L // width
    qstep, rstep = 32 // U, 32 - (32 // U) * U
    for warp in range(-(-n // tk._K1_ROWS) * slices):
        batch, piece = divmod(warp, slices)
        r0 = batch * tk._K1_ROWS
        nb = min(tk._K1_ROWS, n - r0)
        kbeg = piece * per
        kend = min(kbeg + per, nb * U)
        for lane in range(32):
            k = kbeg + lane
            row, u = divmod(k, U)
            for kw in range(kbeg, kend, 32 * units_in_flight):
                for d in range(units_in_flight):
                    k = kw + 32 * d + lane
                    if k < kend:
                        yield r0 + row, u, r0 * L + k * width
                    u += rstep
                    row += qstep
                    if u >= U:
                        u -= U
                        row += 1


@pytest.mark.parametrize("n,L,width", [
    (1, 1, 1), (1, 4, 4), (2, 4, 1), (33, 3, 1), (31, 100, 4), (65, 101, 1),
    (97, 132, 4), (40, 256, 4), (3, 2100, 1), (1, 10_000, 4), (70, 4096, 4)])
def test_k1_walk_takes_each_unit_once(n, L, width):
    """Every unit of every row exactly once, at the offset of its row and
    unit, for runs of one unit to many slices."""
    U = L // width
    for sms, units_in_flight in ((132, 2), (132, 1), (1, 2)):
        seen = np.zeros((n, U), dtype=np.int64)
        for row, u, offset in _k1_walk(n, L, width, sms, units_in_flight):
            assert 0 <= row < n and 0 <= u < U
            assert offset == row * L + u * width
            seen[row, u] += 1
        assert (seen == 1).all()


@pytest.mark.parametrize("sms", [1, 8, 132])
def test_k1_plan_fills_one_wave_and_covers_the_batch(sms):
    """Slices cover each batch's run, none empty, a warp takes at least a
    unit a lane, and the grid stays within one wave of
    ``_K1_WARPS_PER_SM`` warps an SM unless the rows alone fill more."""
    for n in (1, 5, 31, 32, 33, 1001, 50_000, 100_000):
        for L in (1, 3, 100, 101, 2048, 10_000):
            for width in ((1, 4) if L % 4 == 0 else (1,)):
                slices, per = tk._k1_plan(n, L, width, sms)
                run = min(n, tk._K1_ROWS) * (L // width)
                assert slices >= 1 and per >= 1
                assert slices * per >= run > (slices - 1) * per
                assert per >= min(32, run)
                batches = -(-n // tk._K1_ROWS)
                if slices > 1:
                    assert batches * slices <= tk._K1_WARPS_PER_SM * sms
    # ea_simple's shape on 132 SMs: two warps a batch of 32 rows, 6250
    # warps, one wave of at most 48 an SM
    assert tk._k1_plan(100_000, 100, 4, 132) == (2, 400)


def test_k1_width_needs_whole_words_and_aligned_tensors():
    g = torch.zeros((8, 100), dtype=torch.bool)
    f = torch.zeros((8, 100))
    mask = torch.zeros((8, 100), dtype=torch.bool)
    assert tk._k1_width(100, 1, g, g, mask, None) == 4
    assert tk._k1_width(100, 4, f, f, mask, f) == 4
    assert tk._k1_width(101, 1, g, g, mask, None) == 1
    flat = torch.zeros(801, dtype=torch.bool)
    assert tk._k1_width(100, 1, flat[1:].view(8, 100), g, mask, None) == 1
    flatf = torch.zeros(801)
    off = flatf[1:].view(8, 100)
    assert tk._k1_width(100, 4, off, f, mask, f) == 1
    assert tk._k1_width(100, 4, f, f, mask, off) == 1
    flatm = torch.zeros(802, dtype=torch.bool)
    assert tk._k1_width(100, 1, g, g, flatm[2:].view(8, 100), None) == 1


# ------------------------------------------------ K8 dominated_weight_maxes --

def _k8_inputs(seed, n, nq, m, zero_weights=False):
    """Integer grid values (ties) for even seeds, normal ones for odd
    seeds, each with -inf, NaN and duplicated rows; queries drawn from
    the rows and from fresh values; integer weights 0-5 (or all 0)."""
    rng = np.random.default_rng(seed)

    def values(k):
        if seed % 2 == 0:
            v = rng.integers(0, 4, (k, m)).astype(np.float32)
        else:
            v = rng.normal(size=(k, m)).astype(np.float32)
        if k > 4:
            v[rng.integers(0, k, k // 3)] = v[rng.integers(0, k, k // 3)]
            v[rng.random(k) < 0.05] = -np.inf
            v[rng.random(k) < 0.03] = np.nan
        return v

    w = values(n)
    weights = rng.integers(0, 6, n).astype(np.float32)
    if zero_weights:
        weights[:] = 0.0
    queries = np.concatenate([w, values(nq)])[rng.integers(0, n + nq, nq)]
    return w, weights, queries


@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 32])
@pytest.mark.parametrize("n,nq", [(33, 1), (257, 3), (600, 513)])
def test_k8_plain_equals_jax_kernel_at_the_block_shapes(m, n, nq):
    """Fewer queries than a thread holds, queries not a multiple of a
    block's, rows not a multiple of a split's chunk or of the tile, in
    each of the card's kernels (m 1-4, 5-8 and the generic 9-32), with
    all-zero weights too."""
    for seed, zero in ((n + m, False), (n + m + 1, False), (n + m, True)):
        w, weights, queries = _k8_inputs(seed, n, nq, m, zero)
        want = jk.dominated_weight_maxes(jnp.asarray(w), jnp.asarray(weights),
                                         jnp.asarray(queries),
                                         interpret=True)
        assert_bitwise(tk.dominated_weight_maxes(T(w), T(weights),
                                                 T(queries)), want)
        if zero:
            assert not np.asarray(want).any()


@pytest.mark.parametrize("m", [1, 3, 5, 8, 9, 32])
def test_k8_rows_per_thread_follow_the_kernels(m):
    """4 query rows a thread at m <= 4, 2 at m 5-8, 1 in the generic
    kernel; a block of 128 threads holds the prefix reduction's 512
    queries at m <= 4."""
    r = tk._k8_rows_per_thread(m)
    assert r == (4 if m <= 4 else 2 if m <= 8 else 1)
    if m <= 4:
        assert tk._DOM_THREADS * r == 512


@pytest.mark.parametrize("sms", [1, 8, 132])
@pytest.mark.parametrize("m", [1, 3, 5, 9, 32])
def test_k8_split_choice(sms, m):
    """K8's split of the rows: between 1 and the chunks, a count the
    launcher takes (no empty range), and at the prefix reduction's
    shapes (512 queries against 16k or 50k rows) a few blocks per SM."""
    for n in (1, 31, 32, 33, 512, 1001, 16_384, 50_000, 100_000):
        for nq in (1, 3, 512, 513, 2048):
            s = tk._k8_splits(n, nq, m, sms)
            chunks = -(-n // tk._K8_SPLIT_ROWS)
            assert 1 <= s <= chunks
            per = -(-chunks // s)
            assert -(-chunks // per) == s
            assert (s - 1) * per < chunks  # the last range holds a chunk
            blocks = -(-nq // (tk._DOM_THREADS * tk._k8_rows_per_thread(m)))
            if n >= 16_384 and nq == 512 and sms == 132:
                assert blocks * s >= 2 * sms

