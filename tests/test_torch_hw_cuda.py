"""The Philox (``prng='hw'``) paths of K2-K5 against their plain
versions, on the card.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one:

    python -m pytest tests/test_torch_hw_cuda.py -m cuda -q --noconftest

Each Philox path is held bitwise against its bits-input plain version fed
the streams :mod:`deap_tpu_torch.ops.philox` expands from the same key, at
small odd shapes; the device function against Random123's known answers;
the layout's invariants; and the launch counters (``launches`` and
``hw_launches``, one each per call).
"""

import pytest
import torch

from deap_tpu_torch import algorithms
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels, kernels_real, packed, philox

pytestmark = pytest.mark.cuda

PROBS = dict(cxpb=0.6, mutpb=0.5, indpb=0.1)
KAT = (((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                0x9B00DBD8)),
       ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("library", ["fused_variation_eval",
                                     "packed_variation", "selgather_packed",
                                     "evolve_packed"])
def test_device_philox_gives_the_known_answers(card, library):
    u32 = torch.uint32
    ctr = torch.tensor([c for c, _, _ in KAT]).to(u32).to(card)
    key = torch.tensor([k for _, k, _ in KAT]).to(u32).to(card)
    want = torch.tensor([o for _, _, o in KAT]).to(u32).to(card)
    assert _same(kernels.philox_kat(ctr, key, library), want)
    gen = make_generator(3, card)
    rc = torch.randint(0, 2**32, (999, 4), generator=gen, device=card)
    rk = torch.randint(0, 2**32, (999, 2), generator=gen, device=card)
    assert _same(kernels.philox_kat(rc.to(u32), rk.to(u32), library),
                 philox.philox4x32_10(rc, rk).to(u32))


@pytest.mark.parametrize("n,L", [(1, 8), (2, 33), (65, 100), (1001, 31),
                                 (1000, 64)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
def test_k2_hw_equals_plain(card, n, L, dtype):
    gen = make_generator(n + L, card)
    g = (torch.rand((n, L), generator=gen, device=card) < 0.5).to(dtype)
    key = kernels.philox_key(gen)
    fn = kernels.fused_variation_eval
    before = (fn.launches, fn.hw_launches, fn.vector_launches)
    got = fn(g, prng="hw", key=key, **PROBS)
    want = kernels.fused_variation_eval_plain(
        g, *philox.hw_fused_bits(key, n, L), **PROBS)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.hw_launches - before[1],
            fn.vector_launches - before[2]) == (1, 1, int(L % 4 == 0))
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("n,L", [(1, 100), (2, 33), (65, 32), (1001, 100),
                                 (257, 70)])
def test_k3_k4_hw_equal_plain_and_k2(card, n, L):
    gen = make_generator(n, card)
    bools = torch.rand((n, L), generator=gen, device=card) < 0.5
    pk = packed.pack_genomes(bools)
    W = pk.shape[1]
    key = kernels.philox_key(gen)
    k3, k4 = packed.fused_variation_eval_packed, packed.sel_tournament_gather_packed
    before = (k3.hw_launches, k4.hw_launches)
    got = k3(pk, L, prng="hw", key=key, **PROBS)
    want = packed.fused_variation_eval_packed_plain(
        pk, L, *philox.hw_packed_bits(key, n, W, L), **PROBS)
    byte = kernels.fused_variation_eval(bools, prng="hw", key=key, **PROBS)
    fit = packed.packed_fitness(pk)
    sel = k4(pk, fit, prng="hw", key=key, tournsize=5)
    sel_want = packed.sel_tournament_gather_packed_plain(
        pk, fit, philox.hw_tournament_bits(key, 5, n))
    torch.cuda.synchronize()
    assert (k3.hw_launches - before[0], k4.hw_launches - before[1]) == (1, 1)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(got[0], packed.pack_genomes(byte[0]))
    assert _same(got[1], byte[1])
    assert _same(sel, sel_want)


def _k3_hw_case(card, n, L, probs):
    """K3-hw against its plain version and against pack_genomes of K2-hw
    with the same key."""
    gen = make_generator(n + 7 * L, card)
    bools = torch.rand((n, L), generator=gen, device=card) < 0.5
    pk = packed.pack_genomes(bools)
    key = kernels.philox_key(gen)
    k3 = packed.fused_variation_eval_packed
    before = (k3.launches, k3.hw_launches)
    got = k3(pk, L, prng="hw", key=key, **probs)
    want = packed.fused_variation_eval_packed_plain(
        pk, L, *philox.hw_packed_bits(key, n, pk.shape[1], L), **probs)
    byte = kernels.fused_variation_eval(bools, prng="hw", key=key, **probs)
    torch.cuda.synchronize()
    assert (k3.launches - before[0], k3.hw_launches - before[1]) == (1, 1)
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(got[0], packed.pack_genomes(byte[0]))
    assert _same(got[1], byte[1])


@pytest.mark.parametrize("L", [2, 31, 33, 100, 257, 300])
@pytest.mark.parametrize("n", [1, 3, 255, 257, 1001, 100_000])
def test_k3_hw_tiles_equal_plain_and_k2(card, n, L):
    """K3-hw's tiles of 256 rows: a partial tile, an odd last row, one and
    two flip-word chunks (W > 8 from L 257)."""
    _k3_hw_case(card, n, L, PROBS)


@pytest.mark.parametrize("mutpb", [0.0, 1.0])
@pytest.mark.parametrize("n,L", [(257, 33), (1001, 300)])
def test_k3_hw_mutation_edges_equal_plain(card, n, L, mutpb):
    """No row mutates (an empty work list), or every row does."""
    _k3_hw_case(card, n, L, dict(PROBS, mutpb=mutpb))


@pytest.mark.parametrize("n,L,ngen,tournsize", [(1, 100, 2, 3),
                                                (201, 33, 3, 2),
                                                (1000, 100, 4, 5)])
def test_k5_hw_equals_plain_and_k4_then_k3(card, n, L, ngen, tournsize):
    gen = make_generator(n + ngen, card)
    pk = packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                             < 0.5)
    fit = packed.packed_fitness(pk)
    key = kernels.philox_key(gen)
    before = packed.evolve_packed.hw_launches
    got = packed.evolve_packed(pk, fit, L, ngen=ngen, tournsize=tournsize,
                               prng="hw", key=key, **PROBS)
    want = packed.evolve_packed_plain(
        pk, fit, L, *philox.hw_evolve_bits(key, ngen, tournsize, n, L),
        **PROBS)
    one = packed.evolve_packed(pk, fit, L, ngen=1, tournsize=tournsize,
                               prng="hw", key=key, **PROBS)
    parents = packed.sel_tournament_gather_packed(
        pk, fit, prng="hw", key=key, tournsize=tournsize)
    two = packed.fused_variation_eval_packed(parents, L, prng="hw", key=key,
                                             **PROBS)
    torch.cuda.synchronize()
    assert packed.evolve_packed.hw_launches == before + 2
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(one[0], two[0]) and _same(one[1], two[1])


def test_auto_is_hw_on_the_card_and_refuses_bits(card):
    gen = make_generator(5, card)
    g = torch.zeros((6, 8), dtype=torch.bool, device=card)
    before = kernels.fused_variation_eval.hw_launches
    kernels.fused_variation_eval(g, generator=gen, **PROBS)
    kernels.fused_variation_eval(g, prng="auto", generator=gen, **PROBS)
    assert kernels.fused_variation_eval.hw_launches == before + 2
    with pytest.raises(kernels.PrngError, match="Philox"):
        kernels.fused_variation_eval(g, *kernels.fused_bits(gen, 6, 8),
                                     prng="auto", **PROBS)
    with pytest.raises(ValueError, match="generator lives on"):
        kernels.fused_variation_eval(g, prng="hw",
                                     generator=make_generator(0, "cpu"),
                                     **PROBS)


@pytest.mark.parametrize("select", ["gather", "sorted", "binned"])
def test_ea_simple_packed_hw_counts_its_philox_launches(card, select):
    gen = make_generator(11, card)
    pk = packed.pack_genomes(torch.rand((301, 100), generator=gen,
                                        device=card) < 0.5)
    k3, k4 = packed.fused_variation_eval_packed, packed.sel_tournament_gather_packed
    before = (k3.hw_launches, k4.hw_launches)
    out, fit = algorithms.ea_simple_packed(
        gen, pk, packed.packed_fitness(pk), 100, 4, select=select,
        prng="auto", cxpb=0.5, mutpb=0.2, indpb=0.05, device=card)
    torch.cuda.synchronize()
    assert (k3.hw_launches - before[0], k4.hw_launches - before[1]) == (
        4, 4 if select == "gather" else 0)
    assert torch.equal(fit, packed.packed_fitness(out))


# ------------------------- the edges of K2-hw's and K5-hw's layouts ----

@pytest.mark.parametrize("n,L", [(1, 4), (3, 4), (1001, 4), (1, 100),
                                 (1001, 200), (999, 300), (257, 1000),
                                 (4097, 100)])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
def test_k2_hw_vector_edges_equal_plain(card, n, L, dtype):
    """The vector variant (a warp per pair): one word a row, more words
    than lanes (two slots a lane, two or more chunks), one row, odd n;
    fitness bitwise, and one key twice equal."""
    gen = make_generator(7 * n + L, card)
    g = (torch.rand((n, L), generator=gen, device=card) < 0.5).to(dtype)
    key = kernels.philox_key(gen)
    fn = kernels.fused_variation_eval
    before = fn.vector_launches
    got = fn(g, prng="hw", key=key, **PROBS)
    want = kernels.fused_variation_eval_plain(
        g, *philox.hw_fused_bits(key, n, L), **PROBS)
    again = fn(g, prng="hw", key=key, **PROBS)
    torch.cuda.synchronize()
    assert fn.vector_launches == before + 2
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(got[0], again[0]) and _same(got[1], again[1])


@pytest.mark.parametrize("n,L,ngen,tournsize", [(1, 100, 3, 3),
                                                (3, 100, 3, 3),
                                                (1, 33, 2, 5),
                                                (3, 70, 3, 5),
                                                (1001, 70, 3, 5),
                                                (2049, 300, 2, 3),
                                                (777, 256, 2, 9),
                                                (4099, 33, 4, 3)])
def test_k5_hw_edges_equal_plain_and_k4_then_k3(card, n, L, ngen, tournsize):
    """The tile's work list: a ragged last word, more flip words than one
    chunk (L 300), several tournament calls, one pair, an odd lane and a
    last tile part full."""
    gen = make_generator(3 * n + L, card)
    pk = packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                             < 0.5)
    fit = packed.packed_fitness(pk)
    key = kernels.philox_key(gen)
    got = packed.evolve_packed(pk, fit, L, ngen=ngen, tournsize=tournsize,
                               prng="hw", key=key, **PROBS)
    want = packed.evolve_packed_plain(
        pk, fit, L, *philox.hw_evolve_bits(key, ngen, tournsize, n, L),
        **PROBS)
    one = packed.evolve_packed(pk, fit, L, ngen=1, tournsize=tournsize,
                               prng="hw", key=key, **PROBS)
    parents = packed.sel_tournament_gather_packed(
        pk, fit, prng="hw", key=key, tournsize=tournsize)
    two = packed.fused_variation_eval_packed(parents, L, prng="hw", key=key,
                                             **PROBS)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(one[0], two[0]) and _same(one[1], two[1])


def test_k5_hw_grid_and_barrier_entries(card):
    """K5-hw's grid: a block a tile of 256 children, every tile resident
    up to the card's capacity; its barrier-only launch runs."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for n in (1, 1001, 100_000, 10 ** 6):
        blocks, per_sm, tiles = packed._k5_hw_grid(n)
        assert tiles == -(-n // 256)
        assert per_sm >= 1 and blocks == min(tiles, per_sm * sms)
    assert packed._k5_hw_grid(1)[0] == 1
    key = kernels.philox_key(make_generator(1, card))
    packed._k5_hw_barrier(key, 100_000, 5)
    packed._k5_hw_barrier(key, 100_000, 0)
    torch.cuda.synchronize()


# ------------------------------------------------- K6's Philox path ----

def test_k6_library_philox_gives_the_known_answers(card):
    u32 = torch.uint32
    ctr = torch.tensor([c for c, _, _ in KAT]).to(u32).to(card)
    key = torch.tensor([k for _, k, _ in KAT]).to(u32).to(card)
    want = torch.tensor([o for _, _, o in KAT]).to(u32).to(card)
    assert _same(kernels.philox_kat(ctr, key, "fused_variation_real"), want)


@pytest.mark.parametrize("n,L,evaluate", [(1, 30, "rastrigin"),
                                          (2, 5, "sphere"),
                                          (129, 30, "rastrigin"),
                                          (1001, 40, "sphere"),
                                          (1001, 30, "rastrigin")])
def test_k6_hw_equals_plain_on_the_philox_streams(card, n, L, evaluate):
    """Crossed and untouched genes bitwise, mutated genes and fitness at
    K6's tolerance (``kernels_real.real_kernel_errors``)."""
    gen = make_generator(n + L, card)
    g = torch.rand((n, L), generator=gen, device=card) * 10.24 - 5.12
    key = kernels.philox_key(gen)
    kw = dict(cxpb=0.7, mutpb=0.6, indpb=0.3, alpha=0.3, mu=0.1, sigma=0.3,
              evaluate=evaluate)
    fn = kernels_real.fused_variation_eval_real
    before = (fn.launches, fn.hw_launches)
    got = fn(g, prng="hw", key=key, **kw)
    bits = philox.hw_real_bits(key, n, L)
    want = kernels_real.fused_variation_eval_real_plain(g, *bits, **kw)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.hw_launches - before[1]) == (1, 1)
    errs = kernels_real.real_kernel_errors(got, want, *bits, mutpb=0.6,
                                           indpb=0.3, mu=0.1, sigma=0.3)
    assert errs["ok"], errs
    again = fn(g, prng="hw", key=key, **kw)
    assert _same(got[0], again[0]) and _same(got[1], again[1])


def test_k6_auto_is_hw_on_the_card(card):
    gen = make_generator(5, card)
    g = torch.rand((64, 30), generator=gen, device=card)
    fn = kernels_real.fused_variation_eval_real
    kw = dict(cxpb=0.5, mutpb=0.2, indpb=0.1)
    before = fn.hw_launches
    fn(g, generator=gen, **kw)
    fn(g, prng="auto", generator=gen, **kw)
    assert fn.hw_launches == before + 2
    with pytest.raises(kernels.PrngError, match="Philox"):
        fn(g, *kernels_real.real_bits(gen, 64, 30), prng="auto", **kw)


# ------------------------------------- K6-hw's tiles and K4's row copy ----

def _k6_hw_case(card, n, L, kw, evaluate="rastrigin"):
    """K6-hw against its plain version on ``hw_real_bits`` (crossed and
    untouched genes bitwise, the rest at ``real_kernel_errors``), against
    K6's bits body fed the same streams (bitwise, children and fitness:
    one arithmetic and one sum order), and one key twice bitwise."""
    gen = make_generator(5 * n + L, card)
    g = torch.rand((n, L), generator=gen, device=card) * 10.24 - 5.12
    key = kernels.philox_key(gen)
    kw = dict(kw, evaluate=evaluate)
    fn = kernels_real.fused_variation_eval_real
    before = (fn.launches, fn.hw_launches)
    got = fn(g, prng="hw", key=key, **kw)
    bits = philox.hw_real_bits(key, n, L)
    want = kernels_real.fused_variation_eval_real_plain(g, *bits, **kw)
    body = fn(g, *bits, **kw)
    again = fn(g, prng="hw", key=key, **kw)
    torch.cuda.synchronize()
    assert (fn.launches - before[0], fn.hw_launches - before[1]) == (3, 2)
    errs = kernels_real.real_kernel_errors(
        got, want, *bits, mutpb=kw["mutpb"], indpb=kw["indpb"], mu=kw["mu"],
        sigma=kw["sigma"])
    assert errs["ok"], errs
    assert _same(got[0], body[0]) and _same(got[1], body[1])
    assert _same(got[0], again[0]) and _same(got[1], again[1])


K6_PROBS = dict(cxpb=0.6, mutpb=0.5, indpb=0.3, alpha=0.4, mu=0.05,
                sigma=0.3)


@pytest.mark.parametrize("L", [1, 4, 30, 31, 33, 64, 100])
@pytest.mark.parametrize("n", [1, 2, 3, 63, 64, 65, 127, 128, 129, 255,
                               257, 1001, 100_000])
def test_k6_hw_tiles_equal_plain_and_bits_body(card, n, L):
    """K6-hw's tiles of 64 rows: a partial tile, an odd last row, n below
    a tile, one column chunk (L <= 32) and several (L 33-100)."""
    _k6_hw_case(card, n, L, K6_PROBS, ("rastrigin", "sphere")[(n + L) % 2])


@pytest.mark.parametrize("value", [0.0, 1.0])
@pytest.mark.parametrize("prob", ["cxpb", "mutpb", "indpb"])
@pytest.mark.parametrize("n,L", [(257, 30), (1001, 70)])
def test_k6_hw_probability_edges_equal_plain(card, n, L, prob, value):
    """No pair mates, no row mutates or no gene is gated (empty lists), or
    every one is (every gene of a mutating row on the gated list)."""
    _k6_hw_case(card, n, L, dict(K6_PROBS, **{prob: value}))


@pytest.mark.parametrize("evaluate", ["rastrigin", "sphere", "callable"])
@pytest.mark.parametrize("n,L", [(129, 30), (1001, 33)])
def test_k6_hw_evaluations_equal_plain(card, n, L, evaluate):
    """Rastrigin and sphere in the kernel, and none (a callable applied
    afterwards)."""
    _k6_hw_case(card, n, L, K6_PROBS, kernels_real.eval_sphere
                if evaluate == "callable" else evaluate)


@pytest.mark.parametrize("tournsize", [1, 3, 4, 5, 9])
@pytest.mark.parametrize("L", [2, 31, 33, 100, 257, 300])
@pytest.mark.parametrize("n", [1, 3, 255, 257, 1001, 100_000])
def test_k4_and_k4_hw_row_copies_equal_plain(card, n, L, tournsize):
    """K4-hw and K4 bitwise against the plain version at W 1-10: uint4 rows
    (W 4), the warp's word walk (every other W), a last warp part full,
    and 1-3 Philox calls a tournament."""
    gen = make_generator(7 * n + L + tournsize, card)
    pk = packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                             < 0.5)
    fit = torch.randint(0, 8, (n,), generator=gen, device=card).float()
    key = kernels.philox_key(gen)
    k4 = packed.sel_tournament_gather_packed
    before = (k4.launches, k4.hw_launches)
    got = k4(pk, fit, prng="hw", key=key, tournsize=tournsize)
    draws = packed.tournament_bits(gen, tournsize, n)
    body = k4(pk, fit, draws)
    torch.cuda.synchronize()
    assert (k4.launches - before[0], k4.hw_launches - before[1]) == (2, 1)
    want = packed.sel_tournament_gather_packed_plain(
        pk, fit, philox.hw_tournament_bits(key, tournsize, n))
    assert _same(got, want)
    assert _same(body, packed.sel_tournament_gather_packed_plain(pk, fit,
                                                                 draws))


@pytest.mark.parametrize("n", [3, 1001])
def test_k4_rows_off_16_byte_alignment_take_the_word_walk(card, n):
    """W 4 rows that start 4 bytes off a 16-byte boundary cannot move as
    uint4: both paths then take the warp's word walk, bitwise."""
    gen = make_generator(n, card)
    W = 4
    store = torch.randint(0, 2**31, (n * W + 1,), generator=gen,
                          device=card).to(torch.uint32)
    pk = store[1:].view(n, W)
    assert pk.data_ptr() % 16 != 0
    fit = torch.rand((n,), generator=gen, device=card)
    key = kernels.philox_key(gen)
    got = packed.sel_tournament_gather_packed(pk, fit, prng="hw", key=key,
                                              tournsize=3)
    draws = packed.tournament_bits(gen, 3, n)
    body = packed.sel_tournament_gather_packed(pk, fit, draws)
    torch.cuda.synchronize()
    assert _same(got, packed.sel_tournament_gather_packed_plain(
        pk, fit, philox.hw_tournament_bits(key, 3, n)))
    assert _same(body, packed.sel_tournament_gather_packed_plain(pk, fit,
                                                                 draws))
