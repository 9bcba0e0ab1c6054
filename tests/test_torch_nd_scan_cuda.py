"""J3 and J4 (``csrc/nd_scan.cu``, both in chunks of rows) on the card
against their plain versions, at n 1-100k on every kind of rows of
``chip_smoke.ND_KINDS`` (uniform, ties, ``-inf`` rows, NaN rows,
duplicates, one front, a chain) and on chains of 100k rows (as many
fronts as rows); J3 with ``emo.J3_SHARED_SLOTS`` lowered to force its
front maxima across the edge of shared memory, at the card's own edge
(chains of 58,111-58,113 rows) and on a 100k-row chain (every maximum
past the first 58,112 in device memory); J4 on random tables of 484 and
1024 columns, where its chunks hold 28 and 12 rows (the tables of 2^21
rows and more), and on tables whose U rows are 90% real slots; the whole
``nd_rank(impl='sweep')`` through J4 against ``impl='tiled'`` on the
NaN-free rows of the ``nan`` kind at 16,384 and 100k rows.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one, from the repository's root:

    python -m pytest tests/test_torch_nd_scan_cuda.py -m cuda -q --noconftest

Tolerance: both kernels equal their plain versions bitwise.
"""

import pytest
import torch

from chip_smoke import ND_KINDS, j3_shared_slots, nd_random_tables, nd_scan_rows
from deap_tpu_torch import mo
from deap_tpu_torch.mo import emo, ndsort

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _j3(w, slots=emo.J3_SHARED_SLOTS):
    _, neg, head = emo.staircase_inputs(w)
    before = emo.nd_rank_staircase.launches
    with j3_shared_slots(emo, slots):
        got = emo.staircase_rows(neg, head)
    want = emo.staircase_rows_plain(neg, head)
    torch.cuda.synchronize()
    assert emo.nd_rank_staircase.launches == before + 1
    return torch.equal(got, want), got


def _j4(w):
    _, Q, U, head, F = ndsort.sweep3_inputs(w)
    before = ndsort.nd_rank_sweep3.launches
    got = ndsort.sweep3_rows(Q, U, head, F)
    want = ndsort.sweep3_rows_plain(Q, U, head, F)
    torch.cuda.synchronize()
    assert ndsort.nd_rank_sweep3.launches == before + 1
    return torch.equal(got, want)


SIZES = (1, 2, 3, 31, 32, 33, 63, 64, 65, 1000, 4097)


@pytest.mark.parametrize("kind", ND_KINDS)
def test_j3_equals_plain(card, kind):
    for n in SIZES:
        assert _j3(nd_scan_rows(torch, card, kind, n, 2, n))[0], (kind, n)


@pytest.mark.parametrize("kind", ["random", "neg_inf", "nan", "duplicates"])
def test_j3_equals_plain_at_100k(card, kind):
    assert _j3(nd_scan_rows(torch, card, kind, 100_000, 2, 3))[0]


@pytest.mark.parametrize("slots", [1, 2, 31, 32, 33, 1500, 2999, 3000,
                                   emo.j3_slots(3000)])
def test_j3_across_the_shared_memory_edge(card, slots):
    for kind in ("chain", "random", "ties"):
        ok, _ = _j3(nd_scan_rows(torch, card, kind, 3000, 2, slots), slots)
        assert ok, (kind, slots)


@pytest.mark.parametrize("n", [emo.J3_SHARED_SLOTS - 1, emo.J3_SHARED_SLOTS,
                               emo.J3_SHARED_SLOTS + 1, 100_000])
def test_j3_chains_past_shared_memory(card, n):
    ok, ranks = _j3(nd_scan_rows(torch, card, "chain", n, 2, 4))
    assert ok and int(ranks.max()) == n - 1


def test_j3_nd_rank_keeps_invalid_rows_at_n_and_matches_tiled(card):
    w = nd_scan_rows(torch, card, "random", 8192, 2, 5)
    assert torch.equal(mo.nd_rank(w, impl="staircase"),
                       mo.nd_rank(w, impl="tiled"))
    w = nd_scan_rows(torch, card, "neg_inf", 8192, 2, 6)
    ranks = mo.nd_rank(w)      # auto: the staircase at n >= 8192
    assert bool((ranks[w[:, 1] == -torch.inf] == 8192).all())


def test_j3_refuses_what_it_does_not_take(card):
    neg = torch.zeros(10, device=card)
    head = torch.ones(10, dtype=torch.bool, device=card)
    with pytest.raises(ValueError):
        emo.staircase_rows(neg.double(), head)
    with pytest.raises(ValueError):
        emo.staircase_rows(neg, head[:5])


@pytest.mark.parametrize("kind", ND_KINDS)
def test_j4_equals_plain(card, kind):
    for n in SIZES:
        assert _j4(nd_scan_rows(torch, card, kind, n, 3, n)), (kind, n)


def test_j4_equals_plain_and_tiled_at_16384(card):
    w = nd_scan_rows(torch, card, "random", 16_384, 3, 7)
    assert _j4(w)
    assert torch.equal(mo.nd_rank(w, impl="sweep"),
                       mo.nd_rank(w, impl="tiled"))


@pytest.mark.parametrize("n", [16_384, 100_000])
def test_j4_nd_rank_equals_tiled_beside_nan_rows(card, n):
    # the sweep's query bounds order NaN as the largest value, so rows
    # that hold no NaN rank as K7's peel ranks them
    w = nd_scan_rows(torch, card, "nan", n, 3, 9)
    clean = ~torch.isnan(w).any(1)
    before = ndsort.nd_rank_sweep3.launches
    got = mo.nd_rank(w, impl="sweep")
    assert ndsort.nd_rank_sweep3.launches == before + 1
    assert torch.equal(got[clean], mo.nd_rank(w, impl="tiled")[clean])


def test_j4_equals_plain_at_100k(card):
    assert _j4(nd_scan_rows(torch, card, "ties", 100_000, 3, 8))


def test_j4_chain_of_100k(card):
    w = nd_scan_rows(torch, card, "chain", 100_000, 3, 10)
    assert _j4(w)
    assert int(mo.nd_rank(w, impl="sweep").max()) == 100_000 - 1


@pytest.mark.parametrize("cols,u_valid", [(484, 0.1), (1024, 0.1),
                                          (289, 0.9)])
def test_j4_on_random_tables(card, cols, u_valid):
    # any tables whose U rows repeat only the pad F give the plain
    # version's ranks: wide ones (chunks of 28 and 12 rows) and dense ones
    # (~260 owner bits a row)
    Q, U, head = nd_random_tables(torch, card, 1000, cols, 3000, u_valid,
                                  cols)
    got = ndsort.sweep3_rows(Q, U, head, 3000)
    assert torch.equal(got, ndsort.sweep3_rows_plain(Q, U, head, 3000))
    assert int(got.max()) > 10


def test_j4_refuses_what_it_does_not_take(card):
    w = nd_scan_rows(torch, card, "random", 50, 3, 9)
    _, Q, U, head, F = ndsort.sweep3_inputs(w)
    with pytest.raises(ValueError):
        ndsort.sweep3_rows(Q.long(), U, head, F)
    with pytest.raises(ValueError):
        ndsort.sweep3_rows(Q, U[:10], head, F)
