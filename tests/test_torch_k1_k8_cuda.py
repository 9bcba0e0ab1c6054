"""K1 ``fused_variation`` and K8 ``dominated_weight_maxes`` against their
plain versions on the card, over the shapes their designs branch on, and
K7 beside them.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one:

    python -m pytest tests/test_torch_k1_k8_cuda.py -m cuda -q --noconftest

The shapes and inputs are ``chip_smoke.py``'s (``k1_sweep``,
``k1_inputs``, ``k8_sweep``, ``k8_inputs``, ``dc_cross_steps``; run from
the repository's root). Tolerance: bitwise, for K7 with integer weights
whose sums stay below 2**24. Each wrapper's launch counter rises by one a
call.
"""

import pytest
import torch

from chip_smoke import (dc_cross_steps, k1_inputs, k1_sweep, k8_inputs,
                        k8_sweep)
from deap_tpu_torch import benchmarks as bm
from deap_tpu_torch import mo
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels, variation

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("L", [1, 3, 4, 5, 100, 101])
@pytest.mark.parametrize("dtype", [torch.bool, torch.float32])
@pytest.mark.parametrize("kind", ["flip", "add", "set"])
def test_k1_equals_plain_over_the_sweep(card, L, dtype, kind):
    """Odd n above and below N, empty and whole segments, cxpb and mutpb
    at 0 and 1, genomes off their unit's alignment."""
    cases = [c for c in k1_sweep() if c[0] == L and c[3] == dtype
             and c[4] == kind]
    assert cases
    for seed, (_, n, N, _, _, cxpb, mutpb, aligned) in enumerate(cases):
        args = k1_inputs(torch, card, seed, n, N, L, dtype, kind, cxpb,
                         mutpb, aligned)
        before = kernels.fused_variation.launches
        got = kernels.fused_variation(*args, mut_kind=kind)
        want = variation.apply_variation(*args, kind).to(dtype)
        torch.cuda.synchronize()
        assert kernels.fused_variation.launches == before + 1
        assert _same(got, want), (n, N, cxpb, mutpb, aligned)


@pytest.mark.parametrize("n,N,L", [(100_000, 100_000, 100),
                                   (99_999, 100_001, 100),
                                   (4097, 33, 1000), (3, 2, 10_000),
                                   (1, 1, 40_000)])
@pytest.mark.parametrize("dtype,kind", [(torch.bool, "flip"),
                                        (torch.float32, "add"),
                                        (torch.float32, "set")])
def test_k1_equals_plain_at_long_runs(card, n, N, L, dtype, kind):
    """ea_simple's shape, and rows long enough that a warp's run is cut
    into slices."""
    args = k1_inputs(torch, card, n + L, n, N, L, dtype, kind, 0.5, 0.5)
    got = kernels.fused_variation(*args, mut_kind=kind)
    want = variation.apply_variation(*args, kind).to(dtype)
    torch.cuda.synchronize()
    assert _same(got, want)


def test_k1_vector_units_need_aligned_tensors(card):
    """A mask or argument view off its alignment takes the one-gene units
    and still equals the plain version."""
    n, L = 257, 100
    args = list(k1_inputs(torch, card, 3, n, n, L, torch.float32, "add",
                          0.5, 1.0))
    flat = torch.zeros(n * L + 1, dtype=torch.bool, device=card)
    mask = flat[1:].view(n, L)
    mask.copy_(args[7])
    arg = torch.zeros(n * L + 1, device=card)[1:].view(n, L)
    arg.copy_(args[8])
    for i, t in ((7, mask), (8, arg)):
        case = list(args)
        case[i] = t
        assert kernels._k1_width(L, 4, case[0], case[0], case[7],
                                 case[8]) == 1
        got = kernels.fused_variation(*case, mut_kind="add")
        assert _same(got, variation.apply_variation(*case, "add"))


@pytest.mark.parametrize("m", [1, 2, 3, 8, 9, 32])
def test_k8_equals_plain_over_the_sweep(card, m):
    """n 1-100k, nq 1-2048, NaN, -inf and duplicated rows, ties and
    all-zero weights."""
    cases = [c for c in k8_sweep() if c[2] == m]
    for seed, (n, nq, _) in enumerate(cases):
        args = k8_inputs(torch, card, seed, n, nq, m)
        before = kernels.dominated_weight_maxes.launches
        got = kernels.dominated_weight_maxes(*args)
        want = kernels.dominated_weight_maxes_plain(*args)
        torch.cuda.synchronize()
        assert kernels.dominated_weight_maxes.launches == before + 1
        assert _same(got, want), (n, nq, m, seed)


@pytest.mark.parametrize("nq", [512, 2048])
def test_k8_equals_plain_at_100k_rows(card, nq):
    gen = make_generator(nq, card)
    w = -bm.dtlz2(torch.rand((100_000, 12), generator=gen, device=card), 3)
    weights = torch.randint(1, 60, (100_000,), generator=gen,
                            device=card).float()
    queries = w[torch.randint(0, 100_000, (nq,), generator=gen,
                              device=card)] * 0.999
    assert _same(kernels.dominated_weight_maxes(w, weights, queries),
                 kernels.dominated_weight_maxes_plain(w, weights, queries))


def test_k8_cross_steps_and_the_dc_selection(card):
    """Each of the 31 cross steps of nd='dc' at 16,384 DTLZ2 rows equals
    the plain version; the selection launches K8 31 times and equals it
    through K7."""
    gen = make_generator(11, card)
    w = -bm.dtlz2(torch.rand((16_384, 12), generator=gen, device=card), 3)
    steps = dc_cross_steps(torch, w)
    assert len(steps) == 31
    for step in steps:
        assert _same(kernels.dominated_weight_maxes(*step),
                     kernels.dominated_weight_maxes_plain(*step))
    before = kernels.dominated_weight_maxes.launches
    by_dc = mo.sel_nsga2(None, w, 8192, nd="dc")
    assert kernels.dominated_weight_maxes.launches == before + 31
    assert torch.equal(by_dc, mo.sel_nsga2(None, w, 8192, nd="tiled"))


@pytest.mark.parametrize("n,m", [(1, 3), (33, 1), (2049, 3), (2049, 8),
                                 (2049, 9), (16_384, 3), (100_000, 3)])
def test_k7_beside_k8_equals_plain(card, n, m):
    w, _, _ = k8_inputs(torch, card, n + m, n, 1, m)
    gen = make_generator(n, card)
    for weights in (torch.rand(n, generator=gen, device=card) < 0.5,
                    torch.randint(-3, 4, (n,), generator=gen,
                                  device=card).float()):
        before = kernels.dominated_weight_sums.launches
        got = kernels.dominated_weight_sums(w, weights)
        want = kernels.dominated_weight_sums_plain(w, weights)
        torch.cuda.synchronize()
        assert kernels.dominated_weight_sums.launches == before + 1
        assert _same(got, want)
