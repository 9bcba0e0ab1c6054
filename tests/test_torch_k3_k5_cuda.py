"""K3's and K5's bits bodies (``prng='input'``) against their plain
versions, on the card, at the shapes their designs branch on.

These tests need a CUDA card and the CUDA toolkit; they skip without a
card. On a machine with one:

    python -m pytest tests/test_torch_k3_k5_cuda.py -m cuda -q --noconftest

K3 (``fused_variation_eval_packed``): a warp walks its mutating rows 4 at a
time, one uint4 of genebits a lane where W % 4 == 0 and the tensor is
16-byte aligned, else 4-byte loads; genomes of more than 4 words go in
chunks. K5 (``evolve_packed``): a warp's gene planes stream through its
ring in shared memory, 16 bytes a lane where n % 4 == 0 and the draws are
16-byte aligned, else 4 bytes; the tiles loop past one resident wave;
the grid barrier is split in two. Each is held bitwise against its plain
version; the Philox paths, whose shared helpers (``tile_worklist.cuh``)
changed, too; and each wrapper counts one launch a call.
"""

import pytest
import torch

from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import kernels, packed, philox

pytestmark = pytest.mark.cuda

PROBS = ((0.5, 0.2, 0.05), (1.0, 1.0, 0.5), (0.0, 0.0, 0.3),
         (0.0, 1.0, 1.0), (1.0, 0.0, 0.05))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    if a.dtype in (torch.float32, torch.uint32):
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _genomes(gen, card, n, L):
    return packed.pack_genomes(torch.rand((n, L), generator=gen, device=card)
                               < 0.5)


def _offset(t, card):
    """``t``'s values in a tensor 4 bytes past a 16-byte boundary."""
    store = torch.empty(t.numel() + 1, dtype=t.dtype, device=card)
    view = store[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("L", [1, 31, 32, 33, 100, 128, 300])
@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1001])
def test_k3_bits_body_equals_plain(card, n, L):
    gen = make_generator(n * 1000 + L, card)
    pk = _genomes(gen, card, n, L)
    fn = packed.fused_variation_eval_packed
    for cxpb, mutpb, indpb in PROBS:
        bits = packed.variation_bits(gen, n, pk.shape[1])
        probs = dict(cxpb=cxpb, mutpb=mutpb, indpb=indpb)
        before = (fn.launches, fn.hw_launches)
        got = fn(pk, L, *bits, **probs)
        want = packed.fused_variation_eval_packed_plain(pk, L, *bits, **probs)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.hw_launches - before[1]) == (1, 0)
        assert _same(got[0], want[0]) and _same(got[1], want[1]), probs


@pytest.mark.parametrize("n,L", [(257, 100), (1001, 128), (300, 33)])
def test_k3_bits_body_off_16_byte_alignment_equals_plain(card, n, L):
    # genomes and genebits 4 bytes past a 16-byte boundary: 4-byte loads
    gen = make_generator(n + L, card)
    pk = _offset(_genomes(gen, card, n, L), card)
    pairbits, rowbits, genebits = packed.variation_bits(gen, n, pk.shape[1])
    genebits = _offset(genebits, card)
    probs = dict(cxpb=0.7, mutpb=0.6, indpb=0.2)
    got = packed.fused_variation_eval_packed(pk, L, pairbits, rowbits,
                                             genebits, **probs)
    want = packed.fused_variation_eval_packed_plain(pk, L, pairbits, rowbits,
                                                    genebits, **probs)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])


@pytest.mark.parametrize("L,tournsize,ngen", [(1, 1, 3), (31, 2, 1),
                                              (32, 3, 3), (33, 4, 3),
                                              (100, 3, 3), (128, 5, 2),
                                              (300, 9, 2)])
@pytest.mark.parametrize("n", [1, 2, 255, 257, 1000, 1001])
def test_k5_bits_body_equals_plain(card, n, L, tournsize, ngen):
    gen = make_generator(n * 1000 + L + ngen, card)
    pk = _genomes(gen, card, n, L)
    fit = packed.packed_fitness(pk)
    fn = packed.evolve_packed
    for cxpb, mutpb, indpb in PROBS[:3]:
        bits = packed.evolve_bits(gen, ngen, tournsize, n, pk.shape[1])
        probs = dict(cxpb=cxpb, mutpb=mutpb, indpb=indpb)
        before = (fn.launches, fn.hw_launches)
        got = fn(pk, fit, L, *bits, **probs)
        want = packed.evolve_packed_plain(pk, fit, L, *bits, **probs)
        torch.cuda.synchronize()
        assert (fn.launches - before[0], fn.hw_launches - before[1]) == (1, 0)
        assert _same(got[0], want[0]) and _same(got[1], want[1]), probs


@pytest.mark.parametrize("n,L", [(300_001, 100), (300_000, 33)])
def test_k5_bits_body_past_one_resident_wave_equals_plain(card, n, L):
    # more tiles than the card holds at once: the tile loop runs, with the
    # next item in the same generation and across the barrier
    gen = make_generator(n, card)
    pk = _genomes(gen, card, n, L)
    fit = packed.packed_fitness(pk)
    # more 256-child tiles than 8 blocks of 256 threads on every SM
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert -(-n // 256) > 8 * sms
    bits = packed.evolve_bits(gen, 3, 3, n, pk.shape[1])
    probs = dict(cxpb=0.5, mutpb=0.2, indpb=0.05)
    got = packed.evolve_packed(pk, fit, L, *bits, **probs)
    want = packed.evolve_packed_plain(pk, fit, L, *bits, **probs)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_k5_bits_body_with_unaligned_draws_equals_plain(card):
    # n % 4 == 0 but the gene planes 4 bytes past a 16-byte boundary: the
    # ring's 4-byte copies; a misaligned population: word loads
    n, L = 1000, 100
    gen = make_generator(5, card)
    pk = _offset(_genomes(gen, card, n, L), card)
    fit = packed.packed_fitness(pk)
    sel, pair, row, gene = packed.evolve_bits(gen, 4, 3, n, pk.shape[1])
    gene = _offset(gene, card)
    probs = dict(cxpb=0.5, mutpb=0.5, indpb=0.1)
    got = packed.evolve_packed(pk, fit, L, sel, pair, row, gene, **probs)
    want = packed.evolve_packed_plain(pk, fit, L, sel, pair, row, gene,
                                      **probs)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])


def test_k5_bits_body_at_the_main_path_shape_equals_plain(card):
    n, L = 100_000, 100
    gen = make_generator(7, card)
    pk = _genomes(gen, card, n, L)
    fit = packed.packed_fitness(pk)
    bits = packed.evolve_bits(gen, 5, 3, n, pk.shape[1])
    probs = dict(cxpb=0.5, mutpb=0.2, indpb=0.05)
    got = packed.evolve_packed(pk, fit, L, *bits, **probs)
    again = packed.evolve_packed(pk, fit, L, *bits, **probs)
    want = packed.evolve_packed_plain(pk, fit, L, *bits, **probs)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    assert _same(got[0], again[0]) and _same(got[1], again[1])


@pytest.mark.parametrize("n,L", [(1, 100), (255, 33), (257, 300),
                                 (1001, 100)])
def test_k3_hw_and_k5_hw_still_equal_plain(card, n, L):
    gen = make_generator(n + 3 * L, card)
    pk = _genomes(gen, card, n, L)
    W = pk.shape[1]
    probs = dict(cxpb=0.6, mutpb=0.5, indpb=0.1)
    key = kernels.philox_key(gen)
    got = packed.fused_variation_eval_packed(pk, L, prng="hw", key=key,
                                             **probs)
    want = packed.fused_variation_eval_packed_plain(
        pk, L, *philox.hw_packed_bits(key, n, W, L), **probs)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])
    fit = packed.packed_fitness(pk)
    got = packed.evolve_packed(pk, fit, L, ngen=3, tournsize=3, prng="hw",
                               key=key, **probs)
    want = packed.evolve_packed_plain(
        pk, fit, L, *philox.hw_evolve_bits(key, 3, 3, n, L), **probs)
    torch.cuda.synchronize()
    assert _same(got[0], want[0]) and _same(got[1], want[1])
