"""Packed-genome ops and kernels of the port held bit for bit against the
JAX package's on the CPU.

The word helpers (pack/unpack, popcount, segment masks) on the same
numpy inputs, and K3 ``fused_variation_eval_packed`` and K4
``sel_tournament_gather_packed`` (on CPU tensors: their plain versions)
against ``deap_tpu``'s Pallas kernels in interpret mode with their
bits-input path, fed the very bits those kernels draw from their key.
Tolerance: bitwise — integer and select operations only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops import packed as jp
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import packed as tp


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _round_up(x, m):
    return -(-x // m) * m


# ------------------------------------------------------------ word helpers --

@pytest.mark.parametrize("L", [1, 31, 32, 33, 100])
def test_pack_unpack_fitness_match_jax(L):
    bits = np.random.default_rng(L).random((9, L)) < 0.5
    want = jp.pack_genomes(jnp.asarray(bits))
    got = tp.pack_genomes(T(bits))
    assert_bitwise(got, want)
    assert_bitwise(tp.unpack_genomes(got, L), jp.unpack_genomes(want, L))
    assert_bitwise(tp.packed_fitness(got), jp.packed_fitness(want))


def test_popcount_full_range_words():
    words = np.random.default_rng(0).integers(0, 2**32, (64, 5),
                                              dtype=np.uint32)
    words[0] = [0, 0xFFFFFFFF, 0x80000000, 1, 0x55555555]
    assert_bitwise(tp.popcount(T(words)), jp.popcount(jnp.asarray(words)))


def test_segment_mask_words_match_jax():
    rng = np.random.default_rng(1)
    lo = rng.integers(-5, 110, 50).astype(np.int32)
    hi = lo + rng.integers(0, 80, 50).astype(np.int32)
    lo[:3], hi[:3] = [0, 32, 31], [32, 64, 33]
    assert_bitwise(tp.segment_mask_words(T(lo), T(hi), 4),
                   jp.segment_mask_words(jnp.asarray(lo), jnp.asarray(hi), 4))


# ------------------------------------------ K3 fused_variation_eval_packed --

@pytest.mark.parametrize("n,L,probs", [
    (1, 100, (0.5, 0.2, 0.05)),
    (2, 33, (1.0, 1.0, 0.5)),
    (63, 1, (0.5, 0.5, 0.5)),
    (64, 31, (0.5, 0.2, 0.05)),
    (65, 32, (1.0, 1.0, 0.3)),
    (130, 100, (0.5, 0.2, 0.05)),
    (77, 100, (0.0, 0.0, 0.0)),
])
def test_k3_packed_generation_bitwise(n, L, probs):
    cxpb, mutpb, indpb = probs
    rng = np.random.default_rng(n + L)
    packed = jp.pack_genomes(jnp.asarray(rng.random((n, L)) < 0.5))
    W = packed.shape[1]
    key = jax.random.key(n * 7 + L)
    want_c, want_f = jp.fused_variation_eval_packed(
        key, packed, L, cxpb=cxpb, mutpb=mutpb, indpb=indpb, prng="input",
        interpret=True, block_i=64)
    # the bits exactly as run_fused_kernel draws them, first n rows
    ni = _round_up(n, 64)
    k1, k2, k3 = jax.random.split(key, 3)
    pairbits = jax.random.bits(k1, (ni, 4), jnp.uint32)[:n]
    rowbits = jax.random.bits(k2, (ni, 1), jnp.uint32)[:n]
    genebits = jax.random.bits(k3, (ni, 32 * W), jnp.uint32)[:n]
    got_c, got_f = tp.fused_variation_eval_packed(
        T(packed), L, T(pairbits), T(rowbits), T(genebits), cxpb=cxpb,
        mutpb=mutpb, indpb=indpb)
    assert_bitwise(got_c, want_c)
    assert_bitwise(got_f, want_f)


# ----------------------------------------- K4 sel_tournament_gather_packed --

@pytest.mark.parametrize("n,tournsize", [(1, 3), (2, 2), (127, 3),
                                         (200, 5)])
def test_k4_selgather_bitwise(n, tournsize):
    rng = np.random.default_rng(n)
    packed = jp.pack_genomes(jnp.asarray(rng.random((n, 70)) < 0.5))
    fit = rng.integers(0, 5, n).astype(np.float32)  # many ties
    fit[rng.random(n) < 0.1] = -np.inf
    key = jax.random.key(n + tournsize)
    want = jp.sel_tournament_gather_packed(key, packed, jnp.asarray(fit),
                                           tournsize, prng="input",
                                           interpret=True)
    draws = jax.random.bits(key, (tournsize, _round_up(n, 128)),
                            jnp.uint32)[:, :n]
    got = tp.sel_tournament_gather_packed(T(packed), T(fit), T(draws))
    assert_bitwise(got, want)


def test_packed_wrappers_reject_other_devices():
    g = torch.zeros((4, 2), dtype=torch.uint32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tp.sel_tournament_gather_packed(g, torch.zeros(4, device="meta"),
                                        torch.zeros((3, 4), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tp.fused_variation_eval_packed(g, 40, *tp.variation_bits(
            make_generator(0, "cpu"), 4, 2), cxpb=0.5, mutpb=0.5, indpb=0.5)


def test_draws_are_uint32_in_kernel_layout():
    gen = make_generator(0, "cpu")
    pair, row, gene = tp.variation_bits(gen, 10, 4)
    assert (pair.dtype, row.dtype, gene.dtype) == (torch.uint32,) * 3
    assert (pair.shape, row.shape, gene.shape) == ((10, 4), (10, 1),
                                                   (10, 128))
    draws = tp.tournament_bits(gen, 3, 10)
    assert draws.dtype == torch.uint32 and draws.shape == (3, 10)
    # full 32-bit range: the top bit is set about half the time
    top = (tp._words(gene) >> 31).float().mean().item()
    assert 0.4 < top < 0.6
