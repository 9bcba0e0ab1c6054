"""K5 ``evolve_packed`` and the packed crossover and mutation helpers
held against the JAX package's on the CPU.

The port's wrapper (on CPU tensors: its plain version, a loop of the K4
and K3 plain versions) against ``deap_tpu``'s Pallas kernel in interpret
mode with its bits-input path, fed the very draws that kernel makes from
its key at its ``N = round_up(n, chunk)`` lanes, cut to the port's ``n``
lanes (lanes past ``n`` never feed a real lane: aspirants are ``% n`` and
a lane mates only where ``lane | 1 < n``). Tolerance: bitwise — integer
and select operations only. Whole runs, where each package draws for
itself, agree in distribution.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops import crossover as jcx
from deap_tpu.ops import packed as jp
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.ops import packed as tp

CHUNK = 128
PROBS = dict(cxpb=0.5, mutpb=0.2, indpb=0.05)


def T(a):
    return torch.from_numpy(np.array(a))


def assert_bitwise(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _evolve_draws(key, ngen, tournsize, n, W):
    """``evolve_packed``'s bits-input draws, cut to the first n lanes."""
    N = -(-n // CHUNK) * CHUNK
    ks, kp, kr, kg = jax.random.split(key, 4)
    return tuple(T(jax.random.bits(k, (ngen, rows, N), jnp.uint32)[:, :, :n])
                 for k, rows in ((ks, tournsize), (kp, 3), (kr, 1),
                                 (kg, 32 * W)))


# ------------------------------------------------------ K5 evolve_packed --

@pytest.mark.parametrize("n,L,ngen,tournsize,probs", [
    (256, 100, 1, 3, (0.5, 0.2, 0.05)),
    (256, 100, 3, 3, (0.5, 0.2, 0.05)),
    (200, 64, 1, 1, (1.0, 1.0, 0.3)),
    (200, 100, 3, 3, (0.7, 0.5, 0.1)),
    (201, 33, 3, 2, (1.0, 0.5, 0.2)),
])
def test_k5_generations_bitwise(n, L, ngen, tournsize, probs):
    cxpb, mutpb, indpb = probs
    bits = np.random.default_rng(n + ngen).random((n, L)) < 0.5
    packed = jp.pack_genomes(jnp.asarray(bits))
    fit = jp.packed_fitness(packed)
    key = jax.random.key(n * 11 + ngen + tournsize)
    want_pop, want_fit = jp.evolve_packed(
        key, packed, fit, L, ngen, tournsize=tournsize, cxpb=cxpb,
        mutpb=mutpb, indpb=indpb, prng="input", chunk=CHUNK, interpret=True)
    draws = _evolve_draws(key, ngen, tournsize, n, packed.shape[1])
    got_pop, got_fit = tp.evolve_packed(T(packed), T(fit), L, *draws,
                                        cxpb=cxpb, mutpb=mutpb, indpb=indpb)
    assert_bitwise(got_pop, want_pop)
    assert_bitwise(got_fit, want_fit)


def test_k5_zero_generations_return_the_inputs():
    pk = tp.pack_genomes(torch.rand((9, 40)) < 0.5)
    fit = tp.packed_fitness(pk).to(torch.float64)
    draws = tp.evolve_bits(make_generator(0, "cpu"), 0, 3, 9, 2)
    out, out_fit = tp.evolve_packed(pk, fit, 40, *draws, **PROBS)
    assert out is pk
    assert out_fit.dtype == torch.float32 and torch.equal(out_fit,
                                                          fit.float())


def test_k5_wrapper_refuses_what_it_cannot_do():
    pk = torch.zeros((8, 4), dtype=torch.uint32)
    draws = tp.evolve_bits(make_generator(0, "cpu"), 1, 3, 8, 4)
    with pytest.raises(NotImplementedError, match="Philox"):
        tp.evolve_packed(pk, torch.zeros(8), 100, *draws, **PROBS, prng="hw")
    with pytest.raises(ValueError, match="unknown prng"):
        tp.evolve_packed(pk, torch.zeros(8), 100, *draws, **PROBS,
                         prng="philox")
    with pytest.raises(ValueError, match="no kernel"):
        tp.evolve_packed(pk.to("meta"), torch.zeros(8, device="meta"), 100,
                         *(d.to("meta") for d in draws), **PROBS)


def test_evolve_bits_layout():
    sel, pair, row, gene = tp.evolve_bits(make_generator(1, "cpu"), 5, 3, 10,
                                          4)
    assert {d.dtype for d in (sel, pair, row, gene)} == {torch.uint32}
    assert (sel.shape, pair.shape, row.shape, gene.shape) == (
        (5, 3, 10), (5, 3, 10), (5, 1, 10), (5, 128, 10))


SEEDS, N_LOOP, NGEN_LOOP, L_LOOP = 12, 256, 10, 100


def test_evolve_packed_agrees_with_jax_in_distribution():
    @jax.jit
    def jax_run(key, pk, fit):
        return jp.evolve_packed(key, pk, fit, L_LOOP, NGEN_LOOP, **PROBS,
                                prng="input", chunk=CHUNK,
                                interpret=True)[1]

    jax_means, port_means = [], []
    for s in range(SEEDS):
        pk = jp.pack_genomes(jax.random.bernoulli(jax.random.key(500 + s),
                                                  0.5, (N_LOOP, L_LOOP)))
        jax_means.append(float(jax_run(jax.random.key(s), pk,
                                       jp.packed_fitness(pk)).mean()))
        gen = make_generator(s, "cpu")
        tpk = tp.pack_genomes(torch.rand((N_LOOP, L_LOOP), generator=gen)
                              < 0.5)
        out, fit = tp.evolve_packed(
            tpk, tp.packed_fitness(tpk), L_LOOP,
            *tp.evolve_bits(gen, NGEN_LOOP, 3, N_LOOP, 4), **PROBS)
        assert torch.equal(fit, tp.packed_fitness(out))
        port_means.append(float(fit.mean()))
    jm, pm = np.array(jax_means), np.array(port_means)
    se = np.sqrt(jm.var(ddof=1) / SEEDS + pm.var(ddof=1) / SEEDS)
    assert abs(jm.mean() - pm.mean()) <= 3 * se, (jm.mean(), pm.mean(), se)
    assert pm.mean() > 60


# ------------------------------------------------------- packed helpers --

@pytest.mark.parametrize("L", [1, 33, 100])
def test_cx_two_point_packed_bitwise(L):
    m = 40
    rng = np.random.default_rng(L)
    g1 = jp.pack_genomes(jnp.asarray(rng.random((m, L)) < 0.5))
    g2 = jp.pack_genomes(jnp.asarray(rng.random((m, L)) < 0.5))
    key = jax.random.key(L)
    want = jcx.pair_vmap(jp.cx_two_point_packed)(key, g1, g2, L)
    lo, hi = jax.vmap(lambda k: jcx._two_points(k, L))(
        jax.random.split(key, m))
    got = tp._cx_two_point_packed(T(g1), T(g2), T(lo), T(hi))
    assert_bitwise(got[0], want[0])
    assert_bitwise(got[1], want[1])
    # the generator-drawing operator: a two-point swap on the words
    c1, c2 = tp.cx_two_point_packed(make_generator(L, "cpu"), T(g1), T(g2), L)
    b1, b2 = tp.unpack_genomes(c1, L), tp.unpack_genomes(c2, L)
    a1, a2 = tp.unpack_genomes(T(g1), L), tp.unpack_genomes(T(g2), L)
    assert torch.equal(b1 ^ b2, a1 ^ a2) and torch.equal(b1 | b2, a1 | a2)


@pytest.mark.parametrize("shape,L,indpb", [((7, 4), 100, 0.3),
                                           ((5, 2), 33, 0.9),
                                           ((3, 1), 1, 0.5)])
def test_flip_words_and_mutation_bitwise(shape, L, indpb):
    key = jax.random.key(L)
    want = jp.flip_words(key, shape, indpb, L)
    u = jax.random.uniform(key, (*shape, 32))
    assert_bitwise(tp._flip_words(T(u), indpb, L), want)
    words = np.random.default_rng(L).integers(0, 2**32, shape,
                                              dtype=np.uint32)
    words = np.asarray(jp.pack_genomes(jp.unpack_genomes(jnp.asarray(words),
                                                         L)))
    jmut = jp.mut_flip_bit_packed(key, jnp.asarray(words), indpb, L)
    assert_bitwise(tp._as_uint32(tp._words(T(words))
                                 ^ tp._words(tp._flip_words(T(u), indpb, L))),
                   jmut)


def test_flip_words_rate_and_tail():
    gen = make_generator(2, "cpu")
    flips = tp.flip_words(gen, (2000, 4), 0.1, 100)
    bits = tp.unpack_genomes(flips, 128)
    assert not bits[:, 100:].any()
    assert abs(bits[:, :100].float().mean().item() - 0.1) < 0.005
    g = tp.pack_genomes(torch.zeros((2000, 100), dtype=torch.bool))
    mutated = tp.mut_flip_bit_packed(gen, g, 0.1, 100)
    rate = tp.packed_fitness(mutated).mean().item() / 100
    assert abs(rate - 0.1) < 0.005
