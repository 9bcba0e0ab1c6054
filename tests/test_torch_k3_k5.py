"""K3's and K5's bits bodies (``prng='input'``) held against the JAX
package's on the CPU, at the shapes their card designs branch on.

``fused_variation_eval_packed`` (K3) and ``evolve_packed`` (K5) on CPU
tensors run their plain versions; ``deap_tpu``'s Pallas kernels run in
interpret mode with their bits-input path, and the port is fed the very
draws those kernels make from their key (cut to the port's ``n`` rows or
lanes). The shapes: n at one, two, a tile of 256 rows and either side of
it, and odd; L at 1, 31, 32, 33, 100 and 128 (W 1 to 4, L a multiple of
32 and not, the last word partly real); crossover and mutation rates at 0
and 1; tournaments of 1 to 4; 1 and 3 generations. Tolerance: bitwise —
integer and select operations only.

The card kernels split their work by index arithmetic that the CPU cannot
run; the last tests replay it in numpy: K3's warp walk (lane l loads plane
l of a mutating row's 4-word chunk; the ballot of its draws is the flip
word) reads every real plane once and gives the plain version's flip
words; K5's ring copies (4 planes a group, 16 or 4 bytes a lane) bring
every lane of every real plane once and place its bit at its gene; K5's
items (a generation's tiles, a block's in turn) come once each, with the
next two items as the kernel computes them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops import packed as jp
from deap_tpu_torch.ops import packed as tp

K3_BLOCK, K5_CHUNK = 64, 128


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


# ------------------------------------------ K3 fused_variation_eval_packed --

@pytest.mark.parametrize("n,L,probs", [
    (1, 100, (0.5, 0.2, 0.05)),
    (2, 33, (1.0, 1.0, 1.0)),
    (255, 31, (0.5, 0.2, 0.05)),
    (255, 128, (1.0, 0.0, 0.3)),
    (256, 32, (0.0, 1.0, 0.3)),
    (257, 100, (0.5, 0.2, 0.05)),
    (257, 1, (1.0, 1.0, 0.5)),
    (1001, 100, (0.5, 0.2, 0.05)),
    (1001, 33, (0.0, 0.0, 0.5)),
])
def test_k3_bits_body_matches_jax(n, L, probs):
    cxpb, mutpb, indpb = probs
    rng = np.random.default_rng(3 * n + L)
    packed = jp.pack_genomes(jnp.asarray(rng.random((n, L)) < 0.5))
    W = packed.shape[1]
    key = jax.random.key(n * 13 + L)
    want_c, want_f = jp.fused_variation_eval_packed(
        key, packed, L, cxpb=cxpb, mutpb=mutpb, indpb=indpb, prng="input",
        interpret=True, block_i=K3_BLOCK)
    # the bits exactly as run_fused_kernel draws them, first n rows
    ni = _round_up(n, K3_BLOCK)
    k1, k2, k3 = jax.random.split(key, 3)
    pairbits = jax.random.bits(k1, (ni, 4), jnp.uint32)[:n]
    rowbits = jax.random.bits(k2, (ni, 1), jnp.uint32)[:n]
    genebits = jax.random.bits(k3, (ni, 32 * W), jnp.uint32)[:n]
    got_c, got_f = tp.fused_variation_eval_packed(
        T(packed), L, T(pairbits), T(rowbits), T(genebits), cxpb=cxpb,
        mutpb=mutpb, indpb=indpb, prng="input")
    assert_bitwise(got_c, want_c)
    assert_bitwise(got_f, want_f)


# ------------------------------------------------------ K5 evolve_packed --

def _evolve_draws(key, ngen, tournsize, n, W):
    """``evolve_packed``'s bits-input draws, cut to the first n lanes."""
    N = _round_up(n, K5_CHUNK)
    ks, kp, kr, kg = jax.random.split(key, 4)
    return tuple(T(jax.random.bits(k, (ngen, rows, N), jnp.uint32)[:, :, :n])
                 for k, rows in ((ks, tournsize), (kp, 3), (kr, 1),
                                 (kg, 32 * W)))


@pytest.mark.parametrize("n,L,ngen,tournsize,probs", [
    (1, 100, 1, 1, (0.5, 0.2, 0.05)),
    (2, 1, 3, 2, (1.0, 1.0, 0.5)),
    (2, 128, 1, 4, (0.5, 0.5, 0.1)),
    (255, 31, 3, 3, (0.5, 0.2, 0.05)),
    (255, 32, 1, 1, (0.0, 1.0, 0.3)),
    (257, 100, 3, 3, (0.5, 0.2, 0.05)),
    (257, 33, 3, 4, (1.0, 0.0, 0.2)),
])
def test_k5_bits_body_matches_jax(n, L, ngen, tournsize, probs):
    cxpb, mutpb, indpb = probs
    rng = np.random.default_rng(7 * n + L + ngen)
    packed = jp.pack_genomes(jnp.asarray(rng.random((n, L)) < 0.5))
    fit = jp.packed_fitness(packed)
    key = jax.random.key(n * 17 + L + 3 * ngen + tournsize)
    want_pop, want_fit = jp.evolve_packed(
        key, packed, fit, L, ngen, tournsize=tournsize, cxpb=cxpb,
        mutpb=mutpb, indpb=indpb, prng="input", chunk=K5_CHUNK,
        interpret=True)
    draws = _evolve_draws(key, ngen, tournsize, n, packed.shape[1])
    got_pop, got_fit = tp.evolve_packed(T(packed), T(fit), L, *draws,
                                        cxpb=cxpb, mutpb=mutpb, indpb=indpb,
                                        prng="input")
    assert_bitwise(got_pop, want_pop)
    assert_bitwise(got_fit, want_fit)


# ----------------------------------- the card kernels' index arithmetic --

K3_CHUNK, K5_WORDS = 4, 4


def _k3_warp_flips(genebits, mutating, W, L, indpb):
    """K3's bits body's walk for one warp's 32 rows: for each mutating row
    and each chunk of ``K3_CHUNK`` words from w0, lane l loads columns
    ``l W + w0 + k`` (k < kw) of the row's genebits, and flip word w0 + k of
    the row is the warp's ballot over lanes l of ``32 (w0 + k) + l < L``
    and the draw below the gene rate. Returns ``(flips [32, W], loads)``,
    loads the (row, column) of every load of a real plane."""
    below = np.uint64(int(np.ceil(np.float32(indpb) * np.float32(2 ** 24))))
    flips = np.zeros((32, W), np.uint64)
    loads = []
    for row in np.flatnonzero(mutating):
        for w0 in range(0, W, K3_CHUNK):
            kw = min(K3_CHUNK, W - w0)
            for k in range(kw):
                word = 0
                for lane in range(32):
                    col = lane * W + w0 + k
                    real = 32 * (w0 + k) + lane < L
                    if real:
                        loads.append((row, col))
                    if real and (np.uint64(genebits[row, col]) >> np.uint64(8)) < below:
                        word |= 1 << lane
                flips[row, w0 + k] = word
    return flips, loads


@pytest.mark.parametrize("W,L", [(1, 1), (1, 31), (1, 32), (2, 33), (3, 70),
                                 (4, 100), (4, 128), (5, 129), (8, 256),
                                 (9, 257), (10, 300)])
def test_k3_warp_walk_reads_each_real_plane_once_and_gives_the_flips(W, L):
    rng = np.random.default_rng(W * 1000 + L)
    genebits = rng.integers(0, 2 ** 32, (32, 32 * W), dtype=np.uint64)
    mutating = rng.random(32) < 0.3
    mutating[:2] = True, False
    indpb = 0.3
    flips, loads = _k3_warp_flips(genebits, mutating, W, L, indpb)
    # each real plane (column b W + w, 32 w + b < L) of a mutating row once
    want = [(r, b * W + w) for r in np.flatnonzero(mutating)
            for w in range(W) for b in range(32) if 32 * w + b < L]
    assert len(loads) == len(set(loads)) == len(want)
    assert set(loads) == set(want)
    # the flip words the plain version builds from the same draws
    u = tp._u01(torch.from_numpy(genebits.astype(np.int64)))
    plain = tp._flip_from_planes((u < tp._f32(indpb)).reshape(32, 32, W), L)
    plain = torch.where(torch.from_numpy(mutating)[:, None], plain, 0)
    assert np.array_equal(flips.astype(np.int64), plain.numpy())


def _k5_ring_copies(W, L, lanes=32):
    """K5's bits body's copies of one warp's gene planes, chunk by chunk
    of ``K5_WORDS`` words: group j holds planes q = 4 j .. 4 j + 3 of the
    chunk (gene 32 w0 + q, row ``(g % 32) W + g // 32``), each lane of the
    16-byte form copying 4 lanes of plane ``lane // 8`` and of the 4-byte
    form its own lane of all 4; its bits go to word ``w0 + j // 8`` at
    ``4 j % 32 + i``. Returns ``[(wide, plane row, lane, word, bit)]``."""
    out = []
    for wide in (True, False):
        for w0 in range(0, W, K5_WORDS):
            P = max(0, min(L, 32 * (w0 + K5_WORDS)) - 32 * w0)
            for j in range(-(-P // 4)):
                for lane in range(32):
                    copies = ([(lane >> 3, 4 * (lane & 7) + a) for a in range(4)]
                              if wide else [(i, lane) for i in range(4)])
                    for i, at in copies:
                        q = 4 * j + i
                        if q < P and at < lanes:
                            g = 32 * w0 + q
                            out.append((wide, (g % 32) * W + g // 32, at,
                                        w0 + (j >> 3), (4 * j & 31) + i))
    return out


@pytest.mark.parametrize("L,W", [(1, 1), (31, 1), (32, 1), (33, 2), (70, 3),
                                 (100, 4), (128, 4), (129, 5), (300, 10),
                                 (33, 8)])
def test_k5_ring_copies_each_real_plane_once_into_its_gene_bit(L, W):
    copies = _k5_ring_copies(W, L)
    for wide in (True, False):
        got = [copy[1:] for copy in copies if copy[0] == wide]
        # every lane of every real plane once, its bit at its gene
        want = [((b * W + w), lane, w, b) for w in range(W) for b in range(32)
                if 32 * w + b < L for lane in range(32)]
        assert len(got) == len(set(got)) == len(want)
        assert set(got) == set(want)


def _k5_items(tiles, grid, ngen):
    """The (generation, tile) items of each block of K5's bits body, in its
    order, with the next item and the one after it as the kernel finds them
    (the next tile of the generation, else the block's first of the next)."""
    def after(tile, gen, block):
        tile += grid
        if tile >= tiles:
            return block, gen + 1
        return tile, gen

    out = []
    for block in range(min(grid, tiles)):
        order = [(g, t) for g in range(ngen)
                 for t in range(block, tiles, grid)]
        for i, (g, t) in enumerate(order):
            nt, ng = after(t, g, block)
            at, ag = after(nt, ng, block)
            out.append((block, (g, t), (ng, nt), (ag, at),
                        order[i + 1] if i + 1 < len(order) else None,
                        order[i + 2] if i + 2 < len(order) else None))
    return out


@pytest.mark.parametrize("tiles,grid,ngen", [(1, 1, 3), (391, 396, 5),
                                             (1172, 396, 3), (7, 3, 4)])
def test_k5_items_cover_each_generation_tile_once_in_order(tiles, grid, ngen):
    items = _k5_items(tiles, grid, ngen)
    done = [item for _, item, *_ in items]
    assert len(done) == len(set(done)) == tiles * ngen
    for _, _, nxt, aft, want_next, want_after in items:
        # past the last generation the kernel reads nothing of that item
        if want_next is not None:
            assert nxt == want_next
        else:
            assert nxt[0] == ngen
        if want_after is not None:
            assert aft == want_after
        else:
            assert aft[0] >= ngen
