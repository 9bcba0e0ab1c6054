"""K4's and K6's bits bodies (``prng='input'``) held against the JAX
package's on the CPU, at the shapes their card designs branch on.

``sel_tournament_gather_packed`` (K4) and ``fused_variation_eval_real``
(K6) on CPU tensors run their plain versions; ``deap_tpu``'s Pallas
kernels run in interpret mode with their bits-input path, and the port is
fed the very draws those kernels make from their key (cut to the port's
``n`` lanes or rows and ``L`` columns). The shapes: K6 at n 1, 2, 3 and
either side of a 64-row tile and of two, by L 1, 30, 31, 33 and 64 (one
column chunk of 32 and several), the rates at 0 and 1, both evaluations;
K4 at n 1, 31, 33, 257 and 1001 with tournaments of 1 to 9 (1 to 3 batches
of 4 aspirants, the last part full), fitness drawn from a few integer
values so that ties decide. The JAX K6 runs on a grid of two tiles
(``_real_block``). Tolerances: K4 bitwise; K6's genes that no
mutation touched bitwise, mutated genes within ``STEP_ULPS`` units in the
last place of their step plus one of the gene, fitness within ``FIT_RTOL``
(``kernels_real.real_kernel_errors``).

The card kernels split their work by index arithmetic that the CPU cannot
run; the last tests replay it in numpy: K6's tile (its lists of mating
pairs and mutating rows, each mating pair's gamma words taken once, each
mutating row's gate words once, each step on its own gene, each child and
each fitness written once by the thread that holds it) on its two draw
sources, the bits body's (gamma words loaded by the thread that crosses
them, a mutating row's u1 and u2 words read with its gates) and the
Philox path's (gamma words made by the items, one normal call a gated
gene), at tiles of 16, 32 and 64 rows over 64, 128 and 256 threads; and
K4's tournament in batches of 4 aspirants, which picks the serial rule's
winner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu.ops import packed as jp
from deap_tpu.ops.kernels_real import fused_variation_eval_real as j_real
from deap_tpu_torch.ops import kernels_real as tkr
from deap_tpu_torch.ops import packed as tp




def T(a):
    return torch.from_numpy(np.array(a))


def _round_up(x, m):
    return -(-x // m) * m


# ------------------------------------------- K6 fused_variation_eval_real --

def _real_block(n):
    """The JAX kernel's row tile: two grid steps from n 3 on. Run as one
    step, XLA compiles its body with other contractions and approximations
    (jax 0.9 on the CPU, tiles of 64 rows at n 3 to 64: crossed genes 1 ulp
    off the two multiply-adds, mutated genes up to 14 units of their step
    plus one of the gene apart), and no longer computes the arithmetic
    that K6's tolerance describes."""
    return _round_up(-(-n // 2), 2)


def _real_streams(key, n, L):
    """``run_fused_kernel``'s bits for ``n`` rows: pair, row, and the four
    gene planes cut to ``L`` real columns each."""
    ni, Lp = _round_up(n, _real_block(n)), _round_up(L, 128)
    k1, k2, k3 = jax.random.split(key, 3)
    pair = jax.random.bits(k1, (ni, 4), jnp.uint32)[:n]
    row = jax.random.bits(k2, (ni, 1), jnp.uint32)[:n]
    gene = np.asarray(jax.random.bits(k3, (ni, tkr.PLANES * Lp), jnp.uint32))
    gene = gene[:n].reshape(n, tkr.PLANES, Lp)[:, :, :L].reshape(n, -1)
    return T(pair), T(row), T(gene)


RATES = {"main": (0.5, 0.2, 0.1), "none": (0.0, 0.0, 0.1),
         "all": (1.0, 1.0, 1.0), "ungated": (1.0, 1.0, 0.0),
         "mutate only": (0.0, 1.0, 0.5)}


@pytest.mark.parametrize("n,L,rates", [
    (1, 30, ("main", "all")),
    (1, 64, ("ungated", "mutate only")),
    (2, 1, ("all", "none")),
    (2, 33, ("main", "ungated")),
    (3, 31, ("all", "mutate only")),
    (63, 30, ("main", "none")),
    (63, 64, ("all", "main")),
    (64, 31, ("main", "ungated")),
    (64, 33, ("mutate only", "all")),
    (65, 1, ("main", "all")),
    (65, 30, ("ungated", "main")),
    (129, 33, ("all", "main")),
    (129, 64, ("main", "none")),
])
def test_k6_bits_body_matches_jax(n, L, rates):
    g = np.random.default_rng(n * 7 + L).uniform(-5.12, 5.12, (n, L))
    g = g.astype(np.float32)
    for i, name in enumerate(rates):
        cxpb, mutpb, indpb = RATES[name]
        evaluate = ("rastrigin", "sphere")[(n + L + i) % 2]
        kw = dict(cxpb=cxpb, mutpb=mutpb, indpb=indpb, alpha=0.5, mu=0.0,
                  sigma=0.3, evaluate=evaluate)
        key = jax.random.key(n * 131 + L * 3 + i)
        want = j_real(key, jnp.asarray(g), **kw, prng="input",
                      interpret=True, block_i=_real_block(n))
        bits = _real_streams(key, n, L)
        got = tkr.fused_variation_eval_real(T(g), *bits, **kw)
        errs = tkr.real_kernel_errors(
            got, (T(want[0]), T(want[1])), *bits, mutpb=mutpb, indpb=indpb,
            mu=0.0, sigma=0.3)
        assert errs["ok"], (name, evaluate, errs)
        if cxpb == 0.0 and mutpb == 0.0:
            assert got[0].numpy().tobytes() == g.tobytes()


# ------------------------------------ K4 sel_tournament_gather_packed --

@pytest.mark.parametrize("n,tournsizes", [
    (1, (1, 4, 9)), (31, (2, 5, 8)), (33, (3, 6, 9)), (257, (1, 4, 7)),
    (1001, (3, 5, 8))])
def test_k4_bits_body_matches_jax(n, tournsizes):
    rng = np.random.default_rng(n)
    packed = jp.pack_genomes(jnp.asarray(rng.random((n, 100)) < 0.5))
    fit = rng.integers(-2, 3, n).astype(np.float32)  # ties decide
    for ts in tournsizes:
        key = jax.random.key(n * 11 + ts)
        want = jp.sel_tournament_gather_packed(key, packed, jnp.asarray(fit),
                                               tournsize=ts, prng="input",
                                               interpret=True)
        ni = _round_up(n, 128)
        draws = jax.random.bits(key, (ts, ni), jnp.uint32)[:, :n]
        got = tp.sel_tournament_gather_packed(T(packed), T(fit), T(draws))
        assert got.numpy().tobytes() == np.asarray(want).tobytes(), ts


# ----------------------------------- the card kernels' index arithmetic --

K6_CHUNK, K6_ITEM = 32, 4


def _u01(words):
    return (np.asarray(words, np.uint64) >> np.uint64(8)).astype(
        np.float64) / 2.0 ** 24


# K6's draw sources: whether the tile's items make the gamma words (else
# the thread that crosses a mating pair's column loads its word), and
# whether a mutating row's u1 and u2 words are taken with its gates for
# every column (else once a gated gene)
K6_SOURCES = {"bits": dict(gamma_items=False, together=True),
              "philox": dict(gamma_items=True, together=False)}


def _k6_tile_replay(pairbits, rowbits, genebits, n, L, cxpb, mutpb, indpb,
                    threads, rows, source):
    """K6's tile kernel on draw source ``source``, tile by tile of ``rows``
    rows, as the kernel's ``threads`` walk it: phase A's decisions and
    lists (ascending row), phase B's items (item ``i`` of thread ``i %
    threads``: where the source's items make the gamma words, the first
    ``pairs * 8`` are (mating pair, 4 columns); then (mutating row, 4
    columns)), the gamma words that phase C's thread of a mating pair's
    column loads otherwise, and phase C's and the row sums' thread of each
    child and fitness. Returns the draw words taken ``{(what, row,
    column): count}``, the steps' genes ``{(row, column): count}``, and
    the (row, column) of each child store and the row of each fitness
    store."""
    gamma_items, together = (K6_SOURCES[source][k]
                             for k in ("gamma_items", "together"))
    reads, steps, stores, fits = {}, {}, [], []
    cxpb, mutpb, indpb = (np.float32(p) for p in (cxpb, mutpb, indpb))

    def read(what, r, c):
        reads[(what, r, c)] = reads.get((what, r, c), 0) + 1

    warps = threads // 32
    pairs_per_warp = rows // 2 // warps
    chunks = -(-L // K6_CHUNK)
    calls = -(-L // K6_ITEM)
    planes = np.asarray(genebits).reshape(n, 4, L)
    for row0 in range(0, n, rows):
        mates, mut = [False] * rows, [False] * rows
        for t in range(rows):
            r = row0 + t
            if r >= n:
                continue
            read("row", r, 0)
            if r % 2 == 0:
                read("pair", r, 0)
                mates[t] = (r | 1) < n and _u01(pairbits[r, 0]) < cxpb
            mut[t] = _u01(rowbits[r, 0]) < mutpb
        pair_slots = [t for t in range(rows) if mates[t]]
        mut_slots = [t for t in range(rows) if mut[t]]
        for w0 in range(chunks):
            q0 = w0 * (K6_CHUNK // K6_ITEM)
            chunk_calls = min(calls - q0, K6_CHUNK // K6_ITEM)
            if not gamma_items:  # thread (warp, lane) of pairs warp + warps k
                for warp in range(warps):
                    for lane in range(32):
                        for k in range(pairs_per_warp):
                            t = 2 * (warp + warps * k)
                            if mates[t] and w0 * K6_CHUNK + lane < L:
                                read("gamma", row0 + t, w0 * K6_CHUNK + lane)
            n_gamma = len(pair_slots) * 8 if gamma_items else 0
            total = n_gamma + len(mut_slots) * 8
            for tid in range(threads):
                for i in range(tid, total, threads):
                    is_gamma = i < n_gamma
                    item = i if is_gamma else i - n_gamma
                    q = item & 7
                    if q >= chunk_calls:
                        continue
                    t = (pair_slots if is_gamma else mut_slots)[item // 8]
                    r, call = row0 + t, q0 + q
                    live = [k for k in range(4) if 4 * call + k < L]
                    if is_gamma:
                        for k in live:
                            read("gamma", r, 4 * call + k)
                        continue
                    gated = [k for k in live
                             if _u01(planes[r, 1, 4 * call + k]) < indpb]
                    for k in live:
                        read("gate", r, 4 * call + k)
                    for k in (live if together else gated):
                        read("u1", r, 4 * call + k)
                        read("u2", r, 4 * call + k)
                    for k in gated:
                        # step slot [t][4 q + k] of the chunk
                        col = w0 * K6_CHUNK + 4 * q + k
                        steps[(row0 + t, col)] = steps.get(
                            (row0 + t, col), 0) + 1
            # phase C: thread (warp, lane), pairs warp + warps k
            for warp in range(warps):
                for lane in range(32):
                    c = w0 * K6_CHUNK + lane
                    for k in range(pairs_per_warp):
                        r = row0 + 2 * (warp + warps * k)
                        if c < L:
                            stores += [(rr, c) for rr in (r, r + 1) if rr < n]
        # the row sums: lane % lanes == 0 of each warp writes row j
        lanes = 32 // (2 * pairs_per_warp)
        for warp in range(warps):
            for lane in range(0, 32, lanes):
                j = lane // lanes
                r = row0 + 2 * (warp + warps * (j >> 1)) + (j & 1)
                if r < n:
                    fits.append(r)
    return reads, steps, stores, fits


@pytest.mark.parametrize("source", sorted(K6_SOURCES))
@pytest.mark.parametrize("threads,rows", [(64, 16), (128, 32), (256, 64),
                                          (128, 64)])
@pytest.mark.parametrize("n,L,rates", [
    (1, 1, (0.5, 0.5, 0.5)), (2, 1, (1.0, 1.0, 1.0)),
    (3, 30, (1.0, 1.0, 0.3)), (16, 31, (0.5, 0.5, 0.5)),
    (17, 32, (1.0, 0.0, 1.0)), (64, 30, (0.0, 1.0, 0.1)),
    (65, 30, (0.5, 0.2, 0.1)), (129, 33, (0.5, 0.6, 0.3)),
    (200, 64, (1.0, 1.0, 1.0)), (130, 70, (0.0, 0.0, 0.5)),
    (63, 65, (0.5, 0.5, 0.0)), (257, 96, (0.5, 0.2, 0.1))])
def test_k6_tile_reads_each_draw_once_and_steps_its_own_gene(
        n, L, rates, threads, rows, source):
    cxpb, mutpb, indpb = (np.float32(p) for p in rates)
    rng = np.random.default_rng(n * 100 + L)
    pairbits = rng.integers(0, 2 ** 32, (n, 4), dtype=np.uint64)
    rowbits = rng.integers(0, 2 ** 32, (n, 1), dtype=np.uint64)
    genebits = rng.integers(0, 2 ** 32, (n, 4 * L), dtype=np.uint64)
    reads, steps, stores, fits = _k6_tile_replay(
        pairbits, rowbits, genebits, n, L, cxpb, mutpb, indpb, threads,
        rows, source)
    assert set(reads.values()) <= {1}  # no word read twice
    # the decisions and gates the plain version takes from the same draws
    u32 = torch.from_numpy(genebits.astype(np.uint32))
    planes = tkr._u01(tkr._words(u32)).reshape(n, 4, L).numpy()
    mates_even = ((np.arange(n) | 1) < n) & (_u01(pairbits[:, 0]) < cxpb)
    mating = [r for r in range(0, n, 2) if mates_even[r]]
    mutating = np.flatnonzero(_u01(rowbits[:, 0]) < mutpb)
    gate = (_u01(rowbits[:, 0:1]) < mutpb) & (planes[:, 1] < indpb)
    want = {("row", r, 0) for r in range(n)}
    want |= {("pair", r, 0) for r in range(0, n, 2)}
    want |= {("gamma", r, c) for r in mating for c in range(L)}
    want |= {("gate", r, c) for r in mutating for c in range(L)}
    normals = ([(r, c) for r in mutating for c in range(L)]
               if K6_SOURCES[source]["together"]
               else list(zip(*np.nonzero(gate))))
    want |= {(w, int(r), int(c)) for r, c in normals for w in ("u1", "u2")}
    assert set(reads) == want
    # each step on its own gene, once: the plain version's gated genes
    assert set(steps.values()) <= {1}
    assert set(steps) == {(int(r), int(c)) for r, c in zip(*np.nonzero(gate))}
    # each child and each fitness stored once, all of them
    assert sorted(stores) == [(r, c) for r in range(n) for c in range(L)]
    assert sorted(fits) == list(range(n))


def _batched_tournament(fit, idx):
    """K4's tournament for one child (``philox.cuh::tournament`` fed by
    ``loaded_aspirants``): the aspirants 4 at a time, those past the
    tournament read as index 0 and fitness 0, the first aspirant the best
    so far, then in each batch those below the tournament size with a
    strictly greater fitness."""
    ts = len(idx)
    batches = -(-ts // 4)
    a_idx = [int(idx[t]) if t < ts else 0 for t in range(4 * batches)]
    a_fit = [fit[a_idx[t]] if t < ts else np.float32(0.0)
             for t in range(4 * batches)]
    best, best_fit = a_idx[0], a_fit[0]
    for call in range(batches):
        for k in range(4):
            t = 4 * call + k
            if t < ts and a_fit[t] > best_fit:
                best, best_fit = a_idx[t], a_fit[t]
    return best


@pytest.mark.parametrize("tournsize", range(1, 10))
def test_k4_batched_tournament_picks_the_serial_winner(tournsize):
    rng = np.random.default_rng(tournsize)
    n = 37
    # a few values, all below the 0.0 that padded aspirants read as, so
    # that ties decide and a padded aspirant compared by mistake would win
    fit = rng.integers(-3, 0, n).astype(np.float32)
    draws = rng.integers(0, 2 ** 32, (tournsize, 500), dtype=np.uint64)
    want = tp.sel_tournament_gather_packed_plain(
        torch.arange(n, dtype=torch.int32).view(torch.uint32)[:, None],
        torch.from_numpy(fit),
        torch.from_numpy(draws.astype(np.uint32)))
    idx = draws % np.uint64(n)
    got = [_batched_tournament(fit, idx[:, j]) for j in range(idx.shape[1])]
    assert got == want.view(torch.int32)[:, 0].tolist()
