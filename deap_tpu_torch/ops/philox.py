"""Counter-based Philox4x32-10 and the counter layout of the kernels'
``prng='hw'`` path.

The TPU kernels of the JAX package draw their bits on the core
(``pltpu.prng_seed`` / ``prng_random_bits``) when ``prng='hw'``. The port
draws them inside its CUDA kernels with Philox4x32-10 (Salmon et al.,
"Parallel random numbers: as easy as 1, 2, 3", SC 2011), written out by
hand in ``csrc/philox.cuh``. :func:`philox4x32_10` here is the plain
version: the same rounds on int64 tensors holding 32-bit words, so the
kernels and their plain versions draw the same bits.

**The counter layout.** A key ``(k0, k1)`` (two uint32 words drawn from
the caller's ``torch.Generator``) and a counter ``(i, j, g, tag)`` give
four words. ``g`` is the generation inside one ``evolve_packed`` call (0
for the one-generation kernels); ``tag`` names the stream:

- ``PAIR_ROW`` ``(row r, 0, g, 0)``: word 0 the crossover gate, words 1-2
  the cut points (the even row of a pair decides for both rows), word 3
  row ``r``'s mutation gate;
- ``GENES`` ``(row r, i // 4, g, 1)``: word ``i % 4`` is gene ``i``'s flip
  draw;
- ``TOURNAMENT`` ``(child c, t // 4, g, 2)``: word ``t % 4`` is aspirant
  ``t``, taken ``% n``;
- ``REAL_GAMMA`` ``(row r & ~1, i // 4, g, 3)``: word ``i % 4`` is the
  blend γ draw of gene ``i`` of K6, shared by the two rows of a pair (the
  counter names the even row);
- ``REAL_NORMAL`` ``(row r, i, g, 4)``: words 0 and 1 are the Box–Muller
  uniforms u1 and u2 of gene ``i`` of K6 (words 2 and 3 are unused).

K6 (the real-valued generation) takes its crossover gate from word 0 of
the even row's ``PAIR_ROW`` call, its mutation gate from word 3 of the
row's own, and each gene's mutation gate from ``GENES`` at K2's flip
coordinates. Each stream is drawn only where it decides something: γ
where the pair mates, the gene gates where the row mutates, the normals
where the gene's gate fires.

A draw depends on its coordinates alone, never on the block or thread
that makes it, so a kernel computes only the draws its decisions need
(the genes of rows that mutate, the planes of real genes) and every
other draw stays what it would have been.

:func:`hw_fused_bits`, :func:`hw_packed_bits`, :func:`hw_tournament_bits`
, :func:`hw_evolve_bits` and :func:`hw_real_bits` expand a key into the
bits-input layouts of the five kernels (``fused_bits``,
``variation_bits``, ``tournament_bits``, ``evolve_bits`` and
``real_bits``), so each kernel's bits-input plain version, fed with
them, is the plain version of its Philox path. Columns a kernel never
reads (the gene planes past ``L`` of packed rows) are zeros.
"""

from __future__ import annotations

import torch

__all__ = ["philox4x32_10", "mulhilo32", "PAIR_ROW", "GENES", "TOURNAMENT",
           "REAL_GAMMA", "REAL_NORMAL", "draws", "hw_fused_bits",
           "hw_packed_bits", "hw_tournament_bits", "hw_evolve_bits",
           "hw_real_bits"]

MASK32 = 0xFFFFFFFF
#: Philox4x32's round multipliers and Weyl key increments (Random123)
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
ROUNDS = 10
#: the stream tags, the counter's last word
PAIR_ROW, GENES, TOURNAMENT, REAL_GAMMA, REAL_NORMAL = 0, 1, 2, 3, 4
WORD = 32


def _u32(x) -> torch.Tensor:
    """An integer tensor (uint32 included) as int64 words in [0, 2^32)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32).to(torch.int64) & MASK32
    return x.to(torch.int64) & MASK32


def mulhilo32(a, b):
    """``(hi, lo)`` 32-bit halves of the 64-bit product of 32-bit words,
    on int64 tensors (or ints) in [0, 2^32). ``b`` is split into 16-bit
    halves so that each partial product stays below 2^48: a product of two
    32-bit words passes 2^63 and would overflow a signed int64."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    lo_part = a * b_lo                       # < 2^48
    hi_part = a * b_hi                       # < 2^48, weight 2^16
    mid = lo_part + ((hi_part & 0xFFFF) << 16)   # < 2^49
    return (hi_part >> 16) + (mid >> 32), mid & MASK32


def philox4x32_10(counter: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Philox4x32-10 of ``counter [..., 4]`` under ``key [..., 2]``
    (broadcast against each other; any integer dtype, taken mod 2^32):
    ``int64 [..., 4]`` words in [0, 2^32). Bit for bit the device function
    ``philox4x32_10`` of ``csrc/philox.cuh``."""
    c = _u32(counter)
    k = _u32(key)
    c0, c1, c2, c3 = c.unbind(-1)
    k0, k1 = k.unbind(-1)
    for r in range(ROUNDS):
        if r:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = mulhilo32(PHILOX_M0, c0)
        hi1, lo1 = mulhilo32(PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.stack([c0, c1, c2, c3], -1)


def draws(key: torch.Tensor, i: torch.Tensor, j, g: int,
          tag: int) -> torch.Tensor:
    """The four words of the counters ``(i, j, g, tag)`` (``i`` and ``j``
    broadcast): ``int64 [*broadcast(i, j), 4]``."""
    i, j = torch.broadcast_tensors(torch.as_tensor(i, device=key.device),
                                   torch.as_tensor(j, device=key.device))
    counter = torch.stack([i, j, torch.full_like(i, g),
                           torch.full_like(i, tag)], -1)
    return philox4x32_10(counter, key)


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    return words.to(torch.uint32)


def _gene_words(key, n: int, length: int, g: int, tag: int = GENES,
                rows=None) -> torch.Tensor:
    """Word ``i % 4`` of call ``i // 4`` of the stream ``tag`` for each
    gene ``i`` of each row (the counter's row word ``rows``, by default
    the row itself): ``int64 [n, length]``."""
    if rows is None:
        rows = torch.arange(n, device=key.device)
    calls = torch.arange(-(-length // 4), device=key.device)[None, :]
    words = draws(key, rows[:, None], calls, g, tag)
    return words.reshape(n, -1)[:, :length]


def _pair_row_words(key, n: int, g: int) -> torch.Tensor:
    """Each row's pair+row call: ``int64 [n, 4]``."""
    return draws(key, torch.arange(n, device=key.device), 0, g, PAIR_ROW)


def hw_fused_bits(key: torch.Tensor, n: int, length: int, g: int = 0):
    """The Philox streams of one fused generation on ``[n, length]`` byte
    genomes, in :func:`ops.kernels.fused_bits`'s layout: ``(pairbits [n,
    4], rowbits [n, 1], genebits [n, length])``, uint32. Row ``r``'s pair
    words are its own pair+row call (the kernels read those of the even
    row of each pair), its row word is that call's word 3."""
    pr = _pair_row_words(key, n, g)
    return (_as_uint32(pr), _as_uint32(pr[:, 3:4]),
            _as_uint32(_gene_words(key, n, length, g)))


def _plane_major(genes: torch.Tensor, W: int) -> torch.Tensor:
    """``[n, L]`` per-gene words → the packed kernels' ``[n, 32 W]``
    layout (gene ``i`` at column ``(i % 32) W + i // 32``), zeros past
    gene ``L``."""
    n, length = genes.shape
    full = torch.nn.functional.pad(genes, (0, WORD * W - length))
    return full.reshape(n, W, WORD).transpose(1, 2).reshape(n, WORD * W)


def hw_packed_bits(key: torch.Tensor, n: int, W: int, length: int,
                   g: int = 0):
    """The Philox streams of one packed generation, in
    :func:`ops.packed.variation_bits`' layout: ``(pairbits [n, 4], rowbits
    [n, 1], genebits [n, 32 W])``, uint32; the planes past gene ``length``
    are zeros (the kernels never read them)."""
    pr = _pair_row_words(key, n, g)
    return (_as_uint32(pr), _as_uint32(pr[:, 3:4]), _as_uint32(
        _plane_major(_gene_words(key, n, length, g), W)))


def hw_tournament_bits(key: torch.Tensor, tournsize: int, n: int,
                       g: int = 0) -> torch.Tensor:
    """The Philox aspirant draws of ``n`` tournaments, in
    :func:`ops.packed.tournament_bits`' layout: ``uint32 [tournsize, n]``,
    aspirant ``t`` of child ``c`` at ``[t, c]``."""
    children = torch.arange(n, device=key.device)[:, None]
    calls = torch.arange(-(-tournsize // 4), device=key.device)[None, :]
    words = draws(key, children, calls, g, TOURNAMENT).reshape(n, -1)
    return _as_uint32(words[:, :tournsize].T.contiguous())


def hw_evolve_bits(key: torch.Tensor, ngen: int, tournsize: int, n: int,
                   length: int):
    """The Philox streams of one ``evolve_packed`` call of ``ngen``
    generations (generation ``g`` with counter word ``g``), in
    :func:`ops.packed.evolve_bits`' lane-major layout: ``(sel [ngen,
    tournsize, n], pair [ngen, 3, n], row [ngen, 1, n], gene [ngen, 32 W,
    n])``, uint32."""
    W = -(-length // WORD)
    sel, pair, row, gene = [], [], [], []
    for g in range(ngen):
        sel.append(hw_tournament_bits(key, tournsize, n, g))
        p, r, gb = hw_packed_bits(key, n, W, length, g)
        pair.append(p[:, :3].T)
        row.append(r.T)
        gene.append(gb.T)
    return tuple(torch.stack(s).contiguous() for s in (sel, pair, row, gene))


def hw_real_bits(key: torch.Tensor, n: int, L: int, g: int = 0):
    """The Philox streams of one K6 generation on ``[n, L]`` float32
    genomes, in :func:`ops.kernels_real.real_bits`' layout: ``(pairbits
    [n, 4], rowbits [n, 1], genebits [n, 4 L])``, uint32, gene planes γ,
    gate, u1, u2 in columns ``[p L, (p+1) L)``. Row ``r``'s γ plane is its
    pair's (the ``REAL_GAMMA`` calls of row ``r & ~1``), its gate plane
    the ``GENES`` words, u1 and u2 words 0 and 1 of its ``REAL_NORMAL``
    calls. The kernel makes only the draws its decisions need; this
    expands every one."""
    rows = torch.arange(n, device=key.device)
    pr = _pair_row_words(key, n, g)
    gamma = _gene_words(key, n, L, g, REAL_GAMMA, rows & ~1)
    gate = _gene_words(key, n, L, g, GENES)
    normal = draws(key, rows[:, None], torch.arange(L, device=key.device),
                   g, REAL_NORMAL)
    genebits = torch.cat([gamma, gate, normal[..., 0], normal[..., 1]], 1)
    return _as_uint32(pr), _as_uint32(pr[:, 3:4]), _as_uint32(genebits)
