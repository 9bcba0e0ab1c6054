"""Bit-packed bitstring populations — 32 genes per uint32 word.

Port of :mod:`deap_tpu.ops.packed`: the word-level helpers (packing,
popcount, segment masks, two-point crossover and flip-bit mutation on
words) and three CUDA kernels,

- :func:`fused_variation_eval_packed` (K3, ``csrc/packed_variation.cu``):
  one OneMax generation on packed rows — adjacent-pair two-point
  crossover, flip-bit mutation, popcount fitness;
- :func:`sel_tournament_gather_packed` (K4, ``csrc/selgather_packed.cu``):
  tournament selection of the parents plus the gather of their rows;
- :func:`evolve_packed` (K5, ``csrc/evolve_packed.cu``): ``ngen`` whole
  generations of both in one launch, the population resident on the
  card.

Each takes its random bits as uint32 tensors in the layout of the TPU
kernels' bits-input path (``prng='input'``; :func:`variation_bits`,
:func:`tournament_bits` and :func:`evolve_bits` draw them with a
``torch.Generator``), or makes them inside the kernel with Philox from a
key drawn from a generator (``prng='hw'``; the counter layout of
:mod:`deap_tpu_torch.ops.philox`). Each runs its kernel on CUDA tensors
and its plain PyTorch version (``*_plain``) on CPU tensors; under
``'hw'`` the plain version takes the bits ``ops.philox`` expands from the
key, the same bits the kernel makes.

Packed words are ``torch.uint32`` at every public boundary. torch's
uint32 has no shifts, adds, modulo or comparisons, so the plain versions
compute on int64 copies of the words (``& 0xFFFFFFFF``) and convert back.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from deap_tpu_torch import _build
from deap_tpu_torch.ops import philox
from deap_tpu_torch.ops.crossover import _two_points
from deap_tpu_torch.ops.kernels import (
    _check_cuda,
    _f32,
    _pair_decisions,
    _partner_rows,
    _prng_mode,
    _u01,
    _uint32_bits,
    _words,
    fused_bits,
)

__all__ = [
    "pack_genomes",
    "unpack_genomes",
    "popcount",
    "packed_fitness",
    "segment_mask_words",
    "cx_two_point_packed",
    "flip_words",
    "mut_flip_bit_packed",
    "variation_bits",
    "tournament_bits",
    "evolve_bits",
    "fused_variation_eval_packed",
    "fused_variation_eval_packed_plain",
    "sel_tournament_gather_packed",
    "sel_tournament_gather_packed_plain",
    "evolve_packed",
    "evolve_packed_plain",
]

WORD = 32
_MASK32 = 0xFFFFFFFF


def words_for(length: int) -> int:
    return -(-length // WORD)


def _as_uint32(words: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → torch.uint32."""
    return words.to(torch.uint32)


def _bit_weights(device) -> torch.Tensor:
    return torch.ones(WORD, dtype=torch.int64, device=device) << torch.arange(
        WORD, device=device)


def pack_genomes(bits: torch.Tensor) -> torch.Tensor:
    """``[..., L]`` 0/1 tensor → ``uint32[..., ceil(L/32)]``; bit ``k`` of
    word ``j`` is gene ``32j + k``. Tail bits of the last word are 0."""
    L = bits.shape[-1]
    W = words_for(L)
    b = torch.nn.functional.pad(bits.to(torch.int64), (0, W * WORD - L))
    b = b.reshape(*bits.shape[:-1], W, WORD)
    return _as_uint32((b * _bit_weights(bits.device)).sum(-1))


def unpack_genomes(packed: torch.Tensor, length: int) -> torch.Tensor:
    """Inverse of :func:`pack_genomes` → ``bool[..., length]``."""
    shifts = torch.arange(WORD, device=packed.device)
    bits = (_words(packed)[..., :, None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * WORD)[
        ..., :length].to(torch.bool)


def _popcount64(v: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 words holding 32-bit values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & _MASK32) >> 24


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-word set-bit count (uint32 in, uint32 out)."""
    return _as_uint32(_popcount64(_words(words)))


def packed_fitness(packed: torch.Tensor) -> torch.Tensor:
    """OneMax fitness: set bits per row → float32."""
    return _popcount64(_words(packed)).sum(-1).to(torch.float32)


def _bits_below(k: torch.Tensor) -> torch.Tensor:
    """int64 words with bits [0, clip(k, 0, 32)) set."""
    k = k.to(torch.int64)
    low = (torch.ones_like(k) << k.clamp(0, WORD - 1)) - 1
    return torch.where(k >= WORD, _MASK32, torch.where(k <= 0, 0, low))


def _segment_words(lo: torch.Tensor, hi: torch.Tensor, W: int) -> torch.Tensor:
    starts = torch.arange(W, device=lo.device) * WORD
    lo = lo[..., None].to(torch.int64) - starts
    hi = hi[..., None].to(torch.int64) - starts
    return _bits_below(hi) & ~_bits_below(lo) & _MASK32


def segment_mask_words(lo: torch.Tensor, hi: torch.Tensor,
                       W: int) -> torch.Tensor:
    """Per-word masks of the gene range ``[lo, hi)``: ``uint32[..., W]``."""
    return _as_uint32(_segment_words(lo, hi, W))


def _flip_from_planes(planes: torch.Tensor, length: int) -> torch.Tensor:
    """int64 flip words from a per-gene 0/1 mask ``[..., 32, W]`` (bit
    ``b`` of word ``j`` at ``[..., b, j]``); bits at and past gene
    ``length`` are clear."""
    W = planes.shape[-1]
    words = (planes.to(torch.int64)
             * _bit_weights(planes.device)[:, None]).sum(-2)
    starts = torch.arange(W, device=planes.device) * WORD
    return words & _bits_below(length - starts)


def _cx_two_point_packed(g1, g2, lo, hi):
    """:func:`cx_two_point_packed` on given segments ``[lo, hi)``."""
    m = _segment_words(lo, hi, g1.shape[-1])
    a, b = _words(g1), _words(g2)
    keep = ~m & _MASK32
    return _as_uint32((a & keep) | (b & m)), _as_uint32((b & keep) | (a & m))


def cx_two_point_packed(generator: torch.Generator, g1: torch.Tensor,
                        g2: torch.Tensor, length: int):
    """Two-point crossover on packed rows ``uint32[m, W]``: the segment
    of each pair, drawn as ``cx_two_point`` draws it (``_two_points``),
    swapped through word masks."""
    lo, hi = _two_points(generator, g1.shape[0], length)
    return _cx_two_point_packed(g1, g2, lo, hi)


def _flip_words(u: torch.Tensor, indpb: float, length: int) -> torch.Tensor:
    """:func:`flip_words` on given per-bit uniforms ``[..., W, 32]``."""
    planes = (u < _f32(indpb)).transpose(-1, -2)
    return _as_uint32(_flip_from_planes(planes, length))


def flip_words(generator: torch.Generator, shape_words, indpb: float,
               length: int) -> torch.Tensor:
    """Bernoulli(indpb) per gene, packed: ``uint32[*shape_words]`` from
    one uniform draw per bit position (``[*shape_words, 32]``), so each
    bit has exactly probability ``indpb``. Bits past ``length`` are never
    set."""
    u = torch.rand((*shape_words, WORD), generator=generator,
                   device=generator.device)
    return _flip_words(u, indpb, length)


def mut_flip_bit_packed(generator: torch.Generator, g: torch.Tensor,
                        indpb: float, length: int) -> torch.Tensor:
    """Flip-bit mutation on packed rows: XOR with
    :func:`flip_words` of the rows' shape."""
    flip = flip_words(generator, g.shape, indpb, length)
    return _as_uint32(_words(g) ^ _words(flip))


# ------------------------------------------------------------- draws ----

def variation_bits(generator: torch.Generator, n: int, W: int):
    """The bit streams of one :func:`fused_variation_eval_packed` call:
    ``(pairbits [n, 4], rowbits [n, 1], genebits [n, 32 W])``."""
    return fused_bits(generator, n, WORD * W)


def tournament_bits(generator: torch.Generator, tournsize: int,
                    n: int) -> torch.Tensor:
    """Aspirant draws of :func:`sel_tournament_gather_packed`:
    ``uint32[tournsize, n]``."""
    return _uint32_bits(generator, (tournsize, n))


def evolve_bits(generator: torch.Generator, ngen: int, tournsize: int,
                n: int, W: int):
    """The draws of one :func:`evolve_packed` call, lane-major as the TPU
    kernel takes them: ``(sel [ngen, tournsize, n], pair [ngen, 3, n],
    row [ngen, 1, n], gene [ngen, 32 W, n])``, uint32, bit plane ``b`` of
    word ``w`` in row ``b W + w`` of ``gene``."""
    return (_uint32_bits(generator, (ngen, tournsize, n)),
            _uint32_bits(generator, (ngen, 3, n)),
            _uint32_bits(generator, (ngen, 1, n)),
            _uint32_bits(generator, (ngen, WORD * W, n)))


# ---------------------------------------------- variation + evaluation ----

def fused_variation_eval_packed_plain(packed, length, pairbits, rowbits,
                                      genebits, *, cxpb, mutpb, indpb):
    """Plain PyTorch version of :func:`fused_variation_eval_packed`
    (``pairbits`` may be ``[n, 3]``: word 3 is never read)."""
    n, W = packed.shape
    g = _words(packed)
    do_cx, lo, hi = _pair_decisions(pairbits, length, cxpb)
    seg = torch.where(do_cx[:, None], _segment_words(lo, hi, W), 0)
    child = (g & ~seg & _MASK32) | (_partner_rows(g) & seg)

    do_mut = _u01(_words(rowbits))[:, 0:1] < _f32(mutpb)
    geneu = _u01(_words(genebits)).reshape(n, WORD, W)  # plane b, word j
    flip = _flip_from_planes(geneu < _f32(indpb), length)
    child = child ^ torch.where(do_mut, flip, 0)
    fit = _popcount64(child).sum(-1).to(torch.float32)
    return _as_uint32(child), fit


def fused_variation_eval_packed(packed: torch.Tensor, length: int,
                                pairbits: Optional[torch.Tensor] = None,
                                rowbits: Optional[torch.Tensor] = None,
                                genebits: Optional[torch.Tensor] = None, *,
                                cxpb: float, mutpb: float, indpb: float,
                                prng: Optional[str] = None,
                                generator: Optional[torch.Generator] = None,
                                key: Optional[torch.Tensor] = None,
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One OneMax generation on packed rows: adjacent pairs (0,1),
    (2,3), ... swap a two-point segment with probability ``cxpb`` (the
    even row's ``pairbits`` decide for both; an odd last row never mates),
    each row mutates with probability ``mutpb`` flipping each gene with
    probability ``indpb``, and fitness is the popcount.

    :param packed: ``uint32[n, W]`` rows from :func:`pack_genomes`.
    :param pairbits, rowbits, genebits: ``uint32`` ``[n, 4]``, ``[n, 1]``,
        ``[n, 32 W]`` (bit plane ``b`` of word ``j`` in column ``b W + j``),
        e.g. from :func:`variation_bits`: the bits of ``prng='input'``.
    :param prng, generator, key: as in
        :func:`deap_tpu_torch.ops.kernels.fused_variation_eval`; a
        generation of the packed loop passes the ``key`` its
        :func:`sel_tournament_gather_packed` used.
    :returns: ``(children uint32[n, W], fitness f32[n])``; the wrapper's
        ``launches`` counts every launch, ``hw_launches`` those of the
        Philox path.
    """
    dev = packed.device
    mode, key = _prng_mode("fused_variation_eval_packed", prng, dev,
                           (pairbits, rowbits, genebits), generator, key)
    n, W = packed.shape
    if dev.type == "cpu":
        if mode == "hw":
            pairbits, rowbits, genebits = philox.hw_packed_bits(key, n, W,
                                                                length)
        return fused_variation_eval_packed_plain(
            packed, length, pairbits, rowbits, genebits, cxpb=cxpb,
            mutpb=mutpb, indpb=indpb)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not 0 < length <= W * WORD:
        raise ValueError(f"length {length} does not fit {W} words")
    _check_cuda("packed", dev, torch.uint32, (n, W), packed)
    if mode == "input":
        _check_cuda("pairbits", dev, torch.uint32, (n, 4), pairbits)
        _check_cuda("rowbits", dev, torch.uint32, (n, 1), rowbits)
        _check_cuda("genebits", dev, torch.uint32, (n, WORD * W), genebits)
    out = torch.empty((n, W), dtype=torch.uint32, device=dev)
    fit = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out, fit
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    probs = (_f32(cxpb), _f32(mutpb), _f32(indpb))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "hw":
        fn = _build.function("packed_variation", "packed_variation_hw",
                             [P] * 4 + [I, I, I, F, F, F, P])
        err = fn(packed.data_ptr(), key.data_ptr(), out.data_ptr(),
                 fit.data_ptr(), n, W, length, *probs, stream)
        fused_variation_eval_packed.hw_launches += 1
    else:
        fn = _build.function("packed_variation", "packed_variation",
                             [P] * 6 + [I, I, I, F, F, F, P])
        err = fn(packed.data_ptr(), pairbits.data_ptr(), rowbits.data_ptr(),
                 genebits.data_ptr(), out.data_ptr(), fit.data_ptr(), n, W,
                 length, *probs, stream)
    fused_variation_eval_packed.launches += 1
    _build.check("packed_variation", err, "fused_variation_eval_packed")
    return out, fit


fused_variation_eval_packed.launches = 0
fused_variation_eval_packed.hw_launches = 0


# ------------------------------------------------ selection + gather ----

def sel_tournament_gather_packed_plain(packed: torch.Tensor, fit: torch.Tensor,
                                       draws: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`sel_tournament_gather_packed`."""
    n = packed.shape[0]
    idx = _words(draws) % n
    best = idx[0]
    best_fit = fit[best]
    for t in range(1, idx.shape[0]):
        f = fit[idx[t]]
        better = f > best_fit
        best = torch.where(better, idx[t], best)
        best_fit = torch.where(better, f, best_fit)
    return packed.view(torch.int32)[best].view(torch.uint32)


def sel_tournament_gather_packed(packed: torch.Tensor, fit: torch.Tensor,
                                 draws: Optional[torch.Tensor] = None, *,
                                 tournsize: int = 3,
                                 prng: Optional[str] = None,
                                 generator: Optional[torch.Generator] = None,
                                 key: Optional[torch.Tensor] = None,
                                 ) -> torch.Tensor:
    """Tournament-select ``n`` parents and gather their rows: child slot
    ``j``'s aspirant ``t`` is ``draws[t, j] % n``; a strictly greater
    fitness wins, so the first drawn wins ties.

    :param packed: ``uint32[n, W]``; ``fit``: ``f32[n]`` (weighted first
        objective); ``draws``: ``uint32[tournsize, n]``, e.g. from
        :func:`tournament_bits`: the bits of ``prng='input'``, whose
        first size is the tournament size.
    :param tournsize: aspirants per tournament under ``prng='hw'``.
    :param prng, generator, key: as in
        :func:`deap_tpu_torch.ops.kernels.fused_variation_eval`.
    :returns: ``uint32[n, W]`` parent rows, one per child slot; the
        wrapper's ``launches`` counts every launch, ``hw_launches`` those
        of the Philox path.
    """
    dev = packed.device
    mode, key = _prng_mode("sel_tournament_gather_packed", prng, dev,
                           (draws,), generator, key)
    n, W = packed.shape
    if mode == "input":
        tournsize = draws.shape[0]
    if tournsize < 1:
        raise ValueError("tournsize must be at least 1")
    if dev.type == "cpu":
        if mode == "hw":
            draws = philox.hw_tournament_bits(key, tournsize, n)
        return sel_tournament_gather_packed_plain(packed, fit, draws)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda("packed", dev, torch.uint32, (n, W), packed)
    _check_cuda("fit", dev, torch.float32, (n,), fit)
    if mode == "input":
        _check_cuda("draws", dev, torch.uint32, (tournsize, n), draws)
    out = torch.empty((n, W), dtype=torch.uint32, device=dev)
    if n == 0:
        return out
    P, I = _build.PTR, _build.INT
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "hw":
        fn = _build.function("selgather_packed", "selgather_packed_hw",
                             [P] * 4 + [I, I, I, P])
        err = fn(packed.data_ptr(), fit.data_ptr(), key.data_ptr(),
                 out.data_ptr(), n, W, tournsize, stream)
        sel_tournament_gather_packed.hw_launches += 1
    else:
        fn = _build.function("selgather_packed", "selgather_packed",
                             [P] * 4 + [I, I, I, P])
        err = fn(packed.data_ptr(), fit.data_ptr(), draws.data_ptr(),
                 out.data_ptr(), n, W, tournsize, stream)
    sel_tournament_gather_packed.launches += 1
    _build.check("selgather_packed", err, "sel_tournament_gather_packed")
    return out


sel_tournament_gather_packed.launches = 0
sel_tournament_gather_packed.hw_launches = 0


# ------------------------------------------------- whole generations ----

def evolve_packed_plain(packed, fit, length, sel, pair, row, gene, *, cxpb,
                        mutpb, indpb):
    """Plain PyTorch version of :func:`evolve_packed`: per generation, the
    K4 and K3 plain versions on that generation's draws, turned
    row-major."""
    fit = fit.to(torch.float32)
    for g in range(sel.shape[0]):
        parents = sel_tournament_gather_packed_plain(packed, fit, sel[g])
        packed, fit = fused_variation_eval_packed_plain(
            parents, length, pair[g].T, row[g].T, gene[g].T, cxpb=cxpb,
            mutpb=mutpb, indpb=indpb)
    return packed, fit


def evolve_packed(packed: torch.Tensor, fit: torch.Tensor, length: int,
                  sel: Optional[torch.Tensor] = None,
                  pair: Optional[torch.Tensor] = None,
                  row: Optional[torch.Tensor] = None,
                  gene: Optional[torch.Tensor] = None, *, cxpb: float,
                  mutpb: float, indpb: float, ngen: Optional[int] = None,
                  tournsize: int = 3, prng: Optional[str] = None,
                  generator: Optional[torch.Generator] = None,
                  key: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ngen`` whole OneMax eaSimple generations in one launch (K5):
    tournament selection (aspirant ``t`` of child lane ``c`` is
    ``sel[g, t, c] % n``, a strictly greater fitness wins, so the first
    drawn wins ties), then :func:`fused_variation_eval_packed`'s two-point
    crossover, flip-bit mutation and popcount fitness, with the
    population resident on the card between generations. ``ngen == 0``
    returns the inputs.

    :param packed: ``uint32[n, W]`` rows from :func:`pack_genomes`.
    :param fit: ``f32[n]`` their fitness (e.g. :func:`packed_fitness`).
    :param sel, pair, row, gene: ``uint32`` ``[ngen, tournsize, n]``,
        ``[ngen, 3, n]``, ``[ngen, 1, n]``, ``[ngen, 32 W, n]``, e.g. from
        :func:`evolve_bits`: the bits of ``prng='input'``, whose first two
        sizes are ``ngen`` and ``tournsize``.
    :param ngen, tournsize: the generations and aspirants under
        ``prng='hw'`` (``ngen`` required there).
    :param prng, generator, key: as in
        :func:`deap_tpu_torch.ops.kernels.fused_variation_eval`; one key
        serves the whole call (generation ``g`` is a word of each
        counter), so a call draws one key from ``generator``.
    :returns: ``(population uint32[n, W], fitness f32[n])`` after
        ``ngen`` generations; the wrapper's ``launches`` counts every
        launch, ``hw_launches`` those of the Philox path.
    """
    dev = packed.device
    mode, key = _prng_mode("evolve_packed", prng, dev, (sel, pair, row, gene),
                           generator, key)
    if mode == "input":
        if ngen is not None and ngen != sel.shape[0]:
            raise ValueError(f"ngen={ngen}, but the draws hold "
                             f"{sel.shape[0]} generations")
        ngen, tournsize = sel.shape[:2]
    elif ngen is None:
        raise ValueError("evolve_packed(prng='hw') needs ngen")
    fit = fit.to(torch.float32)
    if ngen == 0:
        return packed, fit
    n, W = packed.shape
    if dev.type == "cpu":
        if mode == "hw":
            sel, pair, row, gene = philox.hw_evolve_bits(key, ngen,
                                                         tournsize, n, length)
        return evolve_packed_plain(packed, fit, length, sel, pair, row, gene,
                                   cxpb=cxpb, mutpb=mutpb, indpb=indpb)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if tournsize < 1:
        raise ValueError("tournsize must be at least 1")
    if not 0 < length <= W * WORD:
        raise ValueError(f"length {length} does not fit {W} words")
    fit = fit.contiguous()
    _check_cuda("packed", dev, torch.uint32, (n, W), packed)
    _check_cuda("fit", dev, torch.float32, (n,), fit)
    if mode == "input":
        _check_cuda("sel", dev, torch.uint32, (ngen, tournsize, n), sel)
        _check_cuda("pair", dev, torch.uint32, (ngen, 3, n), pair)
        _check_cuda("row", dev, torch.uint32, (ngen, 1, n), row)
        _check_cuda("gene", dev, torch.uint32, (ngen, WORD * W, n), gene)
    pops = torch.empty((2, n, W), dtype=torch.uint32, device=dev)
    fits = torch.empty((2, n), dtype=torch.float32, device=dev)
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    sizes = (n, W, length, ngen, tournsize)
    probs = (_f32(cxpb), _f32(mutpb), _f32(indpb))
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mode == "hw":
        fn = _build.function("evolve_packed", "evolve_packed_hw",
                             [P] * 5 + [I] * 5 + [F] * 3 + [P])
        err = fn(packed.data_ptr(), fit.data_ptr(), key.data_ptr(),
                 pops.data_ptr(), fits.data_ptr(), *sizes, *probs, stream)
        evolve_packed.hw_launches += 1
    else:
        # the count of the kernel's grid barrier
        arrived = torch.zeros((1,), dtype=torch.int32, device=dev)
        fn = _build.function("evolve_packed", "evolve_packed",
                             [P] * 9 + [I] * 5 + [F] * 3 + [P])
        err = fn(packed.data_ptr(), fit.data_ptr(), sel.data_ptr(),
                 pair.data_ptr(), row.data_ptr(), gene.data_ptr(),
                 pops.data_ptr(), fits.data_ptr(), arrived.data_ptr(), *sizes,
                 *probs, stream)
    evolve_packed.launches += 1
    _build.check("evolve_packed", err, "evolve_packed")
    last = (ngen - 1) % 2  # generation g writes buffer g % 2
    return pops[last], fits[last]


evolve_packed.launches = 0
evolve_packed.hw_launches = 0


def _k5_hw_grid(n: int) -> Tuple[int, int, int]:
    """``(blocks, blocks an SM holds, tiles of 256 children)`` of
    :func:`evolve_packed`'s cooperative grid under ``prng='hw'`` at ``n``
    children (a block a tile), as the card reports it."""
    out = (ctypes.c_int * 3)()
    fn = _build.function("evolve_packed", "evolve_packed_hw_grid",
                         [_build.INT, ctypes.POINTER(ctypes.c_int)])
    _build.check("evolve_packed", fn(n, out), "evolve_packed_hw_grid")
    return tuple(out)


def _k5_hw_barrier(key: torch.Tensor, n: int, ngen: int) -> None:
    """Launch :func:`evolve_packed`'s Philox kernel on its grid at ``n``
    children with no child to breed: ``ngen`` grid barriers and the
    generation loop around them (its cost per generation, timed against
    ``ngen == 0``). Not counted in ``launches``."""
    fn = _build.function("evolve_packed", "evolve_packed_hw_barrier",
                         [_build.PTR, _build.INT, _build.INT, _build.PTR])
    err = fn(key.data_ptr(), n, ngen,
             torch.cuda.current_stream(key.device).cuda_stream)
    _build.check("evolve_packed", err, "evolve_packed_hw_barrier")
