"""Bit-packed bitstring populations — 32 genes per uint32 word.

Port of the main-path part of :mod:`deap_tpu.ops.packed`: the word-level
helpers and two CUDA kernels,

- :func:`fused_variation_eval_packed` (``csrc/packed_variation.cu``): one
  OneMax generation on packed rows — adjacent-pair two-point crossover,
  flip-bit mutation, popcount fitness;
- :func:`sel_tournament_gather_packed` (``csrc/selgather_packed.cu``):
  tournament selection of the parents plus the gather of their rows.

Both take their random bits explicitly, as uint32 tensors in the layout
of the TPU kernels' bits-input path; :func:`variation_bits` and
:func:`tournament_bits` draw them with a ``torch.Generator``. Each runs
its kernel on CUDA tensors and its plain PyTorch version
(``*_plain``) on CPU tensors.

Packed words are ``torch.uint32`` at every public boundary. torch's
uint32 has no shifts, adds, modulo or comparisons, so the plain versions
compute on int64 copies of the words (``& 0xFFFFFFFF``) and convert back.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deap_tpu_torch import _build
from deap_tpu_torch.ops.kernels import (
    _check_cuda,
    _f32,
    _pair_consistent,
    _u01,
    _words,
)

__all__ = [
    "pack_genomes",
    "unpack_genomes",
    "popcount",
    "packed_fitness",
    "segment_mask_words",
    "variation_bits",
    "tournament_bits",
    "fused_variation_eval_packed",
    "fused_variation_eval_packed_plain",
    "sel_tournament_gather_packed",
    "sel_tournament_gather_packed_plain",
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


# ------------------------------------------------------------- draws ----

def _uint32_bits(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform uint32 bits, drawn as full-range int32 and viewed."""
    bits = torch.randint(-2**31, 2**31, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)
    return bits.view(torch.uint32)


def variation_bits(generator: torch.Generator, n: int, W: int):
    """The bit streams of one :func:`fused_variation_eval_packed` call:
    ``(pairbits [n, 4], rowbits [n, 1], genebits [n, 32 W])``."""
    return (_uint32_bits(generator, (n, 4)), _uint32_bits(generator, (n, 1)),
            _uint32_bits(generator, (n, WORD * W)))


def tournament_bits(generator: torch.Generator, tournsize: int,
                    n: int) -> torch.Tensor:
    """Aspirant draws of :func:`sel_tournament_gather_packed`:
    ``uint32[tournsize, n]``."""
    return _uint32_bits(generator, (tournsize, n))


# ---------------------------------------------- variation + evaluation ----

def fused_variation_eval_packed_plain(packed, length, pairbits, rowbits,
                                      genebits, *, cxpb, mutpb, indpb):
    """Plain PyTorch version of :func:`fused_variation_eval_packed`."""
    n, W = packed.shape
    L = length
    g = _words(packed)
    pairu = _u01(_pair_consistent(_words(pairbits)))
    do_cx = pairu[:, 0:1] < _f32(cxpb)
    p1 = 1 + (pairu[:, 1:2] * L).to(torch.int32)
    p2 = 1 + (pairu[:, 2:3] * (L - 1)).to(torch.int32)
    p2 = torch.where(p2 >= p1, p2 + 1, p2)
    lo = torch.minimum(p1, p2)[:, 0]
    hi = torch.maximum(p1, p2)[:, 0]

    row = torch.arange(n, device=packed.device)
    partner = g[torch.clamp(row ^ 1, max=n - 1)]
    has_partner = ((row | 1) < n)[:, None]
    seg = _segment_words(lo, hi, W)
    seg = torch.where(do_cx & has_partner, seg, 0)
    child = (g & ~seg & _MASK32) | (partner & seg)

    do_mut = _u01(_words(rowbits))[:, 0:1] < _f32(mutpb)
    geneu = _u01(_words(genebits)).reshape(n, WORD, W)  # plane b, word j
    planes = (geneu < _f32(indpb)).to(torch.int64)
    flip = (planes * _bit_weights(packed.device)[:, None]).sum(1)
    starts = torch.arange(W, device=packed.device) * WORD
    flip = flip & _bits_below(L - starts)
    flip = torch.where(do_mut, flip, 0)
    child = child ^ flip
    fit = _popcount64(child).sum(-1).to(torch.float32)
    return _as_uint32(child), fit


def fused_variation_eval_packed(packed: torch.Tensor, length: int,
                                pairbits: torch.Tensor, rowbits: torch.Tensor,
                                genebits: torch.Tensor, *, cxpb: float,
                                mutpb: float, indpb: float,
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One OneMax generation on packed rows: adjacent pairs (0,1),
    (2,3), ... swap a two-point segment with probability ``cxpb`` (the
    even row's ``pairbits`` decide for both; an odd last row never mates),
    each row mutates with probability ``mutpb`` flipping each gene with
    probability ``indpb``, and fitness is the popcount.

    :param packed: ``uint32[n, W]`` rows from :func:`pack_genomes`.
    :param pairbits, rowbits, genebits: ``uint32`` ``[n, 4]``, ``[n, 1]``,
        ``[n, 32 W]`` (bit plane ``b`` of word ``j`` in column ``b W + j``),
        e.g. from :func:`variation_bits`.
    :returns: ``(children uint32[n, W], fitness f32[n])``.
    """
    if packed.device.type == "cpu":
        return fused_variation_eval_packed_plain(
            packed, length, pairbits, rowbits, genebits, cxpb=cxpb,
            mutpb=mutpb, indpb=indpb)
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    n, W = packed.shape
    if not 0 < length <= W * WORD:
        raise ValueError(f"length {length} does not fit {W} words")
    dev = packed.device
    _check_cuda("packed", dev, torch.uint32, (n, W), packed)
    _check_cuda("pairbits", dev, torch.uint32, (n, 4), pairbits)
    _check_cuda("rowbits", dev, torch.uint32, (n, 1), rowbits)
    _check_cuda("genebits", dev, torch.uint32, (n, WORD * W), genebits)
    out = torch.empty((n, W), dtype=torch.uint32, device=dev)
    fit = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return out, fit
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    fn = _build.function("packed_variation", "packed_variation",
                         [P] * 6 + [I, I, I, F, F, F, P])
    err = fn(packed.data_ptr(), pairbits.data_ptr(), rowbits.data_ptr(),
             genebits.data_ptr(), out.data_ptr(), fit.data_ptr(), n, W,
             length, _f32(cxpb), _f32(mutpb), _f32(indpb),
             torch.cuda.current_stream(dev).cuda_stream)
    fused_variation_eval_packed.launches += 1
    _build.check("packed_variation", err, "fused_variation_eval_packed")
    return out, fit


fused_variation_eval_packed.launches = 0


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
                                 draws: torch.Tensor) -> torch.Tensor:
    """Tournament-select ``n`` parents and gather their rows: child slot
    ``j``'s aspirant ``t`` is ``draws[t, j] % n``; a strictly greater
    fitness wins, so the first drawn wins ties.

    :param packed: ``uint32[n, W]``; ``fit``: ``f32[n]`` (weighted first
        objective); ``draws``: ``uint32[tournsize, n]``, e.g. from
        :func:`tournament_bits`.
    :returns: ``uint32[n, W]`` parent rows, one per child slot.
    """
    if packed.device.type == "cpu":
        return sel_tournament_gather_packed_plain(packed, fit, draws)
    if packed.device.type != "cuda":
        raise ValueError(f"no kernel for device {packed.device}")
    n, W = packed.shape
    tournsize = draws.shape[0]
    if tournsize < 1:
        raise ValueError("tournsize must be at least 1")
    dev = packed.device
    _check_cuda("packed", dev, torch.uint32, (n, W), packed)
    _check_cuda("fit", dev, torch.float32, (n,), fit)
    _check_cuda("draws", dev, torch.uint32, (tournsize, n), draws)
    out = torch.empty((n, W), dtype=torch.uint32, device=dev)
    if n == 0:
        return out
    P, I = _build.PTR, _build.INT
    fn = _build.function("selgather_packed", "selgather_packed",
                         [P] * 4 + [I, I, I, P])
    err = fn(packed.data_ptr(), fit.data_ptr(), draws.data_ptr(),
             out.data_ptr(), n, W, tournsize,
             torch.cuda.current_stream(dev).cuda_stream)
    sel_tournament_gather_packed.launches += 1
    _build.check("selgather_packed", err, "sel_tournament_gather_packed")
    return out


sel_tournament_gather_packed.launches = 0
