"""Hand-written CUDA kernels and their helpers.

Port of :mod:`deap_tpu.ops.kernels`. Each wrapper runs its kernel on
CUDA tensors and its plain PyTorch version on CPU tensors; nothing else
decides between the two, and a CUDA tensor never takes the plain path.

- :func:`fused_variation` (K1, ``csrc/fused_variation.cu``): the
  variation plane; plain version
  :func:`deap_tpu_torch.ops.variation.apply_variation`.
- :func:`fused_variation_eval` (K2, ``csrc/fused_variation_eval.cu``):
  one OneMax generation on byte or float32 genomes — adjacent-pair
  two-point crossover, flip-bit mutation, sum-of-genes fitness; plain
  version :func:`fused_variation_eval_plain`, random bits from
  :func:`fused_bits` (``prng='input'``) or made inside the kernel by
  Philox (``prng='hw'``, :mod:`deap_tpu_torch.ops.philox`).
- :func:`dominated_weight_sums` (K7) and :func:`dominated_weight_maxes`
  (K8), ``csrc/dominance.cu``: Pareto-dominance reductions over all
  pairs without the ``[n, n]`` matrix; plain versions
  :func:`dominated_weight_sums_plain` and
  :func:`dominated_weight_maxes_plain`. On them sit
  :func:`dominated_counts`, :func:`strengths_tiled` and the peeling sort
  :func:`nd_rank_tiled`.
- :func:`gp_grouped_dispatch` (K9, ``csrc/gp_grouped.cu``): opcode-major
  GP evaluation of a grouped schedule, one launch over the work items of
  :func:`k9_work_items`; plain version :func:`gp_grouped_dispatch_plain`,
  the chunk loop.

``_u01`` and ``_pair_consistent`` are the shared random-bit conventions
of the fused kernels (``ops.packed`` and ``ops.kernels_real`` use them
too), :func:`fused_bits` draws the streams of their bits-input path, and
``_prng_mode`` and :func:`philox_key` set up their Philox path.

``prng`` modes, as in the JAX package: ``'input'`` streams bits drawn
outside the kernel into it (they are arguments); ``'hw'`` makes them inside
the kernel, from a key of two uint32 words that the wrapper draws from the
caller's ``generator`` (or takes as ``key``), with Philox4x32-10 in the
counter layout of :mod:`deap_tpu_torch.ops.philox`; ``'auto'`` is ``'hw'``
on the card and ``'input'`` on the CPU. On a CPU tensor ``'hw'`` runs the
plain version on the bits :mod:`~deap_tpu_torch.ops.philox` expands from
the key, the same bits the kernel makes.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from deap_tpu_torch.core.fitness import dominates

from deap_tpu_torch import _build
from deap_tpu_torch.ops import philox
from deap_tpu_torch.ops.variation import apply_variation

__all__ = ["fused_variation", "KERNEL_DTYPES", "fused_bits", "philox_key",
           "PrngError", "philox_kat",
           "fused_variation_eval", "fused_variation_eval_plain",
           "dominated_weight_sums", "dominated_weight_maxes",
           "dominated_counts", "strengths_tiled", "nd_rank_tiled",
           "GP_DEVICE_OPS", "gp_lt", "gp_eq", "gp_logistic",
           "gp_grouped_dispatch",
           "gp_grouped_dispatch_plain", "k9_item_shape", "k9_work_items"]

#: genome dtypes the kernel takes: bool (as one byte) and float32
KERNEL_DTYPES = (torch.bool, torch.float32)
_KINDS = {"flip": 0, "add": 1, "set": 2}
_INT_MAX = 2**31 - 1

_INV24 = 1.0 / (1 << 24)


def _words(bits: torch.Tensor) -> torch.Tensor:
    """uint32 tensor → int64 tensor of the same values (torch's uint32 has
    no shifts, adds, modulo or comparisons)."""
    return bits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _u01(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (as int64 words) → U[0, 1) float32 from the top 24
    bits: ``int32(bits >> 8) * 2^-24``, exact."""
    return (bits >> 8).to(torch.int32).to(torch.float32) * _INV24


def _pair_consistent(u: torch.Tensor) -> torch.Tensor:
    """Per-row draws → both members of each adjacent pair carry the even
    member's draw."""
    idx = torch.arange(u.shape[0], device=u.device) & ~1
    return u[idx]


def _f32(p: float) -> float:
    """A probability as the float32 the kernels compare against."""
    return torch.tensor(p, dtype=torch.float32).item()


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _check_cuda(name: str, device: torch.device, dtype, shape,
                t: torch.Tensor) -> None:
    if t.device != device:
        raise ValueError(f"{name} lives on {t.device}, genomes on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# ------------------------------------------- the fused kernels' draws ----

def _uint32_bits(generator: torch.Generator, shape) -> torch.Tensor:
    """Uniform uint32 bits, drawn as full-range int32 and viewed."""
    bits = torch.randint(-2**31, 2**31, shape, generator=generator,
                         device=generator.device, dtype=torch.int32)
    return bits.view(torch.uint32)


def fused_bits(generator: torch.Generator, n: int, gene_cols: int):
    """The bit streams of one fused generation kernel, in the layout of
    the JAX package's bits-input path (``run_fused_kernel``) without its
    padding: ``(pairbits [n, 4], rowbits [n, 1], genebits [n,
    gene_cols])``, uint32, drawn in that order."""
    return (_uint32_bits(generator, (n, 4)), _uint32_bits(generator, (n, 1)),
            _uint32_bits(generator, (n, gene_cols)))


class PrngError(ValueError, NotImplementedError):
    """A ``prng`` mode and the random-bit arguments disagree: ``'hw'``
    with bits passed in, ``'input'`` without them, ``'hw'`` without a
    generator or key. A ``ValueError``; also a ``NotImplementedError``,
    as which the port refused every ``'hw'`` request before its Philox
    path existed, so callers that caught that keep catching it."""


def _resolve_prng(prng: str, device: torch.device) -> str:
    """``'auto'`` → ``'hw'`` on the card, ``'input'`` elsewhere (the JAX
    package's ``'auto'`` is ``'hw'`` on hardware, ``'input'`` under the
    interpreter); ``'hw'`` and ``'input'`` stay."""
    if prng == "auto":
        return "hw" if device.type == "cuda" else "input"
    if prng not in ("hw", "input"):
        raise ValueError(f"unknown prng mode {prng!r}")
    return prng


def philox_key(generator: torch.Generator) -> torch.Tensor:
    """A Philox key, ``uint32[2]`` on the generator's device: the one draw
    a ``prng='hw'`` kernel takes from the generator. The kernel reads it
    through a pointer, so drawing it never waits for the card."""
    return _uint32_bits(generator, (2,))


def _prng_mode(what: str, prng: Optional[str], device: torch.device,
               bits: Sequence, generator: Optional[torch.Generator],
               key: Optional[torch.Tensor]):
    """Check a wrapper's random-bit arguments against its mode: returns
    ``(mode, key)`` with ``key`` the Philox key (``uint32[2]`` on
    ``device``) for ``'hw'`` and ``None`` for ``'input'``. ``prng=None``
    is ``'input'`` when bits are passed, else ``'auto'``."""
    given = [b is not None for b in bits]
    if prng is None:
        prng = "input" if any(given) else "auto"
    mode = _resolve_prng(prng, device)
    if mode == "input":
        if not all(given):
            raise PrngError(
                f"{what}: prng='input' streams bits into the kernel, so "
                f"they must all be passed; prng='hw' makes them in the "
                f"kernel (Philox) from a generator or key")
        return mode, None
    if any(given):
        raise PrngError(
            f"{what}: prng={prng!r} makes the bits inside the kernel "
            f"(Philox) and takes none; pass prng='input' to stream these in")
    if (generator is None) == (key is None):
        raise PrngError(f"{what}: prng='hw' needs a generator or a key "
                        f"(Philox), exactly one of them")
    if key is None:
        if generator.device.type != device.type:
            raise ValueError(f"{what}: generator lives on "
                             f"{generator.device}, the genomes on {device}")
        key = philox_key(generator)
    if key.device != device or key.dtype != torch.uint32 or key.shape != (2,):
        raise ValueError(f"{what}: a Philox key is uint32[2] on {device}, "
                         f"got {key.dtype}{tuple(key.shape)} on {key.device}")
    return mode, key


def philox_kat(counter: torch.Tensor, key: torch.Tensor,
               library: str = "evolve_packed") -> torch.Tensor:
    """The device function ``philox4x32_10`` of ``csrc/philox.cuh`` as
    built into ``library`` (every library of a Philox kernel has it):
    ``uint32 [c, 4]`` for counters ``uint32 [c, 4]`` and keys ``uint32
    [c, 2]`` on the card, one thread each. A check of the device function
    against :func:`deap_tpu_torch.ops.philox.philox4x32_10`, not a kernel
    of any path."""
    dev = counter.device
    if dev.type != "cuda":
        raise ValueError("philox_kat runs the device function: it needs "
                         "tensors on the card")
    c = counter.shape[0]
    _check_cuda("counter", dev, torch.uint32, (c, 4), counter)
    _check_cuda("key", dev, torch.uint32, (c, 2), key)
    out = torch.empty((c, 4), dtype=torch.uint32, device=dev)
    P, I = _build.PTR, _build.INT
    fn = _build.function(library, "philox_kat", [P, P, P, I, P])
    err = fn(counter.data_ptr(), key.data_ptr(), out.data_ptr(), c,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(library, err, "philox_kat")
    return out


def _pair_decisions(pairbits: torch.Tensor, L: int, cxpb: float):
    """Each row's crossover decision and segment from its pair's even
    row's draws: ``(do_cx bool[n], lo int32[n], hi int32[n])``. An odd
    last row never mates; ``p1 = 1 + int(u·L)``, ``p2 = 1 + int(u·(L−1))``
    bumped past ``p1`` (float32 products, as the TPU kernels compute
    them), and the segment is ``[min, max)``."""
    n = pairbits.shape[0]
    pairu = _u01(_pair_consistent(_words(pairbits)))
    row = torch.arange(n, device=pairbits.device)
    do_cx = (pairu[:, 0] < _f32(cxpb)) & ((row | 1) < n)
    p1 = 1 + (pairu[:, 1] * L).to(torch.int32)
    p2 = 1 + (pairu[:, 2] * (L - 1)).to(torch.int32)
    p2 = torch.where(p2 >= p1, p2 + 1, p2)
    return do_cx, torch.minimum(p1, p2), torch.maximum(p1, p2)


def _partner_rows(g: torch.Tensor) -> torch.Tensor:
    """Row ``r ^ 1`` of each row (an odd last row gets itself)."""
    row = torch.arange(g.shape[0], device=g.device)
    return g[torch.clamp(row ^ 1, max=g.shape[0] - 1)]


#: child rows a warp of K1 owns (``ROWS`` in csrc/fused_variation.cu),
#: and the warps an SM holds at once at the kernel's ~40 registers a
#: thread
_K1_ROWS, _K1_WARPS_PER_SM = 32, 48


def _k1_width(L: int, itemsize: int, *tensors) -> int:
    """Genes a unit of K1 moves at once: 4 (a 32-bit word of bool genes,
    a float4 of float32 ones) where ``L % 4 == 0`` and every tensor's
    pointer is aligned for it (the mask's to 4 bytes, the argument's to
    16), else 1."""
    if L % 4:
        return 1
    align = (4 * itemsize, 4 * itemsize, 4, 16)
    for t, a in zip(tensors, align):
        if t is not None and t.data_ptr() % a:
            return 1
    return 4


def _k1_plan(n: int, L: int, width: int, sms: int) -> Tuple[int, int]:
    """K1's walk (csrc/fused_variation.cu): a warp takes a batch of
    ``_K1_ROWS`` child rows and walks their ``L // width`` units a row as
    one flattened run, cut into ``slices`` of ``units_per_slice`` units, a
    warp each: as many slices as keep the grid within one wave of
    ``_K1_WARPS_PER_SM`` warps on each of ``sms`` SMs (the kernel waits on
    memory, so warps in flight set its pace), with at least one unit a
    lane. Returns ``(slices, units_per_slice)``."""
    run = min(n, _K1_ROWS) * (L // width)
    batches = -(-n // _K1_ROWS)
    slices = max(1, min(_K1_WARPS_PER_SM * sms // batches, run // 32))
    per = -(-run // slices)
    return -(-run // per), per  # no slice left empty


def fused_variation(genomes: torch.Tensor, src_idx: torch.Tensor,
                    partner_idx: torch.Tensor, cx_row: torch.Tensor,
                    lo: torch.Tensor, hi: torch.Tensor,
                    mut_row: torch.Tensor, mut_mask: torch.Tensor,
                    mut_arg: Optional[torch.Tensor] = None, *,
                    mut_kind: str = "flip") -> torch.Tensor:
    """Selection gather + paired segment crossover + per-gene mutation in
    one pass: ``out[r] = mut(cx(genomes[src_idx[r]],
    genomes[partner_idx[r]]))``, crossover swapping ``[lo[r], hi[r])``
    where ``cx_row[r]``, mutation rewriting genes where ``mut_row[r] &
    mut_mask[r]`` (``flip``: logical not; ``add``: ``x + arg``; ``set``:
    ``arg``).

    :param genomes: ``[N, L]`` bool or float32 population.
    :param src_idx, partner_idx, lo, hi: ``int32[n]``.
    :param cx_row, mut_row: ``bool[n]``; ``mut_mask``: ``bool[n, L]``.
    :param mut_arg: ``float32[n, L]`` for ``add``/``set``, else ``None``.
    :returns: ``[n, L]`` children in the genomes' dtype.
    """
    if mut_kind not in _KINDS:
        raise ValueError(f"unknown mut_kind {mut_kind!r}")
    if mut_kind != "flip" and mut_arg is None:
        raise ValueError(f"mut_kind={mut_kind!r} needs mut_arg")
    if genomes.device.type == "cpu":
        return apply_variation(genomes, src_idx, partner_idx, cx_row, lo, hi,
                               mut_row, mut_mask, mut_arg,
                               mut_kind).to(genomes.dtype)
    if genomes.device.type != "cuda":
        raise ValueError(f"no kernel for device {genomes.device}")
    if genomes.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_variation takes bool or float32 genomes, "
                        f"got {genomes.dtype}")
    n = src_idx.shape[0]
    N, L = genomes.shape
    if n * L > _INT_MAX or N * L > _INT_MAX:
        raise ValueError("fused_variation indexes genes with int32")
    dev = genomes.device
    _check_cuda("genomes", dev, genomes.dtype, (N, L), genomes)
    for name, t in (("src_idx", src_idx), ("partner_idx", partner_idx),
                    ("lo", lo), ("hi", hi)):
        _check_cuda(name, dev, torch.int32, (n,), t)
    for name, t in (("cx_row", cx_row), ("mut_row", mut_row)):
        _check_cuda(name, dev, torch.bool, (n,), t)
    _check_cuda("mut_mask", dev, torch.bool, (n, L), mut_mask)
    if mut_kind != "flip":
        _check_cuda("mut_arg", dev, torch.float32, (n, L), mut_arg)
    else:
        mut_arg = None
    out = torch.empty((n, L), dtype=genomes.dtype, device=dev)
    if n == 0 or L == 0:
        return out
    width = _k1_width(L, genomes.element_size(), genomes, out, mut_mask,
                      mut_arg)
    slices, units_per_slice = _k1_plan(n, L, width, _multiprocessors(dev))
    lib_fn = "fused_variation_u8" if genomes.dtype == torch.bool \
        else "fused_variation_f32"
    fn = _build.function("fused_variation", lib_fn, [_build.PTR] * 10 + [
        _build.INT] * 6 + [_build.PTR])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(genomes.data_ptr(), src_idx.data_ptr(), partner_idx.data_ptr(),
             cx_row.data_ptr(), lo.data_ptr(), hi.data_ptr(),
             mut_row.data_ptr(), mut_mask.data_ptr(), _ptr(mut_arg),
             out.data_ptr(), n, L, _KINDS[mut_kind], width, slices,
             units_per_slice, stream)
    fused_variation.launches += 1
    _build.check("fused_variation", err, "fused_variation")
    return out


fused_variation.launches = 0


# ------------------------------------------ K2 fused_variation_eval ----

def fused_variation_eval_plain(genomes, pairbits, rowbits, genebits, *,
                               cxpb, mutpb, indpb):
    """Plain PyTorch version of :func:`fused_variation_eval`."""
    n, L = genomes.shape
    do_cx, lo, hi = _pair_decisions(pairbits, L, cxpb)
    col = torch.arange(L, device=genomes.device)
    seg = (do_cx[:, None] & (col >= lo[:, None]) & (col < hi[:, None]))
    child = torch.where(seg, _partner_rows(genomes), genomes)
    do_mut = _u01(_words(rowbits))[:, 0:1] < _f32(mutpb)
    flip = do_mut & (_u01(_words(genebits)) < _f32(indpb))
    flipped = ~child if child.dtype == torch.bool else 1.0 - child
    child = torch.where(flip, flipped, child)
    return child, child.to(torch.float32).sum(1)


def fused_variation_eval(genomes: torch.Tensor,
                         pairbits: Optional[torch.Tensor] = None,
                         rowbits: Optional[torch.Tensor] = None,
                         genebits: Optional[torch.Tensor] = None, *,
                         cxpb: float, mutpb: float, indpb: float,
                         prng: Optional[str] = None,
                         generator: Optional[torch.Generator] = None,
                         key: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One OneMax generation on 0/1 genomes (K2): adjacent pairs (0,1),
    (2,3), ... swap a two-point segment with probability ``cxpb`` (the
    even row's ``pairbits`` decide for both; an odd last row never
    mates), each row mutates with probability ``mutpb`` flipping each
    gene with probability ``indpb`` (``1 - x`` on float32), and fitness
    is the sum of the genes — ``var_and`` with ``cx_two_point`` and
    ``mut_flip_bit`` followed by the OneMax evaluation, in one pass.

    Fitness sums are exact for 0/1 genomes, so kernel and plain version
    agree bitwise there.

    On the card the launcher picks one of two variants of the kernel by
    shape and alignment: the vector variant (4 genes per lane, a warp per
    row, the next row's draws loading while it works) where ``L % 4 ==
    0``, the genomes are 4-byte (bool) or 16-byte (float32) aligned and
    the gene bits 16-byte aligned, the scalar one (a gene per lane)
    otherwise. Both compute the same bits;
    ``fused_variation_eval.vector_launches`` counts the launches the
    launcher reports as vector ones (within ``launches``), and
    ``fused_variation_eval.hw_launches`` those of the Philox path.

    :param genomes: ``[n, L]`` bool or float32.
    :param pairbits, rowbits, genebits: ``uint32`` ``[n, 4]``, ``[n, 1]``,
        ``[n, L]``, e.g. from ``fused_bits(generator, n, L)``: the bits
        of ``prng='input'``.
    :param prng: ``'input'`` (the default where bits are passed),
        ``'hw'`` (Philox in the kernel, keyed from ``generator`` or
        ``key``; bits refused) or ``'auto'`` (the default without bits:
        ``'hw'`` on the card, ``'input'`` on the CPU).
    :returns: ``(children [n, L] in the genomes' dtype, fitness f32[n])``.
    """
    dev = genomes.device
    mode, key = _prng_mode("fused_variation_eval", prng, dev,
                           (pairbits, rowbits, genebits), generator, key)
    if genomes.dtype not in KERNEL_DTYPES:
        raise TypeError(f"fused_variation_eval takes bool or float32 "
                        f"genomes, got {genomes.dtype}")
    n, L = genomes.shape
    if dev.type == "cpu":
        if mode == "hw":
            pairbits, rowbits, genebits = philox.hw_fused_bits(key, n, L)
        return fused_variation_eval_plain(genomes, pairbits, rowbits,
                                          genebits, cxpb=cxpb, mutpb=mutpb,
                                          indpb=indpb)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda("genomes", dev, genomes.dtype, (n, L), genomes)
    if mode == "input":
        _check_cuda("pairbits", dev, torch.uint32, (n, 4), pairbits)
        _check_cuda("rowbits", dev, torch.uint32, (n, 1), rowbits)
        _check_cuda("genebits", dev, torch.uint32, (n, L), genebits)
    out = torch.empty((n, L), dtype=genomes.dtype, device=dev)
    fit = torch.empty((n,), dtype=torch.float32, device=dev)
    suffix = "u8" if genomes.dtype == torch.bool else "f32"
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    probs = (_f32(cxpb), _f32(mutpb), _f32(indpb))
    stream = torch.cuda.current_stream(dev).cuda_stream
    vector = I(0)  # the launcher sets it to 1 where it took that variant
    if mode == "hw":
        fn = _build.function("fused_variation_eval",
                             f"fused_variation_eval_hw_{suffix}",
                             [P] * 4 + [I, I, F, F, F, P, ctypes.POINTER(I)])
        err = fn(genomes.data_ptr(), key.data_ptr(), out.data_ptr(),
                 fit.data_ptr(), n, L, *probs, stream, ctypes.byref(vector))
        fused_variation_eval.hw_launches += 1
    else:
        fn = _build.function("fused_variation_eval",
                             f"fused_variation_eval_{suffix}",
                             [P] * 6 + [I, I, F, F, F, P, ctypes.POINTER(I)])
        err = fn(genomes.data_ptr(), pairbits.data_ptr(), rowbits.data_ptr(),
                 genebits.data_ptr(), out.data_ptr(), fit.data_ptr(), n, L,
                 *probs, stream, ctypes.byref(vector))
    fused_variation_eval.launches += 1
    fused_variation_eval.vector_launches += vector.value
    _build.check("fused_variation_eval", err, "fused_variation_eval")
    return out, fit


fused_variation_eval.launches = 0
fused_variation_eval.vector_launches = 0
fused_variation_eval.hw_launches = 0


# ------------------------------------------------ dominance reductions ----
#
# K7 and K8 of deap_tpu.ops.kernels: `j dominates i` is the weighted-value
# test of core.fitness.dominates, all_k(w[j,k] >= w[i,k]) and
# any_k(w[j,k] > w[i,k]), in IEEE compares. Weights must be finite (the
# TPU kernels multiply the 0/1 dominance by the weight, which turns an
# infinite weight of a row that does not dominate into NaN).

#: K7 sums past 2^24 (or of non-integer weights) round in another order
#: than the plain version's: the relative tolerance stated for them
K7_RTOL = 1e-5
#: objectives the dominance kernels take (``MAX_M`` of csrc/dominance.cu)
DOMINANCE_MAX_NOBJ = 32
#: query rows per step of the plain versions: a ``[1024, n, m]`` compare
_PLAIN_CHUNK = 1024
#: K8 aims at this many blocks per SM, and splits the rows of w into
#: ranges of whole chunks of this many rows (``K8_CHUNK`` in
#: csrc/dominance.cu)
_K8_BLOCKS_PER_SM, _K8_SPLIT_ROWS = 4, 32
#: threads per block and rows per staged tile of csrc/dominance.cu
_DOM_THREADS, _DOM_TILE = 128, 256
#: K7 aims at this many blocks per SM (several waves) and at most this
#: many ranges of j
_K7_BLOCKS_PER_SM, _K7_MAX_SPLITS = 96, 128


def _multiprocessors(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _dominators(queries: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``bool[nq, n]``: row ``j`` of ``w`` dominates query row ``i``."""
    return dominates(w[None, :, :], queries[:, None, :])


def dominated_weight_sums_plain(w: torch.Tensor, weights: torch.Tensor,
                                chunk: int = _PLAIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of :func:`dominated_weight_sums`, a chunk of
    query rows at a time."""
    w = w.to(torch.float32)
    weights = weights.to(torch.float32)
    out = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
    for s in range(0, w.shape[0], chunk):
        dom = _dominators(w[s:s + chunk], w)
        out[s:s + chunk] = torch.where(dom, weights, 0.0).sum(1)
    return out


def dominated_weight_maxes_plain(w: torch.Tensor, weights: torch.Tensor,
                                 queries: Optional[torch.Tensor] = None,
                                 chunk: int = _PLAIN_CHUNK) -> torch.Tensor:
    """Plain PyTorch version of :func:`dominated_weight_maxes`, a chunk of
    query rows at a time."""
    w = w.to(torch.float32)
    weights = weights.to(torch.float32)
    queries = w if queries is None else queries.to(torch.float32)
    out = torch.zeros(queries.shape[0], dtype=torch.float32, device=w.device)
    if w.shape[0] == 0:
        return out
    for s in range(0, queries.shape[0], chunk):
        dom = _dominators(queries[s:s + chunk], w)
        out[s:s + chunk] = torch.where(dom, weights, 0.0).amax(1).clamp_min(
            0.0)
    return out


def _dominance_inputs(what: str, w: torch.Tensor, weights: torch.Tensor,
                      queries: Optional[torch.Tensor] = None):
    """Checks and float32 copies for the dominance kernels (weights may be
    a bool mask, as in the JAX package)."""
    if w.ndim != 2:
        raise ValueError(f"{what}: w must be [n, nobj], got {tuple(w.shape)}")
    n, m = w.shape
    if not 1 <= m <= DOMINANCE_MAX_NOBJ:
        raise ValueError(f"{what} takes 1 to {DOMINANCE_MAX_NOBJ} "
                         f"objectives, got {m}")
    dev = w.device
    w = w.to(torch.float32).contiguous()
    weights = weights.to(torch.float32).contiguous()
    _check_cuda("weights", dev, torch.float32, (n,), weights)
    if queries is not None:
        queries = queries.to(torch.float32).contiguous()
        _check_cuda("queries", dev, torch.float32, (queries.shape[0], m),
                    queries)
    return w, weights, queries


def _k7_rows_per_thread(m: int) -> int:
    """Query rows each thread of K7 holds (``SumsShape<M>::R`` in
    csrc/dominance.cu; 1 in its generic kernel for m > 8)."""
    return 8 if m <= 4 else 4 if m <= 8 else 1


def _k7_order(w: torch.Tensor, rows_per_block: int):
    """K7's row order and prune limits: ``order`` sorts the rows by
    objective 0, descending and stable, rows holding a NaN last (they
    dominate nothing and nothing dominates them); ``limit[b]`` counts the
    sorted rows whose key is at least that of block ``b``'s last query
    (``rows_per_block`` queries a block), the only rows that can dominate
    a query of the block. ``int32``, one per block."""
    n = w.shape[0]
    key = torch.where(torch.isnan(w).any(1), -torch.inf, w[:, 0])
    key, order = torch.sort(key, descending=True, stable=True)
    last = torch.arange(rows_per_block, n + rows_per_block, rows_per_block,
                        device=w.device).clamp_(max=n) - 1
    limit = torch.searchsorted(-key, -key[last], right=True)
    return order, limit.to(torch.int32)


def _k7_splits(n: int, m: int, sms: int) -> int:
    """How many ranges of whole ``j`` tiles K7 splits its rows into
    (``gridDim.y``): enough for ``_K7_BLOCKS_PER_SM`` blocks per SM, at
    most ``_K7_MAX_SPLITS`` (the ``[S, n]`` scratch) and one tile each,
    rounded so that no range is empty (the launcher refuses another
    count)."""
    query_blocks = -(-n // (_DOM_THREADS * _k7_rows_per_thread(m)))
    tiles = -(-n // _DOM_TILE)
    want = -(-_K7_BLOCKS_PER_SM * sms // query_blocks)
    want = max(1, min(want, tiles, _K7_MAX_SPLITS))
    per = -(-tiles // want)
    return -(-tiles // per)


def _k8_rows_per_thread(m: int) -> int:
    """Query rows each thread of K8 holds (``MaxesShape<M>::R`` in
    csrc/dominance.cu; 1 in its generic kernel for m > 8)."""
    return 4 if m <= 4 else 2 if m <= 8 else 1


def _k8_splits(n: int, nq: int, m: int, sms: int) -> int:
    """How many ranges of whole ``_K8_SPLIT_ROWS``-row chunks K8 splits the
    rows of ``w`` into (``gridDim.y``): enough for ``_K8_BLOCKS_PER_SM``
    blocks per SM over the blocks the queries fill (a block holds 128 R
    queries, so the prefix reduction's 512 fill one), at most one chunk
    each, rounded so that no range is empty (the launcher refuses another
    count)."""
    query_blocks = -(-nq // (_DOM_THREADS * _k8_rows_per_thread(m)))
    chunks = -(-n // _K8_SPLIT_ROWS)
    want = -(-_K8_BLOCKS_PER_SM * sms // query_blocks)
    want = max(1, min(want, chunks, 65535))
    per = -(-chunks // want)
    return -(-chunks // per)


def dominated_weight_sums(w: torch.Tensor,
                          weights: torch.Tensor) -> torch.Tensor:
    """``out[i] = Σ_{j dominates i} weights[j]`` without the ``[n, n]``
    dominance matrix (K7). With 0/1 weights this counts dominators; with
    SPEA2 strengths it is the raw fitness.

    On the card the rows go to the kernel sorted by objective 0,
    descending (:func:`_k7_order`), so a block of queries compares only
    the prefix of rows at least as large in objective 0 as its last
    query — about half the pairs. The kernel splits that order into
    ``S`` ranges (:func:`_k7_splits`), adds each range in order into a
    ``[S, n]`` scratch, then adds the ranges in ascending order: no
    atomics, so a launch gives the same bits every time. Sums of
    integer-valued weights stay exact while below 2²⁴, so kernel and plain
    version agree bitwise there; otherwise they add in different orders
    and agree to a relative 1e-5 (``K7_RTOL``).

    :param w: ``f32[n, nobj]`` weighted values (maximisation).
    :param weights: ``f32[n]`` finite per-dominator weights (bools
        accepted).
    :returns: ``f32[n]``.
    """
    if w.device.type == "cpu":
        return dominated_weight_sums_plain(w, weights)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    w, weights, _ = _dominance_inputs("dominated_weight_sums", w, weights)
    n, m = w.shape
    out = torch.empty(n, dtype=torch.float32, device=w.device)
    if n == 0:
        return out
    order, limit = _k7_order(w, _DOM_THREADS * _k7_rows_per_thread(m))
    ws, wts = w[order].contiguous(), weights[order].contiguous()
    sums = torch.empty(n, dtype=torch.float32, device=w.device)
    nsplit = _k7_splits(n, m, _multiprocessors(w.device))
    partial = sums if nsplit == 1 else torch.empty(
        (nsplit, n), dtype=torch.float32, device=w.device)
    P, I = _build.PTR, _build.INT
    fn = _build.function("dominance", "dominated_weight_sums",
                         [P, P, P, P, P, I, I, I, P])
    err = fn(ws.data_ptr(), wts.data_ptr(), limit.data_ptr(), sums.data_ptr(),
             partial.data_ptr(), n, m, nsplit,
             torch.cuda.current_stream(w.device).cuda_stream)
    dominated_weight_sums.launches += 1
    _build.check("dominance", err, "dominated_weight_sums")
    out[order] = sums
    return out


dominated_weight_sums.launches = 0


def dominated_weight_maxes(w: torch.Tensor, weights: torch.Tensor,
                           queries: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """``out[i] = max_{j dominates queries[i]} weights[j]``, 0 with no
    dominator (K8): the cross step of the prefix chain reduction
    (:func:`deap_tpu_torch.mo.ndsort.nd_rank_prefix`). ``queries``
    defaults to ``w``. Weights must be non-negative and finite: 0 is the
    "no dominator" identity. The maximum is exact in any order, so kernel
    and plain version agree bitwise.

    :param w: ``f32[n, nobj]`` candidate dominators (weighted values).
    :param weights: ``f32[n]`` per-dominator weights (>= 0).
    :param queries: ``f32[nq, nobj]`` rows to rank against ``w``.
    :returns: ``f32[nq]``.
    """
    if w.device.type == "cpu":
        return dominated_weight_maxes_plain(w, weights, queries)
    if w.device.type != "cuda":
        raise ValueError(f"no kernel for device {w.device}")
    w, weights, queries = _dominance_inputs(
        "dominated_weight_maxes", w, weights, w if queries is None
        else queries)
    n, m = w.shape
    nq = queries.shape[0]
    out = torch.zeros(nq, dtype=torch.float32, device=w.device)
    if n == 0 or nq == 0:
        return out
    nsplit = _k8_splits(n, nq, m, _multiprocessors(w.device))
    P, I = _build.PTR, _build.INT
    fn = _build.function("dominance", "dominated_weight_maxes",
                         [P, P, P, P, I, I, I, I, P])
    err = fn(w.data_ptr(), weights.data_ptr(), queries.data_ptr(),
             out.data_ptr(), n, nq, m, nsplit,
             torch.cuda.current_stream(w.device).cuda_stream)
    dominated_weight_maxes.launches += 1
    _build.check("dominance", err, "dominated_weight_maxes")
    return out


dominated_weight_maxes.launches = 0


def dominated_counts(w: torch.Tensor,
                     remaining: torch.Tensor) -> torch.Tensor:
    """``counts[i] = #{j : remaining[j] and j dominates i}`` — K7 with 0/1
    weights, as ``int32[n]``."""
    return dominated_weight_sums(w, remaining).to(torch.int32)


def strengths_tiled(w: torch.Tensor) -> torch.Tensor:
    """SPEA2 strength ``S(i) = #{j : i dominates j}`` through K7: negating
    ``w`` flips the direction of domination, so the kernel counts the
    rows each row dominates."""
    return dominated_weight_sums(
        -w, torch.ones(w.shape[0], dtype=torch.float32, device=w.device))


def peel_fronts(count_dominators, n: int, device,
                max_fronts: Optional[int] = None,
                cover_k: Optional[int] = None, fallback: str = "none"):
    """The front-peeling loop of the peeling engines: rows with no
    remaining dominator (``count_dominators(remaining) -> int32[n]``)
    form the next front. ``max_fronts``, ``cover_k`` and ``fallback`` as
    in :func:`nd_rank_tiled`. Returns ``(ranks, fronts peeled)``. The loop
    runs on the host, one synchronise per peel."""
    if fallback not in ("none", "count"):
        raise ValueError(f"unknown nd_rank fallback {fallback!r}")
    stop = n if max_fronts is None else min(max_fronts, n)
    covered_stop = n if cover_k is None else min(cover_k, n)
    ranks = torch.full((n,), n, dtype=torch.int32, device=device)
    remaining = torch.ones(n, dtype=torch.bool, device=device)
    current, covered = 0, 0
    while covered < n and current < stop and covered < covered_stop:
        front = remaining & (count_dominators(remaining) == 0)
        ranks = torch.where(front, current, ranks)
        remaining = remaining & ~front
        current += 1
        covered = n - int(remaining.sum())
    if fallback == "count" and covered < n and current >= stop:
        ranks = torch.where(remaining, current + count_dominators(remaining),
                            ranks)
    return ranks, current


def nd_rank_tiled(w: torch.Tensor, max_fronts: Optional[int] = None, *,
                  cover_k: Optional[int] = None, fallback: str = "none",
                  return_peels: bool = False):
    """Non-domination rank (0 = first front) by peeling fronts, each peel
    one K7 count of the remaining dominators: O(fronts · n²·m) work and
    O(n·m) memory.

    ``max_fronts`` stops peeling early (unpeeled rows keep rank ``n``);
    ``cover_k`` stops once ``cover_k`` rows are ranked (exact for a top-k
    cut); ``fallback='count'`` gives the rows left after a stop on
    ``max_fronts`` the rank ``fronts + #dominators among them``, in one
    more K7 launch. ``return_peels`` also returns the fronts peeled, as an
    int.
    """
    ranks, peels = peel_fronts(lambda rem: dominated_counts(w, rem),
                               w.shape[0], w.device, max_fronts, cover_k,
                               fallback)
    return (ranks, peels) if return_peels else ranks


# ------------------------------------------- GP opcode-major dispatch ----

#: device op name -> (code in csrc/gp_grouped.cu, arity): the closed table
#: of primitives K9 implements. ``identity`` is the branch of the empty
#: mask (only terminals live).
GP_DEVICE_OPS: Dict[str, Tuple[int, int]] = {
    "identity": (0, 1),
    "add": (1, 2),
    "sub": (2, 2),
    "mul": (3, 2),
    "protectedDiv": (4, 2),
    "neg": (5, 1),
    "cos": (6, 1),
    "sin": (7, 1),
    "and": (8, 2),
    "or": (9, 2),
    "not": (10, 1),
    "xor": (11, 2),
    "if_then_else": (12, 3),
    "lt": (13, 2),
    "eq": (14, 2),
    "lf": (15, 1),
}


def gp_lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Device op ``lt``: ``a < b`` as 0.0/1.0 (NaN compares false)."""
    return (a < b).to(torch.float32)


def gp_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Device op ``eq``: ``a == b`` as 0.0/1.0 (NaN compares false)."""
    return (a == b).to(torch.float32)


def gp_logistic(a: torch.Tensor) -> torch.Tensor:
    """Device op ``lf``, the logistic ``1 / (1 + exp(-a))``, rounded as
    K9 rounds it: ``exp`` (on the card PyTorch's kernel calls the same
    ``expf``), then the add, then an IEEE reciprocal, each alone."""
    return torch.reciprocal(torch.exp(-a) + 1.0)


def gp_grouped_dispatch_plain(buf: torch.Tensor, chunk_ops: torch.Tensor,
                              src_idx: torch.Tensor, src_const: torch.Tensor,
                              src_isc: torch.Tensor, ops: Sequence, *,
                              chunk: int, n_args: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`gp_grouped_dispatch`: the JAX
    package's XLA chunk loop, chunk by chunk in order — gather the
    operand rows, let constants replace them, apply the chunk's
    primitive, write the chunk's rows. Updates ``buf`` in place.

    The primitive's own ``fn`` computes each chunk, so a primitive with a
    device op must round as the kernel's code does: the stock sets use
    one elementwise torch operation a code, and :func:`gp_lt`,
    :func:`gp_eq` and :func:`gp_logistic` for codes 13-15."""
    isc = src_isc.to(torch.bool)
    for c, b in enumerate(chunk_ops.tolist()):
        prim = ops[b]
        rows = slice(c * chunk, (c + 1) * chunk)
        si, sc, sb = src_idx[rows].to(torch.int64), src_const[rows], isc[rows]
        ops_in = [torch.where(sb[:, j, None], sc[:, j, None], buf[si[:, j]])
                  for j in range(prim.arity)]
        buf[n_args + c * chunk:n_args + (c + 1) * chunk] = prim.fn(*ops_in)
    return buf


#: branches K9 takes at most (``MAX_BRANCHES`` in csrc/gp_grouped.cu)
GP_MAX_BRANCHES = 16
#: K9's work items: points of an item's tile at most, the rows x points an
#: item aims at, and its rows at most (``kMaxItemRows`` in
#: csrc/gp_grouped.cu: an item's operand descriptors sit in shared memory)
K9_ITEM_POINTS = 256
K9_ITEM_ELEMENTS = 2048
K9_MAX_ITEM_ROWS = 128
#: depth levels K9 takes at most (``kMaxLevels`` in csrc/gp_grouped.cu:
#: the level starts go with the launch, by value)
K9_MAX_LEVELS = 512
#: ints of a 128-byte line: K9's workspace gives each level's count one
#: (``kLine`` in csrc/gp_grouped.cu)
K9_LINE = 32


def k9_item_shape(chunk: int, P: int) -> Tuple[int, int]:
    """K9's work item at ``chunk`` rows a chunk and ``P`` points: ``(rows,
    tile)``, about :data:`K9_ITEM_ELEMENTS` rows x points (8 rows at P
    256), so the first level of a gen-0 schedule gives every SM several
    items and a one-chunk level still spreads over many."""
    tile = min(P, K9_ITEM_POINTS)
    return max(1, min(chunk, K9_MAX_ITEM_ROWS, K9_ITEM_ELEMENTS // tile)), tile


def k9_work_items(level_starts: Sequence[int], chunk: int, P: int):
    """K9's work items for a grouped schedule evaluated at ``P`` points,
    decoded from their tickets as the kernel decodes them: ``(table
    int32[n_items, 4], tile, level_first int32[nlevels + 1])``. Item ``i``
    is rows ``[table[i, 0], table[i, 1])`` (of one chunk, at most
    :data:`K9_MAX_ITEM_ROWS`) at points ``[table[i, 2], min(table[i, 2] +
    tile, P))``, of level ``table[i, 3]``. Items are numbered in schedule
    order (chunk, row run, point tile), the order the kernel hands them
    out. ``level_first[l]`` is the items of the levels before ``l`` (the
    wait count of level ``l``: its items start once they are done), and
    ``level_first[-1]`` the item count.

    :param level_starts: the chunk where each dependency level starts,
        then the chunk count (``build_grouped_schedule``'s
        ``level_starts``).
    """
    rows, tile = k9_item_shape(chunk, P)
    ntiles = -(-P // tile)
    per_chunk = -(-chunk // rows) * ntiles
    starts = np.asarray(level_starts, np.int64)
    c, in_chunk = np.divmod(np.arange(int(starts[-1]) * per_chunk), per_chunk)
    run, t = np.divmod(in_chunk, ntiles)
    begin = c * chunk + run * rows
    table = np.stack([begin, np.minimum(begin + rows, (c + 1) * chunk),
                      t * tile,
                      np.searchsorted(starts, c, side="right") - 1], 1)
    return table.astype(np.int32), tile, (starts * per_chunk).astype(np.int32)


def _branch_codes(ops: Sequence):
    """The device op code of each branch, as a ctypes int array for the
    launcher (which passes it by value with each launch)."""
    if len(ops) > GP_MAX_BRANCHES:
        raise ValueError(f"the grouped kernel takes at most "
                         f"{GP_MAX_BRANCHES} primitives, got {len(ops)}")
    codes = []
    for p in ops:
        if p.device_op is None:
            raise ValueError(
                f"primitive {p.name!r} has no device op: the grouped "
                f"kernel implements only {sorted(GP_DEVICE_OPS)}; evaluate "
                f"this set with mode='scan' (or 'sweep')")
        codes.append(GP_DEVICE_OPS[p.device_op][0])
    return (ctypes.c_int * len(codes))(*codes)


_K9_COUNTERS: Dict = {}


def _k9_counters(dev, stream: int, nlevels: int) -> torch.Tensor:
    """K9's workspace for launches on ``stream``: the ticket, then each
    level's finished count, a line each; zeroed when made (or grown), and
    each launch leaves it at 0 (csrc/gp_grouped.cu). Launches on one
    stream do not overlap."""
    key = (dev, stream)
    size = K9_LINE * (1 + nlevels)
    counters = _K9_COUNTERS.get(key)
    if counters is None or counters.numel() < size:
        counters = _K9_COUNTERS[key] = torch.zeros(size, dtype=torch.int32,
                                                   device=dev)
    return counters


def gp_grouped_dispatch(buf: torch.Tensor, chunk_ops: torch.Tensor,
                        src_idx: torch.Tensor, src_const: torch.Tensor,
                        src_isc: torch.Tensor, ops: Sequence, *, chunk: int,
                        n_args: int, levels: Sequence[int]) -> torch.Tensor:
    """Evaluate a grouped GP schedule into its value buffer (K9): for every
    instruction row ``r`` of chunk ``c = r // chunk``, ``buf[n_args + r] =
    ops[chunk_ops[c]](x_0, ...)`` with ``x_j = src_const[r, j]`` where
    ``src_isc[r, j]``, else ``buf[src_idx[r, j]]`` (a select: a gathered
    NaN never leaks through a constant).

    On the card the kernel launches once, over the work items of
    :func:`k9_work_items` (the level starts and item shape go with the
    launch, by value), and carries the levels' order itself; on the
    CPU the chunk loop runs (:func:`gp_grouped_dispatch_plain`). Kernel
    and plain version agree bitwise: each element is one IEEE operation
    (or ``cosf``/``sinf``/``expf`` on the card) on the same operands. The
    wrapper's ``launches`` counts the launches (one a call), ``levels``
    the levels they evaluated.

    :param buf: ``f32[n_args + nchunks·chunk, P]``, argument rows filled;
        updated in place and returned.
    :param chunk_ops: ``int32[nchunks]`` branch index per chunk.
    :param src_idx: ``int32[nchunks·chunk, max_ar]`` operand rows, each in
        ``[0, len(buf))``.
    :param src_const: ``f32[nchunks·chunk, max_ar]`` inline constants.
    :param src_isc: ``bool[nchunks·chunk, max_ar]`` operand-is-constant.
    :param ops: the branches, ``gp.pset`` primitives (``fn``, ``arity``,
        ``device_op``); on the card each needs a device op.
    :param levels: chunk indices where each dependency level starts, then
        ``nchunks`` (``build_grouped_schedule``'s ``level_starts``): a
        level reads only argument rows and rows of earlier levels.
    """
    if buf.device.type == "cpu":
        return gp_grouped_dispatch_plain(buf, chunk_ops, src_idx, src_const,
                                         src_isc, ops, chunk=chunk,
                                         n_args=n_args)
    if buf.device.type != "cuda":
        raise ValueError(f"no kernel for device {buf.device}")
    dev = buf.device
    codes = _branch_codes(ops)
    nchunks = chunk_ops.shape[0]
    total, max_ar = nchunks * chunk, src_idx.shape[1]
    R, P = buf.shape
    if R != n_args + total or R * P > _INT_MAX:
        raise ValueError(f"buf must have n_args + nchunks*chunk = "
                         f"{n_args + total} rows and fewer than 2^31 "
                         f"elements, got {tuple(buf.shape)}")
    _check_cuda("buf", dev, torch.float32, (R, P), buf)
    _check_cuda("chunk_ops", dev, torch.int32, (nchunks,), chunk_ops)
    _check_cuda("src_idx", dev, torch.int32, (total, max_ar), src_idx)
    _check_cuda("src_const", dev, torch.float32, (total, max_ar), src_const)
    _check_cuda("src_isc", dev, torch.bool, (total, max_ar), src_isc)
    levels = tuple(int(v) for v in levels)
    if (len(levels) < 2 or levels[0] != 0 or levels[-1] != nchunks
            or any(b <= a for a, b in zip(levels, levels[1:]))):
        raise ValueError(f"levels must rise strictly from 0 to nchunks="
                         f"{nchunks}, got {list(levels)}")
    nlevels = len(levels) - 1
    if nlevels > K9_MAX_LEVELS:
        raise ValueError(f"the grouped kernel takes at most {K9_MAX_LEVELS} "
                         f"depth levels, got {nlevels}; evaluate this "
                         f"population with mode='scan'")
    rows, tile = k9_item_shape(chunk, P)
    starts = (ctypes.c_int * len(levels))(*levels)
    stream = torch.cuda.current_stream(dev).cuda_stream
    PT, I = _build.PTR, _build.INT
    fn = _build.function("gp_grouped", "gp_grouped_dispatch",
                         [PT] * 7 + [I, PT] + [I] * 8 + [PT])
    err = fn(buf.data_ptr(), chunk_ops.data_ptr(), ctypes.addressof(codes),
             src_idx.data_ptr(), src_const.data_ptr(), src_isc.data_ptr(),
             ctypes.addressof(starts), nlevels,
             _k9_counters(dev, stream, nlevels).data_ptr(), n_args, R, P,
             rows, tile, max_ar, chunk, len(ops), stream)
    gp_grouped_dispatch.launches += 1
    gp_grouped_dispatch.levels += nlevels
    _build.check("gp_grouped", err, "gp_grouped_dispatch")
    return buf


gp_grouped_dispatch.launches = 0
gp_grouped_dispatch.levels = 0
