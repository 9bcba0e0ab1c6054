"""Fused generation kernel for real-valued GAs.

Port of :mod:`deap_tpu.ops.kernels_real`: the real-genome twin of
:func:`deap_tpu_torch.ops.kernels.fused_variation_eval` for the continuous
eaSimple configuration — blend crossover, Gaussian mutation and the
fitness function in one pass over the ``[n, L]`` float32 genomes.

- :func:`fused_variation_eval_real` (K6, ``csrc/fused_variation_real.cu``),
  plain version :func:`fused_variation_eval_real_plain`, random bits from
  :func:`real_bits` (``prng='input'``) or made inside the kernel by
  Philox (``prng='hw'``; the streams of
  :func:`deap_tpu_torch.ops.philox.hw_real_bits`).

Semantics, per adjacent pair (the even row's draws decide for both rows;
an odd last row never mates):

- blend: per gene ``γ = (1+2α)·u − α`` from the even row's γ plane, both
  rows ``child = (1−γ)·self + γ·partner``;
- Gaussian: each gene of a row that mutates (``rowu < mutpb``) gets
  ``+ μ + σ·z`` where its gate plane is below ``indpb``, ``z`` a Box–Muller
  normal ``sqrt(−2·log1p(−u1))·cos(2π·u2)``;
- then Rastrigin or sphere.

Rounding: the JAX package's kernel, compiled by XLA on the CPU, computes
the γ line and the blend as two fused multiply-adds, ``fma(1+2α, u, −α)``
and ``fma(γ, partner, (1−γ)·self)``. The port computes exactly those: the
kernel with ``__fmaf_rn``, the plain version with :func:`_fma32`, an exact
float64 emulation. Everything else rounds each operation on its own (the
kernel writes those products and sums with round-to-nearest intrinsics
that are never contracted), so a gene that is only crossed, or untouched,
is bitwise equal across the three; a mutated gene and the fitness differ
by the last bits of ``log1p``, ``cos`` and the order of the sum.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from deap_tpu_torch import _build
from deap_tpu_torch import benchmarks
from deap_tpu_torch.ops import philox
from deap_tpu_torch.ops.kernels import (
    _check_cuda,
    _f32,
    _pair_consistent,
    _pair_decisions,
    _partner_rows,
    _prng_mode,
    _u01,
    _words,
    fused_bits,
)

__all__ = ["fused_variation_eval_real", "fused_variation_eval_real_plain",
           "real_bits", "eval_rastrigin", "eval_sphere",
           "real_kernel_errors"]

_TWO_PI = 6.283185307179586
#: gene-bit planes per gene: γ, mutation gate, Box–Muller u1, u2
PLANES = 4
#: K6 against a reference (:func:`real_kernel_errors`): a mutated gene
#: within this many units in the last place of its step plus one of the
#: gene (the final add), the fitness within the JAX package's own test
#: tolerance (tests/test_kernels.py)
STEP_ULPS, FIT_RTOL, FIT_ATOL = 4, 1e-5, 1e-8


def eval_rastrigin(children: torch.Tensor) -> torch.Tensor:
    """Rastrigin per row, ``10·L + Σ x² − 10·cos(2πx)`` → ``f32[n]``."""
    return benchmarks.rastrigin(children)[:, 0]


def eval_sphere(children: torch.Tensor) -> torch.Tensor:
    """``Σ x²`` per row → ``f32[n]``."""
    return benchmarks.sphere(children)[:, 0]


_EVALS = {"rastrigin": eval_rastrigin, "sphere": eval_sphere}
_EVAL_CODES = {"rastrigin": 1, "sphere": 2}  # 0: no evaluation in the kernel


def _boxmuller(u1: torch.Tensor, u2: torch.Tensor) -> torch.Tensor:
    """Standard normals from two U[0,1) planes; ``1-u1 ∈ (0, 1]`` keeps
    the log finite (24-bit uniforms never reach 1.0)."""
    r = torch.sqrt(-2.0 * torch.log1p(-u1))
    return r * torch.cos(_TWO_PI * u2)


def _fma32(a, b, c) -> torch.Tensor:
    """Correctly rounded float32 ``a·b + c``, one rounding, as
    ``__fmaf_rn``. The product of two float32 values is exact in float64;
    the sum is rounded to odd in float64 (TwoSum gives its exact error,
    and an inexact result with an even last bit moves one step towards
    it), and rounding that to float32 is then the correctly rounded
    result (float64 has more than 24 + 2 bits)."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    bc = s - p
    err = (p - (s - bc)) + (c - bc)
    even = (s.view(torch.int64) & 1) == 0
    towards = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    s = torch.where((err != 0) & even, torch.nextafter(s, towards), s)
    return s.to(torch.float32)


def real_bits(generator: torch.Generator, n: int, L: int):
    """The bit streams of one :func:`fused_variation_eval_real` call:
    ``(pairbits [n, 4], rowbits [n, 1], genebits [n, 4 L])``, gene plane
    ``p`` (γ, gate, u1, u2) in columns ``[p L, (p+1) L)``."""
    return fused_bits(generator, n, PLANES * L)


def _evaluate(evaluate: Union[str, Callable],
              children: torch.Tensor) -> torch.Tensor:
    fn = _EVALS[evaluate] if isinstance(evaluate, str) else evaluate
    return fn(children).reshape(children.shape[0]).to(torch.float32)


def fused_variation_eval_real_plain(genomes, pairbits, rowbits, genebits, *,
                                    cxpb, mutpb, indpb, alpha=0.5, mu=0.0,
                                    sigma=1.0, evaluate="rastrigin"):
    """Plain PyTorch version of :func:`fused_variation_eval_real`."""
    n, L = genomes.shape
    planes = _words(genebits).reshape(n, PLANES, L)
    do_cx, _, _ = _pair_decisions(pairbits, L, cxpb)
    gammau = _u01(_pair_consistent(planes[:, 0]))
    gamma = _fma32(_f32(1.0 + 2.0 * alpha), gammau, -_f32(alpha))
    blended = _fma32(gamma, _partner_rows(genomes), (1.0 - gamma) * genomes)
    child = torch.where(do_cx[:, None], blended, genomes)
    do_mut = _u01(_words(rowbits))[:, 0:1] < _f32(mutpb)
    gate = do_mut & (_u01(planes[:, 1]) < _f32(indpb))
    step = mu + sigma * _boxmuller(_u01(planes[:, 2]), _u01(planes[:, 3]))
    child = child + torch.where(gate, step, 0.0)
    return child, _evaluate(evaluate, child)


def fused_variation_eval_real(
        genomes: torch.Tensor, pairbits: Optional[torch.Tensor] = None,
        rowbits: Optional[torch.Tensor] = None,
        genebits: Optional[torch.Tensor] = None, *, cxpb: float,
        mutpb: float, indpb: float, alpha: float = 0.5, mu: float = 0.0,
        sigma: float = 1.0, evaluate: Union[str, Callable] = "rastrigin",
        prng: Optional[str] = None,
        generator: Optional[torch.Generator] = None,
        key: Optional[torch.Tensor] = None,
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused eaSimple variation and evaluation pass over float32
    genomes (K6): ``var_and`` with ``cx_blend(alpha)`` and
    ``mut_gaussian(mu, sigma, indpb)`` followed by a full evaluation, in
    one pass (see the module docstring for the rules and the rounding).

    :param genomes: ``f32[n, L]``.
    :param pairbits, rowbits, genebits: ``uint32`` ``[n, 4]``, ``[n, 1]``,
        ``[n, 4 L]``, e.g. from :func:`real_bits`: the bits of
        ``prng='input'``.
    :param evaluate: ``"rastrigin"`` or ``"sphere"``, evaluated inside the
        kernel; or a callable ``fn(children f32[n, L]) -> f32[n]``. A
        callable cannot be compiled into CUDA: the kernel then runs the
        variation with its evaluation switched off and the callable is
        applied to the children in PyTorch afterwards.
    :param prng: ``'input'`` (the default where bits are passed), ``'hw'``
        (Philox in the kernel, keyed from ``generator`` or ``key``, in the
        streams of :func:`deap_tpu_torch.ops.philox.hw_real_bits`; bits
        refused) or ``'auto'`` (the default without bits: ``'hw'`` on the
        card, ``'input'`` on the CPU), as K2's
        :func:`~deap_tpu_torch.ops.kernels.fused_variation_eval`.
        ``fused_variation_eval_real.hw_launches`` counts the Philox
        launches (within ``launches``).
    :returns: ``(children f32[n, L], fitness f32[n])``.
    """
    dev = genomes.device
    mode, key = _prng_mode("fused_variation_eval_real", prng, dev,
                           (pairbits, rowbits, genebits), generator, key)
    if isinstance(evaluate, str) and evaluate not in _EVALS:
        raise ValueError(f"unknown evaluate {evaluate!r}; built-ins are "
                         f"{sorted(_EVALS)} (or pass a callable)")
    if genomes.dtype != torch.float32:
        raise TypeError(f"fused_variation_eval_real takes float32 genomes, "
                        f"got {genomes.dtype}")
    kw = dict(cxpb=cxpb, mutpb=mutpb, indpb=indpb, alpha=alpha, mu=mu,
              sigma=sigma, evaluate=evaluate)
    n, L = genomes.shape
    if dev.type == "cpu":
        if mode == "hw":
            pairbits, rowbits, genebits = philox.hw_real_bits(key, n, L)
        return fused_variation_eval_real_plain(genomes, pairbits, rowbits,
                                               genebits, **kw)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    _check_cuda("genomes", dev, torch.float32, (n, L), genomes)
    if mode == "input":
        _check_cuda("pairbits", dev, torch.uint32, (n, 4), pairbits)
        _check_cuda("rowbits", dev, torch.uint32, (n, 1), rowbits)
        _check_cuda("genebits", dev, torch.uint32, (n, PLANES * L),
                    genebits)
    out = torch.empty((n, L), dtype=torch.float32, device=dev)
    fit = torch.empty((n,), dtype=torch.float32, device=dev)
    code = _EVAL_CODES[evaluate] if isinstance(evaluate, str) else 0
    P, I, F = _build.PTR, _build.INT, _build.FLOAT
    params = (n, L, _f32(cxpb), _f32(mutpb), _f32(indpb),
              _f32(1.0 + 2.0 * alpha), _f32(alpha), _f32(mu), _f32(sigma),
              code, torch.cuda.current_stream(dev).cuda_stream)
    if mode == "hw":
        fn = _build.function("fused_variation_real", "fused_variation_real_hw",
                             [P] * 4 + [I, I] + [F] * 7 + [I, P])
        err = fn(genomes.data_ptr(), key.data_ptr(), out.data_ptr(),
                 fit.data_ptr(), *params)
        fused_variation_eval_real.hw_launches += 1
    else:
        fn = _build.function("fused_variation_real", "fused_variation_real",
                             [P] * 6 + [I, I] + [F] * 7 + [I, P])
        err = fn(genomes.data_ptr(), pairbits.data_ptr(), rowbits.data_ptr(),
                 genebits.data_ptr(), out.data_ptr(), fit.data_ptr(),
                 *params)
    fused_variation_eval_real.launches += 1
    _build.check("fused_variation_real", err, "fused_variation_eval_real")
    if code == 0:
        fit = _evaluate(evaluate, out)
    return out, fit


fused_variation_eval_real.launches = 0
fused_variation_eval_real.hw_launches = 0


def real_kernel_errors(got, want, pairbits, rowbits, genebits, *, mutpb,
                       indpb, mu, sigma):
    """K6 ``(children, fitness)`` against a reference's on the same bits:
    genes that no mutation touched (crossed or untouched) must be bitwise
    equal, a mutated gene within ``STEP_ULPS`` units in the last place of
    its step plus one of the gene, the fitness within ``FIT_RTOL``. The
    decisions come from the draws, so a crossover or mutation decision
    taken differently shows as a whole step or blend of difference.
    Returns the verdict ``ok`` and the largest errors."""
    child, fit = got
    ref, ref_fit = want
    n, L = child.shape
    planes = _u01(_words(genebits)).reshape(n, PLANES, L)
    gate = ((_u01(_words(rowbits))[:, 0:1] < _f32(mutpb))
            & (planes[:, 1] < _f32(indpb)))
    step = mu + sigma * _boxmuller(planes[:, 2], planes[:, 3])

    def ulp(x):
        x = x.abs()
        return torch.nextafter(x, torch.full_like(x, torch.inf)) - x

    same = torch.equal(child[~gate].view(torch.int32),
                       ref[~gate].view(torch.int32))
    diff = (child[gate] - ref[gate]).abs()
    step_ulp = ulp(step[gate])
    mut_ok = bool((diff <= STEP_ULPS * step_ulp + ulp(ref[gate])).all())
    fit_diff = (fit - ref_fit).abs()
    fit_ok = bool((fit_diff <= FIT_ATOL + FIT_RTOL * ref_fit.abs()).all())
    return {"ok": same and mut_ok and fit_ok, "unmutated": int((~gate).sum()),
            "mutated": int(gate.sum()),
            # in units of one ulp of the step plus one of the gene
            "max_ulps": float((diff / (step_ulp + ulp(ref[gate]))).max())
            if diff.numel() else 0.0,
            "max_abs": float(diff.max()) if diff.numel() else 0.0,
            "max_fit_abs": float(fit_diff.max()) if n else 0.0,
            "max_fit_rel": float((fit_diff / ref_fit.abs()).max()) if n
            else 0.0}
