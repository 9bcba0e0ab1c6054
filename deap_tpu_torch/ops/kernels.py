"""Hand-written CUDA kernels of the variation plane, and their helpers.

Port of the main-path part of :mod:`deap_tpu.ops.kernels`:
:func:`fused_variation` (the TPU's Pallas kernel of the same name) runs
``csrc/fused_variation.cu`` on CUDA tensors and its plain PyTorch version,
:func:`deap_tpu_torch.ops.variation.apply_variation`, on CPU tensors.
Nothing else decides between the two, and a CUDA tensor never takes the
plain path.

``_u01`` and ``_pair_consistent`` are the shared random-bit conventions
of the fused kernels (``ops.packed`` uses them too).
"""

from __future__ import annotations

from typing import Optional

import torch

from deap_tpu_torch import _build
from deap_tpu_torch.ops.variation import apply_variation

__all__ = ["fused_variation", "KERNEL_DTYPES"]

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
    if n == 0:
        return out
    lib_fn = "fused_variation_u8" if genomes.dtype == torch.bool \
        else "fused_variation_f32"
    fn = _build.function("fused_variation", lib_fn, [_build.PTR] * 10 + [
        _build.INT, _build.INT, _build.INT, _build.PTR])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(genomes.data_ptr(), src_idx.data_ptr(), partner_idx.data_ptr(),
             cx_row.data_ptr(), lo.data_ptr(), hi.data_ptr(),
             mut_row.data_ptr(), mut_mask.data_ptr(), _ptr(mut_arg),
             out.data_ptr(), n, L, _KINDS[mut_kind], stream)
    fused_variation.launches += 1
    _build.check("fused_variation", err, "fused_variation")
    return out


fused_variation.launches = 0
