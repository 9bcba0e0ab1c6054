"""Batched symmetric eigendecomposition by fixed-sweep parallel Jacobi.

Port of :mod:`deap_tpu.ops.linalg`. :func:`eigh_jacobi` has the
``torch.linalg.eigh`` contract (ascending eigenvalues, orthonormal
columns, ``C ≈ V diag(w) Vᵀ``) on ``[..., d, d]`` inputs, by the JAX
package's algorithm: ``A = (C + Cᵀ)/2``, then ``sweeps × (m − 1)``
rounds (``m`` = d rounded up to even) of a round-robin schedule, each
round rotating ``m/2`` disjoint index pairs at once as row, then column
pair combinations of A and column pair combinations of V, the rotated
pivots set to zero; the diagonal, sorted stably, is the spectrum. The
schedule is fixed, so there is no data-dependent control flow.

- :func:`eigh_jacobi` (J1, ``csrc/jacobi_eigh.cu``): one CUDA block a
  matrix, every round in one launch, A and V in shared memory up to d
  :data:`J1_SHARED_MAX_D` and in device memory above. The JAX function
  is XLA, not Pallas: J1 is the port's own kernel for it.
- :func:`eigh_jacobi_plain`: the same rounds in plain PyTorch (about
  twenty launches a round on the card).

Rounding: each product, sum, quotient and square root of a round is
rounded on its own, in both versions (no fused multiply-add), so the
kernel equals the plain version bit for bit, signed zeros included.
Against the JAX function the results agree to a tolerance only: XLA
contracts ``a*b + c`` in the jitted body.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from deap_tpu_torch import _build

__all__ = ["eigh_jacobi", "eigh_jacobi_plain", "default_sweeps",
           "J1_SHARED_MAX_D", "JACOBI_W_RTOL", "JACOBI_RECON_TOL"]

#: the plain version against the JAX function on the same input (the JAX
#: function's jitted rounds contract ``a*b + c``, the port rounds each
#: operation): eigenvalues within ``JACOBI_W_RTOL`` of the largest
#: (measured 7.8e-6 at d 100), ``V diag(w) Vᵀ − C`` and ``VᵀV − I`` within
#: ``JACOBI_RECON_TOL`` of C's largest entry and of 1 (measured 3.3e-5
#: and 2.2e-5); eigenvectors as ``strategies.cma.EIG_GAP``/``BASIS_TOL``
#: say. The kernel against the plain version: bitwise.
JACOBI_W_RTOL, JACOBI_RECON_TOL = 2e-5, 1e-4

#: dynamic shared memory one block may opt into on sm_90 (232,448 bytes)
J1_MAX_SHARED = 232_448
#: J1's threads a block, at most
J1_MAX_THREADS = 1024


def _round_robin_schedule(d: int) -> Tuple[np.ndarray, np.ndarray]:
    """The circle-method tournament schedule: ``m - 1`` rounds of
    ``m // 2`` disjoint pairs covering every (p, q) once a sweep (``m`` =
    d rounded up to even; an odd d's bye is a ``(b, b)`` self-pair,
    rotated by the identity). ``(ps, qs)`` are int32 ``[m - 1, m // 2]``,
    ``ps <= qs``."""
    m = d + (d % 2)
    players = list(range(m))
    ps, qs = [], []
    for _ in range(m - 1):
        rp, rq = [], []
        for k in range(m // 2):
            a, b = players[k], players[m - 1 - k]
            if a >= d:  # the bye slot of an odd dimension
                a = b
            elif b >= d:
                b = a
            rp.append(min(a, b))
            rq.append(max(a, b))
        ps.append(rp)
        qs.append(rq)
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(ps, np.int32), np.asarray(qs, np.int32)


def default_sweeps(d: int) -> int:
    """The JAX package's default: 5 sweeps up to d 8, one more for each
    doubling past it (9 at d 100)."""
    return 5 + max(0, int(np.ceil(np.log2(d / 8))) if d > 8 else 0)


def _shared_bytes(d: int, ld: int) -> int:
    """J1's dynamic shared memory at row stride ``ld``: A and V when they
    live there, and each pair's c, s and packed (p, q)."""
    npairs = (d + d % 2) // 2
    return 2 * d * ld * 4 + 12 * npairs


def _j1_plan(d: int) -> Tuple[int, int, int]:
    """``(ld, shared_bytes, threads)`` of J1 at dimension ``d``. ``ld`` is
    the row stride of A and V in shared memory: odd (``d + 1`` for an even
    d) so that a warp walking a column hits 32 banks, ``d`` where the
    padding does not fit, and 0 where A and V do not fit at all (they
    stay in device memory; only the pair data is shared)."""
    npairs = (d + d % 2) // 2
    threads = min(J1_MAX_THREADS, max(32, -(-npairs * d // 32) * 32))
    for ld in ((d + 1, d) if d % 2 == 0 else (d,)):
        if _shared_bytes(d, ld) <= J1_MAX_SHARED:
            return ld, _shared_bytes(d, ld), threads
    return 0, 12 * npairs, threads


#: the largest d whose A and V J1 keeps in shared memory (170)
J1_SHARED_MAX_D = max(d for d in range(2, 256) if _j1_plan(d)[0])


@functools.lru_cache(maxsize=None)
def _plain_tables(d: int, device: torch.device):
    """The plain version's per-round tables: pairs, the pair and partner of
    each index, the sign each index's partner term takes (−1 at a pair's
    low index, +1 at its high one, 0 for a bye) and the pivot mask (0 at
    the rotated pivots, else 1)."""
    ps, qs = _round_robin_schedule(d)
    n_rounds, npairs = ps.shape
    real = ps != qs
    pair_of = np.zeros((n_rounds, d), np.int64)
    partner = np.tile(np.arange(d, dtype=np.int64), (n_rounds, 1))
    role = np.zeros((n_rounds, d), np.float32)
    piv = np.ones((n_rounds, d, d), np.float32)
    for r in range(n_rounds):
        k = np.arange(npairs)
        pair_of[r, ps[r]] = k
        pair_of[r, qs[r]] = k
        p, q = ps[r][real[r]], qs[r][real[r]]
        partner[r, p], partner[r, q] = q, p
        role[r, p], role[r, q] = -1.0, 1.0
        piv[r, p, q] = piv[r, q, p] = 0.0
    to = lambda a: torch.from_numpy(a).to(device)
    return (to(ps.astype(np.int64)), to(qs.astype(np.int64)), to(real),
            to(pair_of), to(partner), to(role), to(piv))


@functools.lru_cache(maxsize=None)
def _kernel_tables(d: int, device: torch.device) -> torch.Tensor:
    """J1's schedule: ``int32[m - 1, m // 2]``, each pair packed as ``p |
    q << 16``."""
    ps, qs = _round_robin_schedule(d)
    return torch.from_numpy(ps | (qs << 16)).to(device)


def _check_square(C: torch.Tensor) -> int:
    if C.ndim < 2 or C.shape[-2] != C.shape[-1]:
        raise ValueError(f"eigh_jacobi needs a square matrix, got "
                         f"{tuple(C.shape)}")
    return int(C.shape[-1])


def _sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernel's ``__fsqrt_rn``:
    through float64, whose root rounds to float32 without a double
    rounding error. ``torch.sqrt`` on the CPU is vectorised and may be off
    by an ulp."""
    return torch.sqrt(x.double()).to(x.dtype)


def _sorted(w: torch.Tensor, V: torch.Tensor):
    """Eigenvalues ascending (stable, as ``jnp.argsort``) and V's columns
    in their order."""
    w, order = torch.sort(w, dim=-1, stable=True)
    return w, V.gather(-1, order[..., None, :].expand(V.shape))


def eigh_jacobi_plain(C: torch.Tensor,
                      sweeps: Optional[int] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """J1's plain version: :func:`eigh_jacobi`'s rounds in plain PyTorch,
    each operation rounded on its own."""
    d = _check_square(C)
    if d == 1:
        return C[..., 0, 0][..., None], torch.ones_like(C)
    sweeps = default_sweeps(d) if sweeps is None else int(sweeps)
    batch = C.shape[:-2]
    ps, qs, real, pair_of, partner, role, piv = _plain_tables(d, C.device)
    n_rounds = ps.shape[0]
    C3 = C.reshape((-1, d, d))
    A = 0.5 * (C3 + C3.mT)
    V = torch.eye(d, dtype=C.dtype, device=C.device).expand(
        A.shape).contiguous()
    tiny = torch.finfo(C.dtype).tiny
    for i in range(sweeps * n_rounds):
        r = i % n_rounds
        p, q = ps[r], qs[r]
        app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
        small = (apq.abs() <= tiny) | ~real[r]
        tau = (aqq - app) / torch.where(small, 1.0, 2.0 * apq)
        t = torch.sign(tau) / (tau.abs() + _sqrt_rn(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        c = torch.reciprocal(_sqrt_rn(1.0 + t * t))
        s = torch.where(small, 0.0, t * c)
        c = torch.where(small, 1.0, c)
        # per index: its pair's c, and the partner term's coefficient
        # (−s at the low index, +s at the high one, +0 for a bye)
        cvec = c[:, pair_of[r]]
        svp = s[:, pair_of[r]] * role[r]
        part = partner[r]
        Bm = cvec[:, :, None] * A + svp[:, :, None] * A[:, part, :]
        A = (cvec[:, None, :] * Bm + svp[:, None, :] * Bm[:, :, part]) * piv[r]
        V = cvec[:, None, :] * V + svp[:, None, :] * V[:, :, part]
    w, V = _sorted(torch.diagonal(A, dim1=-2, dim2=-1), V)
    return w.reshape(batch + (d,)), V.reshape(batch + (d, d))


def eigh_jacobi(C: torch.Tensor,
                sweeps: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition of ``C [..., d, d]`` by fixed-sweep
    parallel Jacobi: ``(w [..., d], V [..., d, d])``, eigenvalues ascending
    (a stable sort), ``C ≈ V diag(w) Vᵀ``. ``sweeps`` defaults to
    :func:`default_sweeps`.

    On the card J1 runs every round in one launch, one block a matrix,
    and ``torch.sort`` orders the spectrum; a CUDA tensor must be float32
    and contiguous. A CPU tensor takes the plain version. ``launches``
    counts J1's launches.
    """
    d = _check_square(C)
    if C.device.type == "cpu":
        return eigh_jacobi_plain(C, sweeps)
    if C.device.type != "cuda":
        raise ValueError(f"no kernel for device {C.device}")
    if C.dtype != torch.float32:
        raise TypeError(f"eigh_jacobi's kernel takes float32, got {C.dtype}")
    if not C.is_contiguous():
        raise ValueError("eigh_jacobi's kernel needs a contiguous matrix")
    if d == 1:
        return C[..., 0, 0][..., None], torch.ones_like(C)
    sweeps = default_sweeps(d) if sweeps is None else int(sweeps)
    batch = C.shape[:-2]
    nmat = math.prod(batch)
    w = torch.empty(batch + (d,), dtype=torch.float32, device=C.device)
    V = torch.empty(batch + (d, d), dtype=torch.float32, device=C.device)
    if nmat == 0:
        return w, V
    ld, smem, threads = _j1_plan(d)
    # A lives in device memory where it does not fit in shared memory
    work = (torch.empty(0, device=C.device) if ld else
            torch.empty(batch + (d, d), dtype=torch.float32,
                        device=C.device))
    pairs = _kernel_tables(d, C.device)
    P, I = _build.PTR, _build.INT
    fn = _build.function("jacobi_eigh", "jacobi_eigh",
                         [P, P, P, P, P, I, I, I, I, I, I, I, P])
    err = fn(C.data_ptr(), pairs.data_ptr(), w.data_ptr(), V.data_ptr(),
             work.data_ptr(), nmat, d, pairs.shape[0], sweeps, ld, smem,
             threads, torch.cuda.current_stream(C.device).cuda_stream)
    eigh_jacobi.launches += 1
    _build.check("jacobi_eigh", err, "eigh_jacobi")
    return _sorted(w, V)


eigh_jacobi.launches = 0
