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
  matrix, every round in one launch; A warps compute a round's rotations
  and make one in-place pass over A by 2x2 pair blocks, V warps rotate V's
  rows behind them from a ring of the last rounds' rotations
  (:func:`_j1_split`), or, where every matrix's two blocks fit on the card
  at once (:func:`_j1_splits`), from a log in device memory on a second
  SM; A and Vᵀ in shared memory up to
  d :data:`J1_SHARED_MAX_D` and in device memory above; the spectrum
  sorted in the kernel. The JAX function is XLA, not Pallas: J1 is the
  port's own kernel for it.
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

__all__ = ["eigh_jacobi", "eigh_jacobi_plain", "default_sweeps", "sqrt_rn",
           "fma_rn",
           "norm_rn", "div_rn", "J1_SHARED_MAX_D", "JACOBI_W_RTOL",
           "JACOBI_RECON_TOL"]

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
#: the ctypes argument types of J1's launcher, ``csrc/jacobi_eigh.cu::
#: jacobi_eigh``
J1_ARGTYPES = (_build.PTR,) * 4 + (_build.INT,) * 11 + (_build.PTR,) * 4


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


#: the most ring slots (rounds of rotations the V warps may lag by)
J1_MAX_SLOTS = 2
#: J1's V threads and pass threads, at most
J1_MAX_V_THREADS, J1_MAX_PASS_THREADS = 384, 512
#: the largest d J1 takes (a round's pair is stored as p | q << 16)
J1_MAX_D = 32767
#: J1 gives each pair a pivot thread up to this many pairs (d 1,920),
#: beside a pass warp and a V warp; above it, this many pivot threads
#: take the pairs in turn
J1_MAX_PIVOT_THREADS, J1_PAIRS_IN_TURN_THREADS = J1_MAX_THREADS - 64, 128


def _npairs(d: int) -> int:
    return (d + d % 2) // 2


def _j1_pivots(d: int) -> int:
    """J1's pivot threads: a thread a pair, in whole warps, up to
    :data:`J1_MAX_PIVOT_THREADS`; above it
    :data:`J1_PAIRS_IN_TURN_THREADS`, each taking the pairs ``k, k +
    threads, ...`` in turn."""
    n = -(-_npairs(d) // 32) * 32
    return n if n <= J1_MAX_PIVOT_THREADS else J1_PAIRS_IN_TURN_THREADS


def _shared_bytes(d: int, ld: int, slots: int) -> int:
    """J1's dynamic shared memory at A's row stride ``ld`` (0: A and V in
    device memory): Vᵀ (column stride d rounded up to even) and A (its
    size rounded up to even) where they live there, and ``slots`` rounds
    of each pair's c, s (float2) and packed (p, q) (int32)."""
    ldv = d + d % 2
    return ((4 * (d * ldv + (d * ld + 1) // 2 * 2) if ld else 0)
            + 12 * _npairs(d) * slots)


def _j1_split(d: int) -> Tuple[int, int, int]:
    """``(n_a, n_v, groups)``: J1's pivot and pass threads, its V threads,
    and the pass threads a column pair. :func:`_j1_pivots` pivot threads;
    a V warp for about each 400 (pair, row) units of V a round, at
    most :data:`J1_MAX_V_THREADS`; pass threads for about two of the
    m²/4 blocks each, at most :data:`J1_MAX_PASS_THREADS`. The pass
    threads ``t < groups · m/2`` own column pair ``t mod m/2`` and the row
    pairs ``t div m/2 + j · groups``; above d 1,024 they are fewer than the
    pairs (one group, each thread the column pairs ``t, t + n_pass,
    ...``). Shared-memory accesses set J1's round, and one warp issues
    them far below an SM's rate, so each role has warps in proportion to
    its share; these counts came out best of a sweep of splits on the
    H100."""
    if d > J1_MAX_D:
        raise ValueError(f"eigh_jacobi's kernel takes d up to {J1_MAX_D}, "
                         f"got {d}")
    npairs = _npairs(d)
    n_pivot = _j1_pivots(d)
    n_v = min(J1_MAX_V_THREADS, J1_MAX_THREADS - n_pivot - 32,
              32 * max(1, round(npairs * d / 400)))
    n_pass = min(J1_MAX_PASS_THREADS, J1_MAX_THREADS - n_pivot - n_v,
                 -(-npairs * npairs // 64) * 32)
    groups = max(1, min(npairs, n_pass // npairs))
    if groups > 1:
        n_pass = -(-groups * npairs // 32) * 32
    return n_pivot + n_pass, n_v, groups


def _j1_plan(d: int) -> Tuple[int, int, int]:
    """``(ld, shared_bytes, threads)`` of J1 at dimension ``d``. ``ld`` is
    A's row stride in shared memory: odd (``d + 1`` for an even d) where
    it fits, ``d`` where the padding does not, and 0 where A and Vᵀ do
    not fit at all (they stay in device memory; only the ring is shared).
    The ring takes as many slots as fit, up to :data:`J1_MAX_SLOTS`;
    ``threads`` is :func:`_j1_split`'s."""
    n_a, n_v, _ = _j1_split(d)
    return _j1_layout(d)[:2] + (n_a + n_v,)


def _j1_layout(d: int) -> Tuple[int, int, int]:
    """``(ld, shared_bytes, slots)``, as :func:`_j1_plan` says."""
    for ld in ((d + 1, d) if d % 2 == 0 else (d,)):
        room = J1_MAX_SHARED - _shared_bytes(d, ld, 0)
        slots = min(J1_MAX_SLOTS, room // (12 * _npairs(d)))
        if slots >= 1:
            return ld, _shared_bytes(d, ld, slots), slots
    slots = min(J1_MAX_SLOTS, J1_MAX_SHARED // (12 * _npairs(d)))
    return 0, _shared_bytes(d, 0, slots), slots


#: the largest d whose A and V J1 keeps in shared memory (170)
J1_SHARED_MAX_D = max(d for d in range(2, 256) if _j1_plan(d)[0])
#: J1 splits a matrix over two SMs (A's rounds on one, V's on the other)
#: from this d up to :data:`J1_SHARED_MAX_D`, where both blocks of every
#: matrix fit on the card at once: ``port_profile.py --kernel-times``'
#: ``j1_split_min_d`` on an NVIDIA H100 80GB HBM3 at 700 W, the smallest
#: d from which the split beat one SM a matrix at batch 1 at every larger
#: d timed (within 1-3% up to d 64, 28% at d 100, 33% at d 170; at d 100
#: also with half the SMs' matrices, 66)
J1_SPLIT_MIN_D = 39
#: the rounds the V block of a split copies at a time (csrc's kLogBatch)
J1_LOG_BATCH = 8


def _j1_splits(d: int, nmat: int, sms: int) -> bool:
    """Whether J1 gives each of ``nmat`` matrices two blocks on two of the
    card's ``sms`` SMs, one for A's rounds and one for V's (a cooperative
    launch: each block takes more than half an SM's shared memory, so
    all ``2 nmat`` must fit on the SMs at once)."""
    return 2 * nmat <= sms and J1_SPLIT_MIN_D <= d <= J1_SHARED_MAX_D


def _j1_split_plan(d: int) -> Tuple[int, int, int, int]:
    """``(ld, shared_bytes, n_a, n_v)`` of a split J1: A's row stride,
    the dynamic shared bytes of each block (more than half an SM's, so the
    two blocks take two SMs), the A block's pivot and pass threads and the
    V block's threads (a (pair, row pair) unit each, up to 1024)."""
    ld = _j1_layout(d)[0]
    ldv, npairs = d + d % 2, _npairs(d)
    need = 4 * max(d * ldv, d * ld + 1) + 12 * npairs * J1_LOG_BATCH
    n_v = min(J1_MAX_THREADS, -(-npairs * (ldv // 2) // 32) * 32)
    return ld, max(need, J1_MAX_SHARED // 2 + 16), _j1_split(d)[0], n_v


def j1_sms(d: int, nmat: int, sms: int) -> int:
    """The SMs J1's launch on ``nmat`` matrices of dimension ``d`` can use
    on a card of ``sms`` SMs: two a matrix where it splits."""
    return min(2 * nmat if _j1_splits(d, nmat, sms) else nmat, sms)


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


def _check_square(C: torch.Tensor) -> int:
    if C.ndim < 2 or C.shape[-2] != C.shape[-1]:
        raise ValueError(f"eigh_jacobi needs a square matrix, got "
                         f"{tuple(C.shape)}")
    return int(C.shape[-1])


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root, as the kernel's ``__fsqrt_rn``:
    through float64, whose root rounds to float32 without a double
    rounding error. ``torch.sqrt`` on the CPU is vectorised and may be off
    by an ulp."""
    return torch.sqrt(x.double()).to(x.dtype)


def div_rn(x, c) -> torch.Tensor:
    """``x / c`` correctly rounded on every device, for a tensor and a
    number in either order: PyTorch's CUDA kernels multiply by a Python
    number's reciprocal, and ``number / tensor`` is ``reciprocal(tensor) ·
    number`` everywhere; a 0-d tensor operand takes the true division."""
    if isinstance(x, torch.Tensor):
        return x / torch.full((), c, dtype=x.dtype, device=x.device)
    return torch.full((), x, dtype=c.dtype, device=c.device) / c


def fma_rn(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a · b + c`` rounded once to float32, as the kernels' ``__fmaf_rn``
    and XLA's contracted CPU loops: the product is exact in float64 and
    the sum rounds there; where that sum lands exactly halfway between two
    float32 neighbours and was itself rounded (its TwoSum error is not 0),
    it steps one float64 ulp toward the exact value before the rounding to
    float32, so the double rounding cannot flip a tie. (A tie of a result
    in float32's subnormal range is not corrected: such sums need operands
    below 1e-19.)"""
    a, b, c = a.double(), b.double(), c.double()
    p = a * b
    s = p + c
    tie = (s.view(torch.int64) & ((1 << 29) - 1)) == (1 << 28)
    if not bool(tie.any()):  # one read-back; ties are rare
        return s.to(torch.float32)
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    step = torch.nextafter(s, torch.where(err > 0, torch.inf, -torch.inf))
    return torch.where(tie & (err != 0), step, s).to(torch.float32)


def norm_rn(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """``‖x‖`` over the last axis as XLA computes a short row's norm on
    the CPU: the squares added left to right, then :func:`sqrt_rn`."""
    sq = x * x
    acc = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        acc = acc + sq[..., c]
    acc = sqrt_rn(acc)
    return acc[..., None] if keepdim else acc


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
        t = torch.sign(tau) / (tau.abs() + sqrt_rn(1.0 + tau * tau))
        t = torch.where(tau == 0.0, 1.0, t)
        c = torch.reciprocal(sqrt_rn(1.0 + t * t))
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

    On the card J1 runs every round and orders the spectrum in one
    launch, one block a matrix; a CUDA tensor must be float32 and
    contiguous. A CPU tensor takes the plain version. ``launches``
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
    fn = _build.function("jacobi_eigh", "jacobi_eigh", J1_ARGTYPES)
    w, V, err = _j1_launch(fn, C, sweeps)
    eigh_jacobi.launches += 1
    _build.check("jacobi_eigh", err, "eigh_jacobi")
    return w, V


def _j1_launch(fn, C: torch.Tensor, sweeps: Optional[int]):
    """Launch J1's launcher ``fn`` (``csrc/jacobi_eigh.cu::jacobi_eigh``, or
    the same source built with other flags) on a checked float32 CUDA
    ``C [..., d, d]`` (d >= 2): ``(w, V, err)``, the spectrum ascending
    with V's columns in its order, and the launcher's CUDA error code."""
    d = C.shape[-1]
    sweeps = default_sweeps(d) if sweeps is None else int(sweeps)
    batch = C.shape[:-2]
    nmat = math.prod(batch)
    w = torch.empty(batch + (d,), dtype=torch.float32, device=C.device)
    V = torch.empty(batch + (d, d), dtype=torch.float32, device=C.device)
    if nmat == 0:
        return w, V, 0
    n_pivot = _j1_pivots(d)
    n_a, n_v, groups = _j1_split(d)
    split = _j1_splits(d, nmat, torch.cuda.get_device_properties(
        C.device).multi_processor_count)
    none = torch.empty(0, device=C.device)
    if split:
        ld, smem, n_a, n_v = _j1_split_plan(d)
        slots, work = 1, none
        npairs = _npairs(d)
        rounds = sweeps * (2 * npairs - 1)
        log = torch.empty(nmat * rounds * npairs * 3, dtype=torch.int32,
                          device=C.device)
        ready = torch.zeros(nmat, dtype=torch.int32, device=C.device)
        order = torch.empty(nmat * d, dtype=torch.int32, device=C.device)
    else:
        ld, smem, slots = _j1_layout(d)
        log = ready = order = none
        # Vᵀ and A live in device memory where they do not fit in shared
        # memory
        work = (none if ld else
                torch.empty(batch + (2, d, d + d % 2), dtype=torch.float32,
                            device=C.device))
    err = fn(C.data_ptr(), w.data_ptr(), V.data_ptr(), work.data_ptr(), nmat,
             d, sweeps, ld, smem, n_pivot, n_a, n_v, groups, slots,
             int(split), log.data_ptr(), ready.data_ptr(), order.data_ptr(),
             torch.cuda.current_stream(C.device).cuda_stream)
    return w, V, err


eigh_jacobi.launches = 0
