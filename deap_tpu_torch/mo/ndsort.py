"""Exact non-domination ranking without front peeling, for M >= 3.

Port of :mod:`deap_tpu.mo.ndsort`. Two facts carry both engines:

1. **Rank is the longest dominating chain.** A row's front index is
   ``1 + max(rank of its dominators)`` (0 with none), a longest-path DP
   over the dominance DAG with no peeling loop.
2. **Lexicographic order is topological.** Sorted lexicographically
   descending, every dominator of a row precedes it; exact duplicates
   share a rank.

- :func:`nd_rank_sweep3` (M = 3): one pass over the sorted rows. Each
  step asks "max rank among processed rows with ``w1 >= y`` and
  ``w2 >= z``", answered by a Fenwick tree over ``w1``-positions of
  inner Fenwick trees over ``w2``-positions. Every tree position depends
  only on the sort order, so all gather and scatter chains are computed
  up front into two index tables and a step is gather → max →
  scatter-max on one flat state vector.
- :func:`nd_rank_prefix` (any M): rows in lex order, in blocks; a block's
  base ranks are one dominance max-reduction against the ranked prefix
  (the cross step: K8, :func:`deap_tpu_torch.ops.kernels
  .dominated_weight_maxes`, on the card), then an in-block pass finishes
  the chain DP. O(n²·m) work, as one peel, whatever the front count.

Both steps are sequential. The JAX package runs them as ``lax.scan`` /
``fori_loop``; here :func:`nd_rank_sweep3`'s pass is one launch of J4
on the card (:func:`sweep3_rows`; its plain version a Python loop with a
few tensor ops per row), and the in-block pass of :func:`nd_rank_prefix`
relaxes the whole block at once until nothing changes (as many rounds
as the longest chain inside the block, plus one), which reaches the same
fixpoint as the row-by-row pass. Ranks are bit-identical to the
dominance-matrix peel and follow :func:`deap_tpu_torch.mo.emo.nd_rank`'s
``max_rank`` sentinel contract.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deap_tpu_torch import _build, tuning
from deap_tpu_torch.core.fitness import dominates, lex_sort_desc, lexsort
from deap_tpu_torch.ops.kernels import dominated_weight_maxes

__all__ = ["nd_rank_sweep3", "sweep3_inputs", "sweep3_rows",
           "sweep3_rows_plain", "nd_rank_prefix"]


def _finish(sorted_ranks: torch.Tensor, order: torch.Tensor, n: int,
            max_rank: Optional[int], return_peels: bool):
    """Ranks in the original row order, the ``max_rank`` sentinel, and the
    front count clamped to the budget."""
    stop = n if max_rank is None else min(max_rank, n)
    ranks = torch.zeros(n, dtype=torch.int32, device=order.device)
    ranks[order] = sorted_ranks
    if max_rank is not None:
        ranks = torch.where(ranks < stop, ranks, n)
    if not return_peels:
        return ranks
    peels = min(int(sorted_ranks.max()) + 1, stop) if n else 0
    return ranks, peels


def _empty(w: torch.Tensor, return_peels: bool):
    ranks = torch.zeros(0, dtype=torch.int32, device=w.device)
    return (ranks, 0) if return_peels else ranks


def _fenwick_offsets(n: int, device):
    """Flat-pool layout of a Fenwick-of-Fenwicks over ``n`` positions:
    outer node ``t`` owns ``lsb(t)`` slots from ``off[t]``; ``off[n+1]``
    is the pool size ``F``."""
    t = np.arange(1, n + 1, dtype=np.int64)
    csum = np.cumsum(t & -t)
    off = np.zeros(n + 2, np.int64)
    if n > 1:
        off[2:n + 1] = csum[:n - 1]
    off[n + 1] = csum[n - 1]
    return torch.from_numpy(off).to(device), int(csum[-1])


def _sorted_groups(w: torch.Tensor):
    """Lex-desc order, sorted rows, and the mask of duplicate-group
    heads (identical rows are adjacent after the sort)."""
    order = lex_sort_desc(w)
    ws = w[order]
    head = torch.ones(w.shape[0], dtype=torch.bool, device=w.device)
    if w.shape[0] > 1:
        head[1:] = ~(ws[1:] == ws[:-1]).all(1)
    return order, ws, head


def _lowbit(t: torch.Tensor) -> torch.Tensor:
    return t & -t


def _count_at_most(run: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``searchsorted(run, q, side='right')`` with NaN as the largest
    value, as the JAX package sorts and searches: ``run`` ascending with
    its NaNs at the end (as a stable sort leaves them), a number query
    counts only the numbers of the run, a NaN query counts every entry.
    ``torch.searchsorted`` alone steps past the run's NaNs for a number
    query."""
    nan = torch.isnan(run)
    count = torch.searchsorted(torch.where(nan, torch.inf, run), q,
                               right=True)
    count = torch.minimum(count, (~nan).sum())
    return torch.where(torch.isnan(q), run.shape[0], count)


def nd_rank_sweep3(w: torch.Tensor, max_rank: Optional[int] = None,
                   return_peels: bool = False):
    """Exact 3-objective non-domination ranks in O(n log² n) work, with a
    sequential pass of n steps (see the module docstring): the tables of
    :func:`sweep3_inputs`, then :func:`sweep3_rows` (J4 on the card, one
    launch)."""
    n, nobj = w.shape
    if nobj != 3:
        raise ValueError(f"nd_rank_sweep3 needs nobj == 3, got {nobj}")
    if n == 0:
        return _empty(w, return_peels)
    order, Q, U, head, F = sweep3_inputs(w)
    return _finish(sweep3_rows(Q, U, head, F), order, n, max_rank,
                   return_peels)


nd_rank_sweep3.launches = 0


def sweep3_inputs(w: torch.Tensor):
    """The sweep's tables for ``w`` (``[n, 3]``, n >= 1): the lex-descending
    order, the gather and scatter tables ``Q``, ``U`` (``int32[n, A*A]``
    as in the JAX package, A the bit length of n), the group heads and
    the pool size ``F`` (the state has ``F + 2`` slots: ``F`` the scatter
    dump, ``F + 1`` the gather dump, never written)."""
    n = w.shape[0]
    dev = w.device
    i64 = dict(dtype=torch.int64, device=dev)
    A = int(n).bit_length()          # max Fenwick chain length
    order, ws, head = _sorted_groups(w)
    y = ws[:, 1].to(torch.float32)
    z = ws[:, 2].to(torch.float32)

    # unique descending slots per trailing objective, and inclusive-count
    # query bounds from the values (ties counted in)
    ysort = torch.sort(-y, stable=True).indices
    posy = torch.zeros(n, **i64)
    posy[ysort] = torch.arange(1, n + 1, **i64)
    cge_y = _count_at_most(-y[ysort], -y)
    zsort = torch.sort(-z, stable=True).indices
    rz = torch.zeros(n, **i64)
    rz[zsort] = torch.arange(n, **i64)
    cge_z = _count_at_most(-z[zsort], -z)

    off, F = _fenwick_offsets(n, dev)
    if F + 2 > 2**31 - 1:
        raise ValueError(f"the sweep's int32 slots hold fewer rows than {n}")
    UD, QD = F, F + 1     # scatter dump / gather dump (never written)

    # node membership: each point sits in the <= A outer nodes of its
    # update chain; one (node, rz)-sorted pool gives every node its
    # members as an rz-sorted segment
    node_cols = []
    t = posy
    for _ in range(A):
        valid = t <= n
        node_cols.append(torch.where(valid, t, n + 1))
        t = torch.where(valid, t + _lowbit(t), t)
    node_tab = torch.stack(node_cols, 1)                   # [n, A]
    node_flat = node_tab.reshape(-1)
    rz_flat = rz[:, None].expand(n, A).reshape(-1)
    perm = lexsort([rz_flat, node_flat])
    rz_sorted = rz_flat[perm]
    inner0_sorted = torch.arange(node_flat.shape[0], **i64) \
        - off[node_flat[perm]]
    q_tab = torch.zeros_like(node_flat)
    q_tab[perm] = inner0_sorted
    q_tab = q_tab.reshape(n, A)     # 0-based position inside its node

    # update table: flat slots of every (outer node, inner chain) step of
    # each point's insertion, padded with the dump slot
    u_cols = []
    for a in range(A):
        node = node_tab[:, a]
        valid = node <= n
        m_t = _lowbit(node)
        base = off[node]
        x = q_tab[:, a] + 1
        for _ in range(A):
            ok = valid & (x <= m_t)
            u_cols.append(torch.where(ok, base + x - 1, UD).to(torch.int32))
            x = x + _lowbit(x)
    U = torch.stack(u_cols, 1)                             # [n, A*A]

    # query table: prefix decomposition of cge_y into <= A outer nodes;
    # per node a bisection counts the members within the z bound, and
    # that count's inner query chain is emitted
    q_cols = []
    t = cge_y
    last = rz_sorted.shape[0] - 1
    for _ in range(A):
        validq = t > 0
        node = torch.where(validq, t, n + 1)
        m_t = torch.where(validq, _lowbit(node), 0)
        base = off[node]
        lo, hi = base, base + m_t
        for _ in range(A + 1):
            mid = (lo + hi) // 2
            v = rz_sorted[mid.clamp(0, last)]
            active = lo < hi
            go_right = active & (v < cge_z)
            lo, hi = (torch.where(go_right, mid + 1, lo),
                      torch.where(active & ~go_right, mid, hi))
        x = lo - base
        for _ in range(A):
            okq = validq & (x > 0)
            q_cols.append(torch.where(okq, base + x - 1, QD).to(torch.int32))
            x = x - _lowbit(x)
        t = torch.where(validq, t - _lowbit(t), t)
    Q = torch.stack(q_cols, 1)                             # [n, A*A]

    return order, Q, U, head, F


def sweep3_rows_plain(Q: torch.Tensor, U: torch.Tensor, head: torch.Tensor,
                      F: int) -> torch.Tensor:
    """Plain version of J4: the sweep over the sorted rows, a Python loop
    of a gather, a max and a scatter-max per row (it reads ``head`` to the
    host). The state holds rank + 1 per inserted slot, so a query's max is
    the new rank (0 = undominated); float32 is exact for ranks below
    2^24. Within a row of ``U`` only the dump slot ``F`` repeats, and
    every write to it stores the same value. Returns the sorted ranks,
    ``int32[n]``."""
    n = Q.shape[0]
    state = torch.zeros(F + 2, dtype=torch.float32, device=Q.device)
    ranks_f = torch.empty(n, dtype=torch.float32, device=Q.device)
    r = None
    for i, is_head in enumerate(head.tolist()):
        if is_head:
            r = state[Q[i]].max()
        ranks_f[i] = r
        u = U[i]
        state[u] = torch.maximum(state[u], r + 1.0)
    return ranks_f.to(torch.int32)


def sweep3_rows(Q: torch.Tensor, U: torch.Tensor, head: torch.Tensor,
                F: int) -> torch.Tensor:
    """The sweep's row pass (J4): sorted ranks ``int32[n]`` from the
    gather and scatter tables ``Q``, ``U`` (``int32[n, A*A]`` slots of a
    state of ``F + 2`` floats) and the group heads ``head`` (bool).

    On the card one launch of ``csrc/nd_scan.cu::sweep_kernel`` walks
    the rows in chunks of up to 32 in one block (each chunk's gathers
    against the state as the chunk found it, then a chain over the
    chunk's own writes), the state and each slot's owner mask in device
    memory; each launch adds one to ``nd_rank_sweep3.launches``. On a CPU
    tensor :func:`sweep3_rows_plain` runs. Both give the same ranks."""
    if Q.device.type == "cpu":
        return sweep3_rows_plain(Q, U, head, F)
    if Q.device.type != "cuda":
        raise ValueError(f"no kernel for device {Q.device}")
    n = Q.shape[0]
    if Q.dtype != torch.int32 or U.dtype != torch.int32 or \
            head.dtype != torch.bool:
        raise ValueError("J4 takes int32 tables and a bool head")
    if Q.dim() != 2 or U.shape != Q.shape or head.shape != (n,) or \
            U.device != Q.device or head.device != Q.device:
        raise ValueError("Q and U must be [n, A*A] and head [n], on one "
                         "card")
    cols = Q.shape[1]
    if not 1 <= cols <= 1024:
        raise ValueError(f"J4 takes 1-1024 table columns, got {cols}")
    ranks = torch.empty(n, dtype=torch.int32, device=Q.device)
    if n == 0:
        return ranks
    # per slot of the pool: rank + 1 of the rows inserted there, and the
    # owner mask of the chunk's rows that write there (the two pads'
    # slots too, which the kernel skips)
    slots = torch.zeros((F + 2, 2), dtype=torch.int32, device=Q.device)
    Q, U, head = Q.contiguous(), U.contiguous(), head.contiguous()
    # the kernel stages whole chunks 16 bytes a copy
    Q, U = (t.clone() if t.data_ptr() % 16 else t for t in (Q, U))
    stream = torch.cuda.current_stream(Q.device).cuda_stream
    PT, I = _build.PTR, _build.INT
    fn = _build.function("nd_scan", "sweep3_rows",
                         [PT, PT, PT, I, I, I, PT, PT, PT])
    err = fn(Q.data_ptr(), U.data_ptr(), head.data_ptr(), n, cols, F,
             slots.data_ptr(), ranks.data_ptr(), stream)
    nd_rank_sweep3.launches += 1
    _build.check("nd_scan", err, "sweep3_rows")
    return ranks


def _chain_in_block(blk: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The in-block chain DP ``rb[i] = max(base[i], max_{j < i, j
    dominates i} rb[j] + 1)``, relaxed over the whole block until it stops
    changing: the fixpoint of a DAG's longest-path recurrence is unique,
    so this equals the row-by-row pass."""
    nb = blk.shape[0]
    idx = torch.arange(nb, device=blk.device)
    dom = dominates(blk[None, :, :], blk[:, None, :]) & (
        idx[None, :] < idx[:, None])                       # [i, j]
    rb = base
    while True:
        nxt = torch.maximum(
            base, torch.where(dom, rb[None, :] + 1.0, 0.0).amax(1))
        if torch.equal(nxt, rb):
            return rb
        rb = nxt


def nd_rank_prefix(w: torch.Tensor, max_rank: Optional[int] = None,
                   return_peels: bool = False, *, block: int = 512,
                   cross: str = "auto"):
    """Exact any-M non-domination ranks in one front-count-free pass.

    Rows sorted lexicographically descending are consumed in blocks of
    ``block``; a block's base ranks are the dominance max-reduction
    against the already-ranked prefix (``weights = rank + 1``) through K8
    (:func:`deap_tpu_torch.ops.kernels.dominated_weight_maxes`, its plain
    version for CPU tensors), and the in-block pass closes the
    longest-chain DP. Rows at or after the block's start carry weight 0
    in the JAX package's cross step and are left out here, which gives
    the same maxima.

    ``cross``: ``'kernel'`` (K8, the card) or ``'plain'`` (its plain
    version, the CPU). There is one engine a device, so ``'auto'`` is the
    device's engine and the dispatch tuner is not asked; the JAX
    package's ``DEAP_TPU_TUNE_ND_CROSS`` escape hatch survives as
    ``DEAP_TPU_TORCH_TUNE_ND_CROSS``, which may only name that engine.
    Any other value raises ``ValueError``.
    """
    static = "kernel" if w.device.type == "cuda" else "plain"
    if cross == "auto":
        cross = tuning.env_override("nd_cross") or static
    if cross != static:
        raise ValueError(f"nd_rank_prefix cross {cross!r}: on {w.device} "
                         f"the cross step is {static!r}")
    n, _ = w.shape
    if n == 0:
        return _empty(w, return_peels)
    order = lex_sort_desc(w)
    ws = w[order].to(torch.float32)
    block = max(1, min(block, n))
    R = torch.zeros(n, dtype=torch.float32, device=w.device)
    for start in range(0, n, block):
        blk = ws[start:start + block]
        if start == 0:
            base = torch.zeros(blk.shape[0], dtype=torch.float32,
                               device=w.device)
        else:
            base = dominated_weight_maxes(ws[:start], R[:start] + 1.0, blk)
        R[start:start + block] = _chain_in_block(blk, base)
    return _finish(R.to(torch.int32), order, n, max_rank, return_peels)
