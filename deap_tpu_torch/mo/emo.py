"""Multi-objective selection: NSGA-II, SPEA2 at scale, non-dominated
sorting and crowding.

Port of the NSGA-II and streaming-SPEA2 part of :mod:`deap_tpu.mo.emo`.
Every selector takes weighted values ``w: f32[n, nobj]`` (maximisation)
and returns ``int64[k]`` indices; randomness comes from a
``torch.Generator``, and each random selector has a draw-taking core
(``_dcd_winners``, ``_spea2_stream_pick``) that the tests feed with the
JAX package's draws.

Non-dominated sorting is one contract over five engines (:func:`nd_rank`):
the dominance-matrix peel, its streaming twin through K7
(:func:`deap_tpu_torch.ops.kernels.nd_rank_tiled`), and the exact
peeling-free engines ``staircase`` (M = 2), ``sweep`` (M = 3) and ``dc``
(any M, its cross step through K8). ``impl='auto'`` picks by (n, M, the
tensor's device) with the JAX package's static rule, ``'cuda'`` in the
place that rule gives the TPU.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deap_tpu_torch.core.fitness import dominates, lex_sort_desc, lexsort
from deap_tpu_torch.mo.ndsort import _finish, nd_rank_prefix, nd_rank_sweep3
from deap_tpu_torch.ops.kernels import (
    dominated_weight_sums,
    nd_rank_tiled,
    peel_fronts,
    strengths_tiled,
)

__all__ = [
    "dominance_matrix", "nd_rank", "nd_rank_staircase", "sort_nondominated",
    "crowding_distances", "sel_nsga2", "sel_tournament_dcd", "dcd_draws",
    "spea2_fitness_stream", "sel_spea2_stream", "uniform_reference_points",
    "ND_TILED_THRESHOLD", "ND_PREFIX_THRESHOLD", "ND_SWEEP_THRESHOLD",
]


# ---------------------------------------------------------------- nd-sort ----

def dominance_matrix(w: torch.Tensor) -> torch.Tensor:
    """``dom[i, j]`` is True iff row ``j`` dominates row ``i``."""
    return dominates(w[None, :, :], w[:, None, :])


#: population size from which ``auto`` streams the dominance test through
#: K7 on the card instead of holding the ``[n, n]`` matrix, and the
#: 2-objective staircase everywhere
ND_TILED_THRESHOLD = 8192
#: CPU crossover above which the M >= 3 prefix chain reduction beats
#: matrix peeling (the JAX package's measurement)
ND_PREFIX_THRESHOLD = 512
#: CPU crossover above which the M = 3 Fenwick sweep beats the prefix
#: reduction (the JAX package's measurement)
ND_SWEEP_THRESHOLD = 16384

#: engines with exact full ranks and no peel loop
_ND_EXACT_IMPLS = ("staircase", "sweep", "dc")
_ND_IMPLS = ("matrix", "tiled") + _ND_EXACT_IMPLS


def _nd_static_auto(n: int, nobj: int, device_type: str) -> str:
    """The JAX package's static rule, thresholds unchanged, with
    ``'cuda'`` where it has ``'tpu'`` (the streaming kernel is real
    there). On the CPU it picks what the JAX package picks on its CPU."""
    if nobj == 2 and (n >= ND_TILED_THRESHOLD
                      or (device_type == "cpu" and n >= 64)):
        return "staircase"
    if nobj == 3 and device_type == "cpu" and n >= ND_SWEEP_THRESHOLD:
        return "sweep"
    if nobj >= 3 and device_type == "cpu" and n >= ND_PREFIX_THRESHOLD:
        return "dc"
    return ("tiled" if device_type == "cuda" and n >= ND_TILED_THRESHOLD
            else "matrix")


def nd_rank(w: torch.Tensor, max_rank: Optional[int] = None,
            impl: str = "auto", cover_k: Optional[int] = None,
            fallback: str = "none", return_peels: bool = False):
    """Non-domination rank per row (0 = first front); equal rows share a
    rank.

    ``impl``: ``'matrix'`` peels fronts off the ``[n, n]`` dominance
    matrix; ``'tiled'`` peels with K7 and no matrix
    (:func:`deap_tpu_torch.ops.kernels.nd_rank_tiled`); ``'staircase'``
    (M = 2), ``'sweep'`` (M = 3) and ``'dc'`` (any M) are exact
    peeling-free engines; ``'auto'`` picks by n, M and ``w``'s device.

    ``max_rank`` stops after that many fronts (unpeeled rows keep rank
    ``n``); ``cover_k`` stops peeling once ``cover_k`` rows are ranked
    (exact for a top-k cut); ``fallback='count'`` ranks the rows left at
    a ``max_rank`` stop by ``max_rank + #dominators among them``, and for
    the exact engines returns their exact ranks. ``return_peels`` also
    returns the fronts peeled, as an int.
    """
    n = w.shape[0]
    if fallback not in ("none", "count"):
        raise ValueError(f"unknown nd_rank fallback {fallback!r}")
    if impl == "auto":
        impl = _nd_static_auto(n, int(w.shape[1]), w.device.type)
    if impl in _ND_EXACT_IMPLS:
        fn = {"staircase": nd_rank_staircase, "sweep": nd_rank_sweep3,
              "dc": nd_rank_prefix}[impl]
        res = fn(w, None if fallback == "count" else max_rank,
                 return_peels=return_peels)
        if return_peels and fallback == "count" and max_rank is not None:
            ranks, peels = res
            res = (ranks, min(peels, max_rank, n))
        return res
    if impl == "tiled":
        return nd_rank_tiled(w, max_rank, cover_k=cover_k,
                             fallback=fallback, return_peels=return_peels)
    if impl != "matrix":
        raise ValueError(f"unknown nd_rank impl {impl!r}")
    dom = dominance_matrix(w)  # [n, n]: j dominates i
    ranks, peels = peel_fronts(
        lambda rem: (dom & rem[None, :]).sum(1, dtype=torch.int32), n,
        w.device, max_rank, cover_k, fallback)
    return (ranks, peels) if return_peels else ranks


def nd_rank_staircase(w: torch.Tensor, max_rank: Optional[int] = None,
                      return_peels: bool = False):
    """Exact 2-objective non-domination ranks in O(n log n) work.

    Rows in lexicographic descending ``(w0, w1)`` order; one scalar per
    front, its largest ``w1`` so far, kept negated (ascending). A row's
    rank is the count of fronts whose maximum covers it, one binary
    search; identical rows share their group head's rank. The pass over
    the rows is a Python loop of a few tensor ops per row.
    """
    n, nobj = w.shape
    if nobj != 2:
        raise ValueError(f"nd_rank_staircase needs nobj == 2, got {nobj}")
    if n == 0:
        ranks = torch.zeros(0, dtype=torch.int32, device=w.device)
        return (ranks, 0) if return_peels else ranks
    order = lex_sort_desc(w)
    f2 = w[order, 1]
    neg_f2 = -f2
    head = torch.ones(n, dtype=torch.bool, device=w.device)
    head[1:] = ~((w[order[1:], 0] == w[order[:-1], 0]) & (f2[1:] == f2[:-1]))
    # slot n is a dump: a row of -inf counts every slot (rank n, as in
    # the JAX package) and its write is dropped there
    neg_m = torch.full((n + 1,), torch.inf, dtype=w.dtype, device=w.device)
    sorted_ranks = torch.empty(n, dtype=torch.int64, device=w.device)
    r = None
    for i, is_head in enumerate(head.tolist()):
        if is_head:
            # fronts with max-w1 >= f2[i], i.e. neg_m <= -f2[i]: right
            # side counts the equal case (an earlier distinct row with
            # equal w1 has a larger w0: a dominator)
            x = neg_f2[i:i + 1]
            r = torch.searchsorted(neg_m[:n], x, right=True)
            neg_m[r] = x
        sorted_ranks[i:i + 1] = r
    return _finish(sorted_ranks.to(torch.int32), order, n, max_rank,
                   return_peels)


def sort_nondominated(w: torch.Tensor, k: int,
                      first_front_only: bool = False):
    """Ranks and the order that sorts rows by front; ``(ranks, order)``.
    With ``first_front_only`` the order holds the first front's rows,
    padded with -1 to ``n``."""
    ranks = nd_rank(w)
    n = w.shape[0]
    if first_front_only:
        first = torch.nonzero(ranks == 0)[:, 0]
        pad = torch.full((n - first.shape[0],), -1, dtype=first.dtype,
                         device=w.device)
        return ranks, torch.cat([first, pad])
    return ranks, torch.sort(ranks, stable=True).indices[:k]


# --------------------------------------------------------------- crowding ----

def _segment(values: torch.Tensor, seg: torch.Tensor, n_seg: int,
             reduce: str) -> torch.Tensor:
    out = torch.zeros(n_seg, dtype=values.dtype, device=values.device)
    return out.scatter_reduce(0, seg, values, reduce, include_self=False)


def crowding_distances(w: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Crowding distance within each front, all fronts at once: per
    objective, rows sorted by (rank, value); a front's boundary rows get
    +inf, interior rows add ``(next - prev) / (nobj · (front max - front
    min))``. Invariant to the sign of the weights."""
    n, nobj = w.shape
    dev = w.device
    ranks = ranks.to(torch.int64)
    dist = torch.zeros(n, dtype=torch.float32, device=dev)
    ones = torch.ones(1, dtype=torch.bool, device=dev)
    for i in range(nobj):
        order = lexsort([w[:, i], ranks])
        v = w[order, i]
        r = ranks[order]
        step = r[1:] != r[:-1]
        first = torch.cat([ones, step])
        last = torch.cat([step, ones])
        fmin = _segment(v, r, n + 1, "amin")[r]
        fmax = _segment(v, r, n + 1, "amax")[r]
        norm = nobj * (fmax - fmin)
        prev = torch.cat([v[:1], v[:-1]])
        nxt = torch.cat([v[1:], v[-1:]])
        interior = torch.where(
            norm > 0, (nxt - prev) / torch.where(norm > 0, norm, 1.0), 0.0)
        contrib = torch.where(first | last, torch.inf, interior)
        dist[order] = dist[order] + contrib
    return dist


# ---------------------------------------------------------------- NSGA-II ----

def _impl_of(nd: str) -> str:
    if nd in _ND_IMPLS:
        return nd
    if nd in ("standard", "log", "auto"):
        return "auto"
    raise ValueError(f"unknown nd sort {nd!r}")


def sel_nsga2(generator, w: torch.Tensor, k: int, nd: str = "standard",
              peel_budget: Optional[int] = None) -> torch.Tensor:
    """NSGA-II selection: whole fronts in rank order, the last partial
    front by descending crowding distance.

    ``nd``: ``'standard'``/``'log'``/``'auto'`` use ``nd_rank``'s auto
    dispatch; ``'matrix'``, ``'tiled'``, ``'staircase'``, ``'sweep'``,
    ``'dc'`` force an engine. Peeling stops once ``k`` rows are ranked
    (exact). ``peel_budget`` caps the fronts peeled and ranks the rest by
    dominance counts (``nd_rank``'s ``fallback='count'``). ``generator``
    is not used: the selection is deterministic.
    """
    del generator
    impl = _impl_of(nd)
    ranks = nd_rank(w, impl=impl, cover_k=k, max_rank=peel_budget,
                    fallback="none" if peel_budget is None else "count")
    crowd = crowding_distances(w, torch.clamp(ranks, max=w.shape[0]))
    return lexsort([-crowd, ranks])[:k]


def dcd_draws(generator: torch.Generator, n: int, k: int):
    """The draws of :func:`sel_tournament_dcd`: two permutations of
    ``range(n)`` and ``k`` fair coins."""
    dev = generator.device
    p1 = torch.randperm(n, generator=generator, device=dev)
    p2 = torch.randperm(n, generator=generator, device=dev)
    coin = torch.rand(k, generator=generator, device=dev) < 0.5
    return p1, p2, coin


def _dcd_winners(w: torch.Tensor, k: int, p1: torch.Tensor, p2: torch.Tensor,
                 coin: torch.Tensor,
                 peel_budget: Optional[int] = None) -> torch.Tensor:
    """The dominance/crowding tournaments on given draws: pairs from the
    two permutations in the reference's 4-block pattern; dominance
    decides, then crowding, then the coin."""
    n = w.shape[0]
    ranks = nd_rank(w, max_rank=peel_budget)
    crowd = crowding_distances(w, ranks)
    p1, p2 = p1.to(torch.int64), p2.to(torch.int64)
    reps = k // max(1, 2 * (n // 2)) + 1  # enough pairs even for k > n/2
    A = torch.stack([p1[0::2], p2[0::2]], 1).reshape(-1).repeat(reps)[:k]
    B = torch.stack([p1[1::2], p2[1::2]], 1).reshape(-1).repeat(reps)[:k]
    wa, wb = w[A], w[B]
    d_ab = dominates(wa, wb)
    d_ba = dominates(wb, wa)
    ca, cb = crowd[A], crowd[B]
    pick_a = d_ab | (~d_ba & ((ca > cb) | ((ca == cb) & coin)))
    return torch.where(pick_a, A, B)


def sel_tournament_dcd(generator: torch.Generator, w: torch.Tensor, k: int,
                       peel_budget: Optional[int] = None) -> torch.Tensor:
    """Dominance/crowding binary tournament: two random permutations
    supply the pairs; dominance decides, then crowding distance, then a
    coin. Returns exactly ``k`` winners. ``peel_budget`` caps the sort;
    rows past it share one crowding segment."""
    p1, p2, coin = dcd_draws(generator, w.shape[0], k)
    return _dcd_winners(w, k, p1, p2, coin, peel_budget)


# -------------------------------------------------------- reference points ----

def uniform_reference_points(nobj: int, p: int = 4,
                             scaling=None) -> torch.Tensor:
    """Das-Dennis reference points on the unit simplex (host side)."""
    def gen(ref, left, depth):
        if depth == nobj - 1:
            ref[depth] = left / p
            return [ref.copy()]
        pts = []
        for i in range(left + 1):
            ref[depth] = i / p
            pts.extend(gen(ref, left - i, depth + 1))
        return pts

    pts = np.array(gen(np.zeros(nobj), p, 0))
    if scaling is not None:
        pts = pts * scaling + (1.0 - scaling) / nobj
    return torch.from_numpy(pts.astype(np.float32))


# ------------------------------------------------------------------ SPEA2 ----

def _knn_density(d2: torch.Tensor, kth: int) -> torch.Tensor:
    """SPEA2 density ``1/(σ_k + 2)`` from a square pairwise-distance
    matrix; the diagonal is excluded and ``kth`` clamped below the last
    sorted column (which holds the excluded self-distance)."""
    c = d2.shape[0]
    eye = torch.eye(c, dtype=torch.bool, device=d2.device)
    d2 = torch.where(eye, torch.inf, d2)
    col = min(max(kth, 0), max(c - 2, 0))
    sigma_k = torch.sort(d2, dim=1).values[:, col]
    return 1.0 / (sigma_k + 2.0)


def spea2_fitness_stream(w: torch.Tensor):
    """SPEA2 strength and raw fitness without the ``[n, n]`` matrices,
    through K7: ``S(i)`` counts the rows ``i`` dominates
    (:func:`deap_tpu_torch.ops.kernels.strengths_tiled`), ``R(i)`` sums
    the strengths of ``i``'s dominators. Returns ``(strength, raw)``,
    both ``f32[n]``; ``raw < 1`` marks the non-dominated set. Exact while
    raw stays below 2²⁴ (O(n²) in the worst case)."""
    strength = strengths_tiled(w)
    raw = dominated_weight_sums(w, strength)
    return strength, raw


def _knn_kth(n: int) -> int:
    """``floor(sqrt(n))`` in float32, as the JAX package computes it."""
    return int(torch.tensor(float(n), dtype=torch.float32).sqrt().floor())


def _pairwise_d2(wc: torch.Tensor) -> torch.Tensor:
    """Squared distances, objectives added left to right."""
    d2 = None
    for c in range(wc.shape[1]):
        diff = wc[:, None, c] - wc[None, :, c]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    return d2


def _spea2_stream_pick(w: torch.Tensor, k: int, u: torch.Tensor,
                       candidates: Optional[int] = None) -> torch.Tensor:
    """:func:`sel_spea2_stream` on given tie-break uniforms ``u``."""
    n = w.shape[0]
    c = min(n, max(2 * k, 4096)) if candidates is None else min(candidates, n)
    c = max(c, min(k, n))  # never fewer than the k requested
    _, raw = spea2_fitness_stream(w)
    cand_idx = lexsort([u, raw])[:c]
    density = _knn_density(_pairwise_d2(w[cand_idx]), _knn_kth(n))
    score = raw[cand_idx] + density
    return cand_idx[torch.sort(score, stable=True).indices[:k]]


def sel_spea2_stream(generator: torch.Generator, w: torch.Tensor, k: int,
                     candidates: Optional[int] = None) -> torch.Tensor:
    """SPEA2 selection for populations past the dense formulation's
    memory: exact strength and raw fitness through K7, then the
    ``candidates`` best rows by raw fitness (default ``max(2k, 4096)``,
    random tie-break) ranked by ``raw + density`` with the k-NN density
    among candidates only; the top ``k``. Like the JAX package's, this
    departs from dense SPEA2: an over-full archive is cut by one
    distance ranking instead of the iterative removal."""
    u = torch.rand(w.shape[0], generator=generator, device=generator.device)
    return _spea2_stream_pick(w, k, u, candidates)


# DEAP-style aliases
selNSGA2 = sel_nsga2
selTournamentDCD = sel_tournament_dcd
sortNondominated = sort_nondominated
sortLogNondominated = sort_nondominated
