"""Multi-objective selection: NSGA-II, NSGA-III, SPEA2 (dense and at
scale), non-dominated sorting and crowding.

Port of :mod:`deap_tpu.mo.emo`. Every selector takes weighted values
``w: f32[n, nobj]`` (maximisation) and returns ``int64[k]`` indices;
randomness comes from a ``torch.Generator``, and each random selector
has a draw-taking core (``_dcd_winners``, ``_spea2_stream_pick``,
:func:`nsga3_select`) that the tests feed with the JAX package's draws.

Non-dominated sorting is one contract over five engines (:func:`nd_rank`):
the dominance-matrix peel, its streaming twin through K7
(:func:`deap_tpu_torch.ops.kernels.nd_rank_tiled`), and the exact
peeling-free engines ``staircase`` (M = 2), ``sweep`` (M = 3) and ``dc``
(any M, its cross step through K8). ``impl='auto'`` picks by (n, M, the
tensor's device) with the JAX package's static rule, ``'cuda'`` in the
place that rule gives the TPU, or — with the dispatch tuner on — races
the engines on the actual rows (:func:`_resolve_nd_impl`).
"""

from __future__ import annotations

import bisect
from typing import NamedTuple, Optional

import numpy as np
import torch

from deap_tpu_torch import _build, tuning
from deap_tpu_torch.core.fitness import dominates, lex_sort_desc, lexsort
from deap_tpu_torch.mo.ndsort import _finish, nd_rank_prefix, nd_rank_sweep3
from deap_tpu_torch.ops.linalg import norm_rn
from deap_tpu_torch.ops.kernels import (
    dominated_weight_sums,
    nd_rank_tiled,
    peel_fronts,
    strengths_tiled,
)
from deap_tpu_torch.telemetry import costs

__all__ = [
    "dominance_matrix", "nd_rank", "nd_rank_staircase", "staircase_rows",
    "staircase_rows_plain", "staircase_inputs", "sort_nondominated",
    "crowding_distances", "sel_nsga2", "sel_tournament_dcd", "dcd_draws",
    "NSGA3Memory", "NSGA3Plan", "nsga3_plan", "nsga3_draws",
    "nsga3_select", "nsga3_select_scaled", "sel_nsga3",
    "SelNSGA3WithMemory", "sel_spea2",
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
    """The JAX package's static rule, thresholds unchanged (each
    overridable through ``DEAP_TPU_TORCH_TUNE_ND_{PREFIX,SWEEP,TILED}_
    THRESHOLD``), with ``'cuda'`` where it has ``'tpu'`` (the streaming
    kernel is real there). On the CPU it picks what the JAX package picks
    on its CPU."""
    prefix_thr = tuning.int_env("ND_PREFIX_THRESHOLD", ND_PREFIX_THRESHOLD)
    sweep_thr = tuning.int_env("ND_SWEEP_THRESHOLD", ND_SWEEP_THRESHOLD)
    tiled_thr = tuning.int_env("ND_TILED_THRESHOLD", ND_TILED_THRESHOLD)
    if nobj == 2 and (n >= tiled_thr
                      or (device_type == "cpu" and n >= 64)):
        return "staircase"
    if nobj == 3 and device_type == "cpu" and n >= sweep_thr:
        return "sweep"
    if nobj >= 3 and device_type == "cpu" and n >= prefix_thr:
        return "dc"
    return ("tiled" if device_type == "cuda" and n >= tiled_thr
            else "matrix")


def _nd_candidates(n: int, nobj: int, device_type: str):
    """The engines worth racing at this shape: the exact engines for this
    M, and on the card the one peel the static rule takes there — the
    ``[n, n]`` matrix below the tiled threshold, K7's streaming peel from
    it (so no ``'auto'`` leaves K7 for its plain version) — and on the CPU
    the matrix baseline. All return bit-identical full ranks."""
    names = []
    if device_type == "cuda":
        names.append("tiled" if n >= tuning.int_env(
            "ND_TILED_THRESHOLD", ND_TILED_THRESHOLD) else "matrix")
    else:
        names.append("matrix")
    if nobj == 2:
        names.append("staircase")
    if nobj == 3:
        names.append("sweep")
    if nobj >= 3:
        names.append("dc")
    return names


def _resolve_nd_impl(w: torch.Tensor, plan=None) -> str:
    """``impl='auto'`` through the dispatch tuner's env / cache / probe /
    static ladder. Probes race full exact ranks on the actual ``w``
    (bit-identity asserted); with a sharding plan the ladder stops at the
    cache."""
    n, nobj = int(w.shape[0]), int(w.shape[1])
    static = _nd_static_auto(n, nobj, w.device.type)
    names = _nd_candidates(n, nobj, w.device.type)
    candidates = dict.fromkeys(names)
    if (len(names) > 1 and plan is None
            and tuning.active_tuner() is not None
            and tuning.is_concrete(w)):
        candidates = {name: (lambda name=name: nd_rank(w, impl=name))
                      for name in names}
    return tuning.resolve(
        "nd_impl", bucket=(nobj, tuning.shape_bucket(n)),
        default=static, candidates=candidates, check="bitwise",
        program="nd_rank", device=w.device)


def nd_rank(w: torch.Tensor, max_rank: Optional[int] = None,
            impl: str = "auto", cover_k: Optional[int] = None,
            fallback: str = "none", return_peels: bool = False, plan=None):
    """Non-domination rank per row (0 = first front); equal rows share a
    rank.

    ``impl``: ``'matrix'`` peels fronts off the ``[n, n]`` dominance
    matrix; ``'tiled'`` peels with K7 and no matrix
    (:func:`deap_tpu_torch.ops.kernels.nd_rank_tiled`); ``'staircase'``
    (M = 2), ``'sweep'`` (M = 3) and ``'dc'`` (any M) are exact
    peeling-free engines; ``'auto'`` picks by n, M and ``w``'s device,
    or is the dispatch tuner's pick (:func:`_resolve_nd_impl`).

    ``max_rank`` stops after that many fronts (unpeeled rows keep rank
    ``n``); ``cover_k`` stops peeling once ``cover_k`` rows are ranked
    (exact for a top-k cut); ``fallback='count'`` ranks the rows left at
    a ``max_rank`` stop by ``max_rank + #dominators among them``, and for
    the exact engines returns their exact ranks. ``return_peels`` also
    returns the fronts peeled, as an int.

    ``plan`` (a :class:`deap_tpu_torch.parallel.ShardingPlan`): ``w`` is
    placed on the plan and ``'auto'`` asks the tuner's cache, never a
    probe. Every engine ranks the whole ``w`` on every rank (journaled
    ``sharding_fallback`` under several ranks): the same ranks on any
    rank count.
    """
    n = w.shape[0]
    if fallback not in ("none", "count"):
        raise ValueError(f"unknown nd_rank fallback {fallback!r}")
    if plan is not None:
        w = plan.constrain(plan.place(w, fresh=False))
    if impl == "auto":
        impl = _resolve_nd_impl(w, plan)
    if plan is not None and plan.n_shards > 1:
        from deap_tpu_torch.parallel.mesh import sharding_fallback
        sharding_fallback("nd_rank", f"the {impl} engine ranks the whole "
                          "population on every rank")
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


# the program observatory profiles it under the nd_impl knob's program label
nd_rank = costs.instrument(nd_rank, "nd_rank")


#: front maxima J3 keeps in shared memory at most (227 KB a block on the
#: H100); past them it keeps the rest in device memory
J3_SHARED_SLOTS = 232_448 // 4


def j3_slots(n: int) -> int:
    """J3's slots for the front maxima of ``n`` rows
    (``csrc/nd_scan.cu::j3_slots``): n fronts at most and the ``2 B`` past
    the F-th that its bucket search reads, ``B = ceil(F / 32)``."""
    return n + 2 * -(-n // 32)


def staircase_rows_plain(neg_f2: torch.Tensor,
                         head: torch.Tensor) -> torch.Tensor:
    """Plain version of J3: the staircase's pass over the sorted rows, a
    Python loop of a few tensor ops per row (it reads ``head`` to the
    host). ``neg_f2`` is ``-w1`` in lex-descending order, ``head`` marks
    the first row of each group of identical rows; returns the sorted
    ranks, ``int32[n]``."""
    n = neg_f2.shape[0]
    # slot n is a dump: a row of -inf counts every slot (rank n, as in
    # the JAX package) and its write is dropped there
    neg_m = torch.full((n + 1,), torch.inf, dtype=neg_f2.dtype,
                       device=neg_f2.device)
    sorted_ranks = torch.empty(n, dtype=torch.int64, device=neg_f2.device)
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
    return sorted_ranks.to(torch.int32)


def staircase_rows(neg_f2: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The staircase's row pass (J3): sorted ranks ``int32[n]`` of the
    rows ``neg_f2`` (float32, ``-w1`` in lex-descending order) with their
    group heads ``head`` (bool).

    On the card one launch of ``csrc/nd_scan.cu::staircase_kernel`` walks
    the rows in chunks of 32 (each chunk's searches against the front
    maxima as the chunk found them, then a chain over the chunk's own
    writes), the maxima in shared memory up to :data:`J3_SHARED_SLOTS`
    and in device memory past them;
    each launch adds one to ``nd_rank_staircase.launches``. On a CPU
    tensor :func:`staircase_rows_plain` runs. Both give the same ranks."""
    if neg_f2.device.type == "cpu":
        return staircase_rows_plain(neg_f2, head)
    if neg_f2.device.type != "cuda":
        raise ValueError(f"no kernel for device {neg_f2.device}")
    n = neg_f2.shape[0]
    if neg_f2.dtype != torch.float32 or head.dtype != torch.bool:
        raise ValueError("J3 takes float32 neg_f2 and a bool head")
    if neg_f2.dim() != 1 or head.shape != (n,) or head.device != \
            neg_f2.device:
        raise ValueError("neg_f2 and head must be [n] on one card")
    if n >= 2 ** 30:
        raise ValueError(f"J3 takes fewer than 2^30 rows, got {n}")
    ranks = torch.empty(n, dtype=torch.int32, device=neg_f2.device)
    if n == 0:
        return ranks
    slots = j3_slots(n)
    shared = min(slots, J3_SHARED_SLOTS)
    spill = torch.empty(max(slots - shared, 1), dtype=torch.int32,
                        device=neg_f2.device)
    neg_f2, head = neg_f2.contiguous(), head.contiguous()
    stream = torch.cuda.current_stream(neg_f2.device).cuda_stream
    PT, I = _build.PTR, _build.INT
    fn = _build.function("nd_scan", "staircase_rows",
                         [PT, PT, I, I, PT, PT, PT])
    err = fn(neg_f2.data_ptr(), head.data_ptr(), n, shared,
             spill.data_ptr(), ranks.data_ptr(), stream)
    nd_rank_staircase.launches += 1
    _build.check("nd_scan", err, "staircase_rows")
    return ranks


def staircase_inputs(w: torch.Tensor):
    """The staircase's sort: the lex-descending order of ``w`` (``[n,
    2]``), ``-w1`` in that order and the group heads (the first of each
    run of identical rows)."""
    n = w.shape[0]
    order = lex_sort_desc(w)
    f2 = w[order, 1]
    head = torch.ones(n, dtype=torch.bool, device=w.device)
    head[1:] = ~((w[order[1:], 0] == w[order[:-1], 0]) & (f2[1:] == f2[:-1]))
    return order, -f2, head


def nd_rank_staircase(w: torch.Tensor, max_rank: Optional[int] = None,
                      return_peels: bool = False):
    """Exact 2-objective non-domination ranks in O(n log n) work.

    Rows in lexicographic descending ``(w0, w1)`` order; one scalar per
    front, its largest ``w1`` so far, kept negated (ascending). A row's
    rank is the count of fronts whose maximum covers it, one binary
    search; identical rows share their group head's rank; a row with
    ``w1 = -inf`` ranks ``n``, as in the JAX package. The pass over the
    rows is :func:`staircase_rows`: J3 on the card, one launch.
    """
    n, nobj = w.shape
    if nobj != 2:
        raise ValueError(f"nd_rank_staircase needs nobj == 2, got {nobj}")
    if n == 0:
        ranks = torch.zeros(0, dtype=torch.int32, device=w.device)
        return (ranks, 0) if return_peels else ranks
    order, neg_f2, head = staircase_inputs(w)
    return _finish(staircase_rows(neg_f2, head), order, n, max_rank,
                   return_peels)


nd_rank_staircase.launches = 0


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


# --------------------------------------------------------------- NSGA-III ----

class NSGA3Memory(NamedTuple):
    best_point: torch.Tensor
    worst_point: torch.Tensor
    extreme_points: torch.Tensor


def _find_extreme_points(fitnesses, best_point, extreme_points=None):
    """The row of least achievement scalarising function on each axis."""
    if extreme_points is not None:
        fitnesses = torch.cat([fitnesses, extreme_points], 0)
    ft = fitnesses - best_point
    nobj = best_point.shape[0]
    eye = torch.eye(nobj, dtype=torch.bool, device=ft.device)
    asf_w = torch.where(eye, 1.0, 1e6)
    asf = (ft[None, :, :] * asf_w[:, None, :]).amax(2)  # [nobj, n]
    return fitnesses[torch.argmin(asf, 1)]


def _find_intercepts(extreme_points, best_point, current_worst, front_worst):
    """The hyperplane's axis intercepts, or ``front_worst`` where they are
    degenerate. ``torch.linalg.solve_ex`` neither raises on a singular
    matrix nor waits for the card's error check: a nonzero ``info`` or a
    non-finite solution takes the fallback, as the JAX package's
    non-finite solution does."""
    nobj = extreme_points.shape[1]
    b = torch.ones(nobj, dtype=extreme_points.dtype,
                   device=extreme_points.device)
    A = extreme_points - best_point
    x, info = torch.linalg.solve_ex(A, b[:, None])
    x = x[:, 0]
    intercepts = 1.0 / x
    residual_ok = ((A @ x - b).abs() <= 1e-6 + 1e-4 * b.abs()).all()
    ok = ((info == 0) & torch.isfinite(x).all() & (x != 0.0).all()
          & (intercepts > 1e-6).all()
          & ((intercepts + best_point) <= current_worst).all()
          & residual_ok)
    return torch.where(ok, intercepts, front_worst)


def _associate_to_niche(fitnesses, ref_points, best_point, intercepts):
    """Each row's nearest reference direction and its perpendicular
    distance to it."""
    fn = (fitnesses - best_point) / (intercepts - best_point)
    norm = norm_rn(ref_points)
    proj_len = fn @ ref_points.T / norm[None, :]                 # [n, nref]
    proj = proj_len[:, :, None] * (ref_points / norm[:, None])[None, :, :]
    distances = norm_rn(proj - fn[:, None, :])
    return torch.argmin(distances, 1), distances.amin(1)


class NSGA3Plan(NamedTuple):
    """What :func:`nsga3_plan` settles before the niching draws: ranks,
    the rows taken whole, the partial front (``partial_idx``, ascending)
    with its niches and distances, the niche counts of the rows taken,
    the number of rows to fill from the partial front and the memory."""
    ranks: torch.Tensor        # int32[n]
    ahead: torch.Tensor        # bool[n]
    partial_idx: torch.Tensor  # int64[m]
    niches: torch.Tensor       # int64[m]
    dist: torch.Tensor         # f32[m]
    counts: torch.Tensor       # int64[nref]
    n_fill: int
    memory: NSGA3Memory


def nsga3_plan(w: torch.Tensor, k: int, ref_points: torch.Tensor,
               best_point=None, worst_point=None, extreme_points=None,
               nd: str = "standard") -> NSGA3Plan:
    """NSGA-III up to its niching draws: ranks (peeling stops once ``k``
    rows are ranked: exact, since the rows left unpeeled keep rank n,
    above the cut), the ideal, worst and extreme points, the intercepts
    and each row's niche. One synchronise reads the rows to fill and the
    partial front's size."""
    ranks = nd_rank(w, impl=_impl_of(nd), cover_k=k)
    fitnesses = -w  # minimisation space
    if best_point is not None and worst_point is not None:
        best_point = torch.minimum(fitnesses.amin(0), best_point)
        worst_point = torch.maximum(fitnesses.amax(0), worst_point)
    else:
        best_point = fitnesses.amin(0)
        worst_point = fitnesses.amax(0)
    extreme = _find_extreme_points(fitnesses, best_point, extreme_points)
    intercepts = _find_intercepts(extreme, best_point, worst_point,
                                  fitnesses.amax(0))
    niches, dist = _associate_to_niche(
        fitnesses, ref_points.to(w.device), best_point, intercepts)
    cut = torch.sort(ranks).values[k - 1]
    ahead = ranks < cut
    counts = torch.zeros(ref_points.shape[0], dtype=torch.int64,
                         device=w.device).index_add_(0, niches,
                                                     ahead.to(torch.int64))
    # the one synchronise: where the cut's front starts and ends
    n_ahead, end = torch.stack([ahead.sum(), (ranks <= cut).sum()]).tolist()
    partial_idx = torch.nonzero_static(ranks == cut, size=end - n_ahead)[:, 0]
    n_fill = k - n_ahead
    return NSGA3Plan(ranks, ahead, partial_idx, niches[partial_idx],
                     dist[partial_idx], counts, n_fill,
                     NSGA3Memory(best_point, worst_point, extreme))


def nsga3_draws(generator: torch.Generator, plan: NSGA3Plan):
    """The niching loop's draws in one call, ``u [n_fill, 2]``: a uniform
    an iteration for its niche and one for its row, each scaled onto the
    candidates in ascending order (:func:`nsga3_select_scaled`). Their
    memory is ``n_fill`` pairs whatever the partial front's size."""
    return torch.rand((plan.n_fill, 2), generator=generator,
                      device=generator.device)


def _niching_host(plan: NSGA3Plan, draws: torch.Tensor, scaled: bool):
    """The niching loop on the host after one copy of the partial front's
    niches and distances, the counts and ``draws``. ``scaled``: ``draws
    [n_fill, 2]``, the candidate at ``floor(u · candidates)``; else
    ``draws [n_fill, nref + m]``, a uniform a niche and a partial-front
    row, the candidate of largest draw (ties to the lowest index).

    The open niches are kept by count (each count's list ascending) and
    each niche's available rows as an ascending list, so an iteration
    costs list steps, not passes over every niche or row: a niche leaves
    its count's list when picked and joins the next count's while it has
    rows; the least count's list is the candidates. A niche of count 0
    has lost no row, so its closest row is read from all its rows."""
    niches, counts, n_fill = plan.niches, plan.counts, plan.n_fill
    m, nref = niches.shape[0], counts.shape[0]
    packed = torch.cat([niches.to(torch.float32), plan.dist,
                        counts.to(torch.float32),
                        draws.reshape(-1)]).cpu().numpy()
    niches_h = packed[:m].astype(np.int64)
    dist_h = packed[m:2 * m]
    counts_h = packed[2 * m:2 * m + nref].astype(np.int64).tolist()
    u = packed[2 * m + nref:].reshape(n_fill, -1)
    if scaled:  # float64: u < 1 keeps u · len below len
        u = u.astype(np.float64).tolist()

        def pick(i, role, idx):
            return int(u[i][role] * len(idx))
    else:
        niche_u, member_u = u[:, :nref], u[:, nref:]

        def pick(i, role, idx):
            return int(np.argmax((member_u if role else niche_u)[i, idx]))
    order = np.argsort(niches_h, kind="stable")
    starts = np.searchsorted(niches_h[order], np.arange(nref + 1))
    members, levels = [], {}
    for j in range(nref):
        mem = order[starts[j]:starts[j + 1]]
        members.append(mem.tolist())
        if len(mem):
            levels.setdefault(counts_h[j], []).append(j)
    taken = np.zeros(m, bool)
    cand = []
    for i in range(n_fill):
        if not cand:
            level = min(levels)
            cand = levels.pop(level)
        niche = cand.pop(pick(i, 0, cand))
        mem = members[niche]
        if level == 0:
            chosen = mem.pop(int(np.argmin(dist_h[mem])))
        else:
            chosen = mem.pop(pick(i, 1, mem))
        taken[chosen] = True
        if mem:
            bisect.insort(levels.setdefault(level + 1, []), niche)
    return torch.from_numpy(taken).to(niches.device)


def _nsga3_choose(plan: NSGA3Plan, k: int, draws: torch.Tensor,
                  scaled: bool) -> torch.Tensor:
    n = plan.ranks.shape[0]
    chosen_mask = plan.ahead.clone()
    if plan.n_fill > 0:
        chosen_mask[plan.partial_idx] = _niching_host(plan, draws, scaled)
    key = torch.where(chosen_mask, plan.ranks, n + 1)
    return torch.sort(key, stable=True).indices[:k]


def nsga3_select(plan: NSGA3Plan, k: int, niche_u: torch.Tensor,
                 member_u: torch.Tensor) -> torch.Tensor:
    """NSGA-III's choice on the JAX package's draws: the rows ahead of
    the cut, then ``n_fill`` rows of the partial front, one an iteration:
    among the open niches of least count the one of largest
    ``niche_u [n_fill, nref]``, and in it the closest row if its count is
    0, else the row of largest ``member_u [n_fill, m]`` (a draw a
    partial-front row; ties to the lowest index). The loop runs in numpy
    after one copy."""
    return _nsga3_choose(plan, k, torch.cat([niche_u, member_u], 1), False)


def nsga3_select_scaled(plan: NSGA3Plan, k: int,
                        u: torch.Tensor) -> torch.Tensor:
    """:func:`nsga3_select` on :func:`nsga3_draws`' ``u [n_fill, 2]``:
    iteration ``i`` takes the open niche of least count at
    ``floor(u[i, 0] · candidates)`` and, where its count is not 0, the
    available row at ``floor(u[i, 1] · rows)``, both in ascending order.
    A uniform choice, as the argmax of a uniform an index is, in
    ``n_fill`` pairs of draws where that takes ``n_fill · (nref + m)``."""
    return _nsga3_choose(plan, k, u, True)


def sel_nsga3(generator: torch.Generator, w: torch.Tensor, k: int,
              ref_points: torch.Tensor, best_point=None, worst_point=None,
              extreme_points=None, return_memory: bool = False,
              nd: str = "standard"):
    """NSGA-III selection (Deb & Jain 2014): whole fronts in rank order;
    the last partial front filled by reference-point niching, one row at
    a time from a least-populated niche (its closest row when the niche
    is empty, else a random one).

    Pass the previous generation's memory (best, worst and extreme
    points) for the ``selNSGA3WithMemory`` behaviour. ``nd`` follows
    :func:`sel_nsga2`. On the card at M >= 3 and n >= 8192 the ranks peel
    through K7; the niching loop runs on the host
    (:func:`nsga3_select_scaled`).
    """
    plan = nsga3_plan(w, k, ref_points, best_point, worst_point,
                      extreme_points, nd)
    chosen = nsga3_select_scaled(plan, k, nsga3_draws(generator, plan))
    return (chosen, plan.memory) if return_memory else chosen


class SelNSGA3WithMemory:
    """NSGA-III carrying the best, worst and extreme points across
    generations."""

    def __init__(self, ref_points):
        self.ref_points = ref_points
        self.memory = None

    def __call__(self, generator, w, k):
        mem = self.memory
        chosen, self.memory = sel_nsga3(
            generator, w, k, self.ref_points,
            best_point=None if mem is None else mem.best_point,
            worst_point=None if mem is None else mem.worst_point,
            extreme_points=None if mem is None else mem.extreme_points,
            return_memory=True)
        return chosen


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


# ------------------------------------------------------------ dense SPEA2 ----

def _two_sum(a, b):
    """Error-free addition: ``(s, err)`` with ``s = fl(a + b)`` and ``s +
    err == a + b`` exactly (Knuth's TwoSum). Each operation is rounded
    alone: no ``torch.compile``, no ``addcmul``."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod_f32(a, b):
    """Error-free float32 product by Veltkamp splitting: ``(p, err)`` with
    ``p = fl(a·b)`` and ``p + err == a·b``."""
    split = 4097.0                          # 2^12 + 1 for float32
    ca, cb = a * split, b * split
    ah = ca - (ca - a)
    al = a - ah
    bh = cb - (cb - b)
    bl = b - bh
    p = a * b
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


def _d2_compensated(w: torch.Tensor):
    """Pairwise squared distances in double-float32: ``(hi, lo)``, the
    float32 head and its residual, ~48 significant bits together — the
    float64 tie structure from float32 inputs."""
    n, nobj = w.shape
    hi = torch.zeros((n, n), dtype=torch.float32, device=w.device)
    lo = torch.zeros((n, n), dtype=torch.float32, device=w.device)
    for c in range(nobj):
        d, derr = _two_sum(w[:, c][:, None], -w[:, c][None, :])
        p, perr = _two_prod_f32(d, d)
        # (d + derr)² = d² + 2·d·derr + derr²; d² = p + perr exactly
        corr = perr + 2.0 * d * derr + derr * derr
        hi, e = _two_sum(hi, p)
        lo = lo + (e + corr)
    return hi, lo


def _truncate(mask: torch.Tensor, count: int, k: int, d2_hi: torch.Tensor,
              d2_lo: torch.Tensor) -> torch.Tensor:
    """SPEA2's archive truncation: while more than ``k`` rows live, drop
    the live row whose ascending vector of distances to the others is
    lexicographically least, compared on ``(hi, lo)`` to full depth;
    residual ties drop the lowest live index. A host loop: each removal
    reads the live rows (one synchronise) and each step of its tie loop
    the number of candidates left."""
    mask = mask.clone()
    while count > k:
        live = torch.nonzero(mask)[:, 0]
        m = live.shape[0]
        eye = torch.eye(m, dtype=torch.bool, device=mask.device)
        ddh = torch.where(eye, torch.inf,
                          d2_hi.index_select(0, live).index_select(1, live))
        ddl = torch.where(eye, 0.0,
                          d2_lo.index_select(0, live).index_select(1, live))
        # each row ascending by (hi, lo): a stable sort by lo, then by hi
        order = torch.sort(ddl, dim=1, stable=True).indices
        order = order.gather(1, torch.sort(ddh.gather(1, order), dim=1,
                                           stable=True).indices)
        rows_h, rows_l = ddh.gather(1, order), ddl.gather(1, order)
        cand = torch.ones(m, dtype=torch.bool, device=mask.device)
        j = 0
        while j < m and int(cand.sum()) > 1:
            colh = torch.where(cand, rows_h[:, j], torch.inf)
            cand = cand & (colh == colh.min())
            coll = torch.where(cand, rows_l[:, j], torch.inf)
            cand = cand & (coll == coll.min())
            j += 1
        mask[live[torch.argmax(cand.to(torch.uint8))]] = False
        count -= 1
    return mask


def sel_spea2(generator, w: torch.Tensor, k: int) -> torch.Tensor:
    """SPEA2 environmental selection (Zitzler 2001) with the dense
    ``[n, n]`` matrices.

    Strength and raw fitness from the dominance matrix; an under-full
    non-dominated archive is filled by raw fitness plus k-NN density
    (k = √n, over all other rows, the algorithm as published); an
    over-full one is truncated by :func:`_truncate` on double-float32
    distances (float64 inputs compare their plain distances).
    ``generator`` is not used: the selection is deterministic.
    """
    del generator
    n = w.shape[0]
    dom = dominance_matrix(w)                       # dom[i, j]: j dominates i
    strength = dom.sum(0)
    raw = torch.where(dom, strength[None, :], 0).sum(1)
    nd_mask = raw < 1
    n_nd = int(nd_mask.sum())
    d2 = _pairwise_d2(w)
    fill_score = raw + _knn_density(d2, _knn_kth(n))
    if n_nd <= k:
        return lexsort([fill_score, (~nd_mask).to(torch.uint8)])[:k]
    if w.dtype == torch.float32:
        d2_hi, d2_lo = _d2_compensated(w)
    else:
        d2_hi, d2_lo = d2, torch.zeros_like(d2)
    final = _truncate(nd_mask, n_nd, k, d2_hi, d2_lo)
    return lexsort([fill_score, (~final).to(torch.uint8)])[:k]


# DEAP-style aliases
selNSGA2 = sel_nsga2
selNSGA3 = sel_nsga3
selSPEA2 = sel_spea2
selTournamentDCD = sel_tournament_dcd
sortNondominated = sort_nondominated
sortLogNondominated = sort_nondominated
