"""Search-dynamics probes — population analytics on the Meter.

Port of :mod:`deap_tpu.telemetry.probes`: probes that turn a
generation's population into diversity / selection-pressure /
landscape / front-quality metrics, as tensor operations on the run's
device that read nothing back, so a telemetered generation waits for
the card no more than a bare one.

A probe is a callable ``probe(meter, mstate, **ctx) -> mstate`` with a
``declare(meter)`` hook and a ``metric_names`` tuple naming every
journal-visible metric it maintains. The context the loops provide:

- ``pop`` — the generation's :class:`~deap_tpu_torch.core.population.
  Population`;
- ``gen`` — the generation index (a Python int);
- ``sel_idx`` / ``sel_pool`` — the selection index vector the loop just
  used and the size of the pool it indexes into;
- ``parent_idx`` — per-child parent indices into the previous
  population, where the loop's selection doubles as parentage
  (``ea_simple``, the GP loop);
- ``state`` — the strategy state (ask-tell loops);
- ``journal`` — the active RunJournal, for host-side sampled events;
- ``host_clone_rate`` — the exact clone rate, where the GP loop already
  ran the interpreter's dedup (see :class:`TreeDiversityProbe`).

Probes read the population, draw nothing from the run's generator and
feed nothing back: enabling any of them leaves populations, logbooks,
halls of fame and the generator bit-identical. Carried quantities
(previous best, stagnation age, lineage depths) live in ordinary Meter
gauges, the bulky ones declared ``internal``.

The :class:`HealthMonitor` turns decoded meter rows into journaled
``alarm`` events (NaN/Inf fitness, clone-rate spike, premature
convergence, zero-improvement window) with an optional early-stop
signal for host-driven loops.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.telemetry.meter import mean_f32

__all__ = [
    "PROBE_REGISTRY",
    "register_probe",
    "Probe",
    "DiversityProbe",
    "TreeDiversityProbe",
    "FitnessProbe",
    "SelectionProbe",
    "FrontProbe",
    "HealthMonitor",
    "compose_probes",
    "exact_hypervolume",
]

#: probe-class registry (the JAX package's names, class for class)
PROBE_REGISTRY: Dict[str, type] = {}

_M32 = 0xFFFFFFFF


def register_probe(cls: type) -> type:
    PROBE_REGISTRY[cls.__name__] = cls
    return cls


class Probe:
    """Base protocol. ``metric_names`` lists every journal-visible
    metric the probe declares."""

    metric_names: Tuple[str, ...] = ()

    def declare(self, meter) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def __call__(self, meter, mstate, **ctx):  # pragma: no cover
        raise NotImplementedError


# ------------------------------------------------------------ helpers ----

def _strided(n: int, k: int, device) -> torch.Tensor:
    """k row indices spread evenly over [0, n): ``(arange(k) * n) // k``,
    no draw (probes must not touch the run's generator)."""
    k = min(int(k), int(n))
    return (torch.arange(k, dtype=torch.int64, device=device) * n) // k


def _mul32(v: torch.Tensor, w) -> torch.Tensor:
    """``(v * w) mod 2**32`` for ``v`` and ``w`` (a tensor or a Python
    int) in ``[0, 2**32)`` held as int64: ``v`` split into 16-bit halves
    so no product leaves int64."""
    lo = (v & 0xFFFF) * w
    hi = ((v >> 16) * w) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _unique_count(rows: torch.Tensor) -> torch.Tensor:
    """Number of distinct rows of an int32 ``[n, d]`` matrix through the
    JAX package's double 32-bit row hash, bit for bit: the uint32 words
    are carried as ``int64 & 0xFFFFFFFF`` (torch's CPU ``uint32`` has no
    multiply, add or compare), the pairs sorted stably as ``lexsort``
    does. An int32 count on the rows' device, read back by no one."""
    v = rows.to(torch.int64) & _M32
    d = v.shape[1]
    j = torch.arange(d, dtype=torch.int64, device=rows.device)
    w1 = (_mul32(j, 2654435761) + 0x9E3779B9) & _M32
    w2 = (_mul32((j + 0x7FEE3F) & _M32, 2246822519) + 0x85EBCA6B) & _M32
    h1 = _mul32(v, w1[None, :]).sum(1) & _M32
    h2 = _mul32(v, w2[None, :]).sum(1) & _M32
    o2 = torch.sort(h2, stable=True).indices
    o1 = torch.sort(h1[o2], stable=True).indices
    order = o2[o1]
    s1, s2 = h1[order], h2[order]
    fresh = (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1])
    return 1 + fresh.sum(dtype=torch.int32)


def _genome_matrix(genomes: Any) -> torch.Tensor:
    """Flatten any genome tree to ``f32[n, D]`` (shared leading axis)."""
    leaves = pytree.tree_leaves(genomes)
    n = leaves[0].shape[0]
    return torch.cat([a.reshape(n, -1).to(torch.float32) for a in leaves],
                     dim=1)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a 1-D float32 tensor: the midpoint of the
    two middle values of the non-NaN entries (``torch.nanmedian`` takes
    the lower one), NaN when all are NaN; the positions are gathered,
    never read back."""
    s = torch.sort(x).values  # NaN sorts last
    counts = (~torch.isnan(s)).sum().to(torch.float32)
    q = 0.5 * (counts - 1)
    top = counts - 1
    low = torch.maximum(torch.zeros_like(q), torch.minimum(q.floor(), top))
    high = torch.maximum(torch.zeros_like(q), torch.minimum(q.ceil(), top))
    lv = s.gather(0, low.to(torch.int64).reshape(1))[0]
    hv = s.gather(0, high.to(torch.int64).reshape(1))[0]
    return (lv + hv) * 0.5


# ========================================================== diversity ====

@register_probe
class DiversityProbe(Probe):
    """Genotypic diversity of vector genomes (bitstring / real / any
    tree of tensors, flattened).

    Every statistic is computed on a deterministic strided sample of
    ``sample`` rows (no draw): O(K·d) gather + O(K²) pairwise through
    one Gram matrix product.

    - ``div_msd`` — mean pairwise squared distance over the sample's
      ordered pairs, ``2k/(k-1) · Σ_d var_d``.
    - ``div_pdist_mean`` / ``div_pdist_std`` / ``div_pdist_min`` —
      euclidean pairwise-distance moments of the sample block.
    - ``div_unique_frac`` — fraction of distinct rows in the sample
      (double 32-bit row hash); ``full_unique=True`` hashes the whole
      population instead (an O(nd + n log n) pass).
    """

    metric_names = ("div_msd", "div_pdist_mean", "div_pdist_std",
                    "div_pdist_min", "div_unique_frac")

    def __init__(self, sample: int = 256, full_unique: bool = False):
        self.sample = int(sample)
        self.full_unique = bool(full_unique)

    def declare(self, meter) -> None:
        for name in self.metric_names:
            meter.gauge(name)

    def __call__(self, meter, mstate, pop=None, **_ctx):
        if pop is None:
            return mstate
        leaves = pytree.tree_leaves(pop.genomes)
        n = leaves[0].shape[0]
        idx = _strided(n, self.sample, leaves[0].device)
        # gather the rows before the float32 flatten (an O(nd) copy)
        sub = _genome_matrix(pytree.tree_map(lambda a: a[idx], pop.genomes))
        k = sub.shape[0]

        mu = mean_f32(sub, 0)
        var_sum = mean_f32(((sub - mu[None, :]) ** 2).sum(1))
        msd = (2.0 * k / max(k - 1, 1)) * var_sum
        mstate = meter.set(mstate, "div_msd", msd)

        sqn = (sub * sub).sum(1)
        sq = sqn[:, None] + sqn[None, :] - 2.0 * (sub @ sub.T)
        pd = sq.clamp_min(0.0).sqrt()
        off = ~torch.eye(k, dtype=torch.bool, device=sub.device)
        npair = max(k * (k - 1), 1)
        zero = torch.zeros((), dtype=pd.dtype, device=pd.device)
        pmean = torch.where(off, pd, zero).sum() / npair
        pvar = torch.where(off, (pd - pmean) ** 2, zero).sum() / npair
        mstate = meter.set(mstate, "div_pdist_mean", pmean)
        mstate = meter.set(mstate, "div_pdist_std", pvar.sqrt())
        if k > 1:
            pmin = torch.where(off, pd, torch.full_like(pd, math.inf)).min()
            pmin = torch.where(pmin.isfinite(), pmin, zero)
        else:
            pmin = zero
        mstate = meter.set(mstate, "div_pdist_min", pmin)

        hashed = _genome_matrix(pop.genomes) if self.full_unique else sub
        uniq = _unique_count(hashed.view(torch.int32))
        mstate = meter.set(mstate, "div_unique_frac",
                           uniq.to(torch.float32) / hashed.shape[0])
        return mstate


@register_probe
class TreeDiversityProbe(Probe):
    """Genotypic diversity of GP tree populations (prefix-linearised
    ``{"nodes", "consts", "length"}`` genomes).

    - ``gp_opcode_entropy`` — Shannon entropy (nats) of the live-slot
      opcode histogram.
    - ``gp_clone_rate`` — ``1 − unique/n`` over live prefixes, padding
      normalised out as the interpreter's dedup does: the double row
      hash, or, where the GP loop already deduped, the exact rate it
      passes as ``host_clone_rate``.
    - ``gp_mean_size`` — mean live prefix length.
    """

    metric_names = ("gp_opcode_entropy", "gp_clone_rate", "gp_mean_size")

    def __init__(self, pset):
        self.n_ops = int(pset.n_ops)

    def declare(self, meter) -> None:
        for name in self.metric_names:
            meter.gauge(name)

    def __call__(self, meter, mstate, pop=None, host_clone_rate=None,
                 **_ctx):
        if pop is None:
            return mstate
        g = pop.genomes
        nodes = g["nodes"].to(torch.int32)
        consts = g["consts"].to(torch.float32)
        length = g["length"].to(torch.int32)
        n, L = nodes.shape
        live = torch.arange(L, device=nodes.device)[None, :] < length[:, None]

        is_op = live & (nodes < self.n_ops)
        ids = torch.where(is_op, nodes, self.n_ops).reshape(-1).to(torch.int64)
        hist = torch.zeros(self.n_ops + 1, dtype=torch.float32,
                           device=nodes.device).index_add(
            0, ids, is_op.reshape(-1).to(torch.float32))[: self.n_ops]
        total = hist.sum().clamp_min(1.0)
        p = hist / total
        zero = torch.zeros((), dtype=torch.float32, device=p.device)
        ent = -torch.where(p > 0, p * torch.log(p), zero).sum()
        mstate = meter.set(mstate, "gp_opcode_entropy", ent)

        if host_clone_rate is not None:
            mstate = meter.set(mstate, "gp_clone_rate", host_clone_rate)
        else:
            nn = torch.where(live, nodes, -1)
            cc = torch.where(live, consts, zero).view(torch.int32)
            uniq = _unique_count(torch.cat([nn, cc], dim=1))
            mstate = meter.set(mstate, "gp_clone_rate",
                               1.0 - uniq.to(torch.float32) / n)
        mstate = meter.set(mstate, "gp_mean_size", mean_f32(length))
        return mstate


# ================================================== fitness landscape ====

@register_probe
class FitnessProbe(Probe):
    """Fitness-landscape shape and search progress, from the first
    weighted objective.

    - ``fit_gap`` — best − median; the median over a deterministic
      strided ``sample`` of the valid rows, the best the exact
      population max.
    - ``fit_velocity`` — best-so-far improvement this generation.
    - ``stagnation_age`` — generations since best-so-far last improved
      by more than ``min_delta``.

    The previous best rides the meter as an ``internal`` gauge.
    """

    metric_names = ("fit_gap", "fit_velocity", "stagnation_age")

    def __init__(self, min_delta: float = 0.0, sample: int = 1024):
        self.min_delta = float(min_delta)
        self.sample = int(sample)

    def declare(self, meter) -> None:
        meter.gauge("fit_gap")
        meter.gauge("fit_velocity")
        meter.gauge("stagnation_age", dtype=torch.int32)
        meter.gauge("fit_prev_best", internal=True)
        meter.gauge("fit_seen", dtype=torch.int32, internal=True)

    def __call__(self, meter, mstate, pop=None, **_ctx):
        if pop is None:
            return mstate
        w0 = pop.wvalues[:, 0]
        best = w0.max()
        sub = _strided(w0.shape[0], self.sample, w0.device)
        med = _nanmedian(torch.where(pop.valid[sub], w0[sub],
                                     torch.full_like(w0[sub], math.nan)))
        prev = mstate["fit_prev_best"]
        seen = mstate["fit_seen"] > 0
        improved = best > prev + self.min_delta
        vel = torch.where(seen, best - prev, torch.zeros_like(best))
        stag = torch.where(seen & ~improved, mstate["stagnation_age"] + 1,
                           torch.zeros_like(mstate["stagnation_age"]))
        mstate = meter.set(mstate, "fit_gap", best - med)
        mstate = meter.set(mstate, "fit_velocity", vel)
        mstate = meter.set(mstate, "stagnation_age", stag)
        mstate = meter.set(mstate, "fit_prev_best",
                           torch.where(seen, torch.maximum(prev, best), best))
        mstate = meter.set(mstate, "fit_seen", 1)
        return mstate


# ================================================ quarantine counting ====

@register_probe
class QuarantineProbe(Probe):
    """Count fitness rows quarantined by
    :func:`deap_tpu_torch.resilience.quarantine_non_finite` (rows at its
    sentinel ``penalty``), so the poisoning stays visible in the journal
    after the substitution hid it from ``isfinite``.

    - ``quarantined`` — rows at the sentinel this generation.
    - ``quarantined_total`` — cumulative count over the run.

    A nonzero ``quarantined`` fires the HealthMonitor's ``non_finite``
    alarm. ``penalty`` must match the wrapper's.
    """

    metric_names = ("quarantined", "quarantined_total")

    def __init__(self, penalty: Optional[float] = None):
        if penalty is None:
            from deap_tpu_torch.resilience.engine import QUARANTINE_PENALTY
            penalty = QUARANTINE_PENALTY
        self.penalty = float(penalty)

    def declare(self, meter) -> None:
        meter.gauge("quarantined", dtype=torch.int32)
        meter.counter("quarantined_total")

    def __call__(self, meter, mstate, pop=None, **_ctx):
        if pop is None:
            return mstate
        sentinel = float(np.float32(self.penalty))
        hit = (pop.fitness == sentinel).any(-1)
        n = (hit & pop.valid).sum(dtype=torch.int32)
        mstate = meter.set(mstate, "quarantined", n)
        mstate = meter.inc(mstate, "quarantined_total", n)
        return mstate


# ================================================= selection pressure ====

@register_probe
class SelectionProbe(Probe):
    """Selection pressure, from the index vector the loop already holds.

    - ``sel_eff_parents`` — effective parent count, the inverse Simpson
      index ``1/Σ pᵢ²`` of the selection-count distribution.
    - ``sel_loss_diversity`` — the fraction of the pool never picked.
    - ``lineage_depth_mean`` / ``lineage_depth_max`` — generations of
      ancestry per individual: the per-individual depth rides the meter
      as an ``internal`` gauge and advances by ``depth[parent_idx] + 1``.
      Only loops whose selection doubles as parentage provide
      ``parent_idx`` (``ea_simple``, the GP loop).

    ``every=k`` computes the pressure statistics every k-th generation
    only (the gauges hold their last value between); lineage depths
    advance every generation.
    """

    metric_names = ("sel_eff_parents", "sel_loss_diversity",
                    "lineage_depth_mean", "lineage_depth_max")

    def __init__(self, n: Optional[int] = None, lineage: bool = True,
                 every: int = 1):
        """``n`` — population size, required when ``lineage`` is on."""
        if lineage and n is None:
            raise ValueError("SelectionProbe(lineage=True) needs n= "
                             "(the per-individual depth gauge's shape)")
        self.n = None if n is None else int(n)
        self.lineage = bool(lineage)
        self.every = max(int(every), 1)

    def declare(self, meter) -> None:
        meter.gauge("sel_eff_parents")
        meter.gauge("sel_loss_diversity")
        if self.lineage:
            meter.gauge("lineage_depth_mean")
            meter.gauge("lineage_depth_max", dtype=torch.int32)
            meter.gauge("lineage_depth", shape=(self.n,), dtype=torch.int32,
                        internal=True)

    def __call__(self, meter, mstate, sel_idx=None, sel_pool=None,
                 parent_idx=None, gen=None, **_ctx):
        if sel_idx is not None and sel_pool and (
                self.every == 1 or gen is None or gen % self.every == 0):
            k = sel_idx.shape[0]
            idx = sel_idx.to(torch.int64)
            counts = torch.zeros(int(sel_pool), dtype=torch.float32,
                                 device=idx.device).index_add(
                0, idx, torch.ones(k, dtype=torch.float32, device=idx.device))
            p = counts / k
            eff = 1.0 / (p * p).sum().clamp_min(1e-12)
            mstate = meter.set(mstate, "sel_eff_parents", eff)
            mstate = meter.set(mstate, "sel_loss_diversity",
                               mean_f32(counts == 0))
        if self.lineage and parent_idx is not None:
            depth = mstate["lineage_depth"]
            nd = depth[parent_idx.to(torch.int64)] + 1
            mstate = meter.set(mstate, "lineage_depth", nd)
            mstate = meter.set(mstate, "lineage_depth_mean", mean_f32(nd))
            mstate = meter.set(mstate, "lineage_depth_max", nd.max())
        return mstate


# ====================================================== front quality ====

def _hv_slab(P: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Exact hypervolume of the union of boxes ``[ref, p]`` for M in
    {1, 2, 3}, maximisation, ``P`` pre-clipped to ``>= ref``: the
    staircase after an x-descending sort (M 2), the slab decomposition
    along z with a row-wise cummax (M 3, O(K²)). The sorts are stable,
    as ``jnp.argsort``."""
    m = P.shape[1]
    if m == 1:
        return P[:, 0].max() - ref[0]
    xo = torch.sort(-P[:, 0], stable=True).indices
    xs, ys = P[xo, 0], P[xo, 1]
    widths = xs - torch.cat([xs[1:], ref[None, 0]])
    if m == 2:
        ymax = torch.cummax(ys, 0).values
        return (widths * (ymax - ref[1])).sum()
    zo = torch.sort(-P[:, 2], stable=True).indices
    zs = P[zo, 2]
    slabs = zs - torch.cat([zs[1:], ref[None, 2]])
    k = P.shape[0]
    zrank = torch.empty(k, dtype=torch.int64, device=P.device)
    zrank[zo] = torch.arange(k, device=P.device)
    member = zrank[xo][None, :] <= torch.arange(k, device=P.device)[:, None]
    ymax = torch.cummax(torch.where(member, ys[None, :], ref[1]), 1).values
    areas = (widths[None, :] * (ymax - ref[1])).sum(1)
    return (slabs * areas).sum()


def exact_hypervolume(wvalues, ref) -> float:
    """Host-side exact hypervolume (the port's native WFG,
    :mod:`deap_tpu_torch.native`) of the points strictly dominating
    ``ref``, in the package's maximisation convention: the ground truth
    the in-loop ``hv_proxy`` is checked against."""
    from deap_tpu_torch.native import hypervolume

    if isinstance(wvalues, torch.Tensor):
        wvalues = wvalues.detach().cpu().numpy()
    w = np.asarray(wvalues, np.float64)
    r = np.asarray(ref, np.float64)
    keep = np.all(w > r[None, :], axis=1) & np.all(np.isfinite(w), axis=1)
    if not keep.any():
        return 0.0
    return float(hypervolume(-w[keep], -r))


@register_probe
class FrontProbe(Probe):
    """Per-generation multi-objective front quality, M ≤ 3, on a
    deterministic strided sample of ``max_points`` rows:

    - ``front_frac`` — non-dominated fraction of the sample.
    - ``front_spread`` — euclidean norm of the front's per-objective
      extents.
    - ``front_spacing`` — Schott's spacing: std of each front point's
      nearest-front-neighbour distance.
    - ``hv_proxy`` — exact hypervolume of the sampled points w.r.t.
      ``ref`` (staircase for M=2, slab decomposition for M=3).

    With ``exact_every=k`` the sampled points are copied to the host
    every k generations (one small transfer, which waits for the card)
    and the native exact hypervolume lands in the journal as
    ``hv_exact`` events.
    """

    metric_names = ("front_frac", "front_spread", "front_spacing",
                    "hv_proxy")

    def __init__(self, ref: Sequence[float], max_points: int = 512,
                 exact_every: int = 0):
        self.ref = tuple(float(r) for r in ref)
        self.max_points = int(max_points)
        self.exact_every = int(exact_every)

    def declare(self, meter) -> None:
        for name in self.metric_names:
            meter.gauge(name)

    def __call__(self, meter, mstate, pop=None, gen=None, journal=None,
                 **_ctx):
        if pop is None:
            return mstate
        W = pop.wvalues
        m = W.shape[1]
        if m != len(self.ref):
            raise ValueError(f"FrontProbe ref has {len(self.ref)} "
                             f"objectives, population has {m}")
        if m > 3:
            raise ValueError("FrontProbe supports M <= 3 (in-loop "
                             "hypervolume); use exact_hypervolume on "
                             "the host for higher M")
        ref = torch.tensor(self.ref, dtype=torch.float32, device=W.device)
        idx = _strided(W.shape[0], self.max_points, W.device)
        S = W[idx]
        P = torch.maximum(S, ref[None, :])  # invalid (-inf) rows collapse
        k = P.shape[0]

        ge = (P[None, :, :] >= P[:, None, :]).all(-1)
        gt = (P[None, :, :] > P[:, None, :]).any(-1)
        front = ~(ge & gt).any(1)
        frontf = front.to(torch.float32)
        nfront = frontf.sum().clamp_min(1.0)
        mstate = meter.set(mstate, "front_frac", mean_f32(frontf))

        inf = torch.full_like(P, math.inf)
        lo = torch.where(front[:, None], P, inf).amin(0)
        hi = torch.where(front[:, None], P, -inf).amax(0)
        zero = torch.zeros((), dtype=torch.float32, device=P.device)
        ext = torch.where((hi - lo).isfinite(), hi - lo, zero)
        mstate = meter.set(mstate, "front_spread", (ext ** 2).sum().sqrt())

        sq = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
        eye = torch.eye(k, dtype=torch.bool, device=P.device)
        pairs = front[:, None] & front[None, :] & ~eye
        nn = torch.where(pairs, sq.sqrt(), torch.full_like(sq, math.inf)
                         ).amin(1)
        nn = torch.where(nn.isfinite(), nn, zero)
        nn_mean = torch.where(front, nn, zero).sum() / nfront
        spacing = (torch.where(front, (nn - nn_mean) ** 2, zero).sum()
                   / nfront).sqrt()
        mstate = meter.set(mstate, "front_spacing", spacing)

        mstate = meter.set(mstate, "hv_proxy", _hv_slab(P, ref))

        if (self.exact_every and journal is not None and gen is not None
                and int(gen) % self.exact_every == 0):
            pts = S.cpu().numpy()
            journal.event("hv_exact", gen=int(gen),
                          value=exact_hypervolume(pts, self.ref),
                          n_points=int(pts.shape[0]))
        return mstate


# ----------------------------------------------------------- compose ----

def compose_probes(*probes: Callable) -> Probe:
    """One probe that declares and applies several in order."""

    class _Composite(Probe):
        metric_names = tuple(
            n for p in probes for n in getattr(p, "metric_names", ()))

        def declare(self, meter) -> None:
            for p in probes:
                if hasattr(p, "declare"):
                    p.declare(meter)

        def __call__(self, meter, mstate, **ctx):
            for p in probes:
                mstate = p(meter, mstate, **ctx)
            return mstate

    return _Composite()


# ======================================================= host tripwires ====

class HealthMonitor:
    """Host-side run-health tripwires over decoded meter rows.

    Feed it rows (through :class:`~deap_tpu_torch.telemetry.run.
    RunTelemetry` ``health=``, which wires it into live streaming,
    host-driven ``record_row`` and the post-loop decode) and it emits
    ``alarm`` dicts; the telemetry layer journals each as an ``alarm``
    event.

    Tripwires (each armed only when its threshold is configured):

    - ``non_finite`` — any scalar metric in the row is NaN/Inf
      (``nan_check``, on by default), or ``quarantined`` is nonzero.
    - ``clone_spike`` — clone rate above ``clone_rate_max``; reads
      ``clone_key`` (default ``gp_clone_rate``) and falls back to
      ``1 − div_unique_frac``.
    - ``premature_convergence`` — ``diversity_key`` fell below
      ``diversity_floor`` (optionally only before ``premature_min_gen``).
      Re-arms when diversity recovers.
    - ``zero_improvement`` — no ``best`` improvement beyond
      ``improvement_eps`` for ``stagnation_window`` consecutive rows
      (the row's ``stagnation_age`` where a FitnessProbe provides it).
      Re-arms after improvement.
    - ``hlo_drift`` — not row-driven: the
      :class:`~deap_tpu_torch.telemetry.costs.ProgramObservatory` calls
      :meth:`program_drift` when the same (program label, input
      signature) launches a different fingerprint of kernels (the
      JAX package's name for the alarm, kept so one report reads both).
    - ``driver_stall`` / ``canary`` — host events, fired by their
      callers through :meth:`driver_stall` / :meth:`canary`.

    ``early_stop`` names alarm kinds (or ``True`` for all) that set
    :attr:`stop_requested` — host-driven loops (the GP loop) poll it
    between generations; the other loops journal their alarms when the
    run ends. ``on_alarm`` is called with each alarm dict as it fires.
    """

    #: every alarm kind this monitor can emit
    ALARM_KINDS = ("non_finite", "clone_spike", "premature_convergence",
                   "zero_improvement", "hlo_drift", "driver_stall",
                   "canary")

    def __init__(self, *, nan_check: bool = True,
                 clone_rate_max: Optional[float] = None,
                 clone_key: str = "gp_clone_rate",
                 diversity_floor: Optional[float] = None,
                 diversity_key: str = "div_msd",
                 premature_min_gen: Optional[int] = None,
                 stagnation_window: Optional[int] = None,
                 improvement_eps: float = 0.0,
                 early_stop=(), on_alarm: Optional[Callable] = None):
        self.nan_check = bool(nan_check)
        self.clone_rate_max = clone_rate_max
        self.clone_key = clone_key
        self.diversity_floor = diversity_floor
        self.diversity_key = diversity_key
        self.premature_min_gen = premature_min_gen
        self.stagnation_window = stagnation_window
        self.improvement_eps = float(improvement_eps)
        self.early_stop = (set(self.ALARM_KINDS) if early_stop is True
                           else set(early_stop))
        self.on_alarm = on_alarm
        self.alarms: List[dict] = []
        self._best: Optional[float] = None
        self._stag = 0
        self._stag_fired = False
        self._div_fired = False
        self._stop = False

    @property
    def stop_requested(self) -> bool:
        return self._stop

    def _fire(self, kind: str, gen, **detail) -> dict:
        alarm = {"alarm": kind, "gen": gen, **detail}
        self.alarms.append(alarm)
        if kind in self.early_stop:
            self._stop = True
        if self.on_alarm is not None:
            self.on_alarm(alarm)
        return alarm

    def program_drift(self, gen=None, **detail) -> dict:
        """Fire the ``hlo_drift`` alarm — called by the
        :class:`~deap_tpu_torch.telemetry.costs.ProgramObservatory` when
        a (program, signature) pair launches a different kernel
        fingerprint."""
        return self._fire("hlo_drift", gen, **detail)

    def driver_stall(self, gen=None, **detail) -> dict:
        """Fire the ``driver_stall`` alarm (a driver that produced no
        progress heartbeat within its budget)."""
        return self._fire("driver_stall", gen, **detail)

    def canary(self, gen=None, **detail) -> dict:
        """Fire the ``canary`` alarm (a known-answer run's digest
        mismatched its reference)."""
        return self._fire("canary", gen, **detail)

    def _clone_rate(self, row) -> Optional[float]:
        v = row.get(self.clone_key)
        if v is None and "div_unique_frac" in row:
            v = 1.0 - row["div_unique_frac"]
        return v

    def check_row(self, row: Dict[str, Any],
                  gen: Optional[int] = None) -> List[dict]:
        """Run every armed tripwire on one decoded meter row; returns
        (and records) the alarms it fired."""
        if gen is None:
            gen = row.get("gen")
        fired: List[dict] = []

        if self.nan_check:
            bad = [k for k, v in row.items()
                   if isinstance(v, float) and not math.isfinite(v)]
            nq = row.get("quarantined", 0)
            if isinstance(nq, (int, float)) and nq > 0:
                bad = bad + ["quarantined"]
            if bad:
                fired.append(self._fire(
                    "non_finite", gen, metrics=bad,
                    **({"quarantined": int(nq)} if nq else {})))

        if self.clone_rate_max is not None:
            cr = self._clone_rate(row)
            if cr is not None and cr > self.clone_rate_max:
                fired.append(self._fire(
                    "clone_spike", gen, value=round(float(cr), 6),
                    threshold=self.clone_rate_max))

        if self.diversity_floor is not None:
            div = row.get(self.diversity_key)
            if div is not None and math.isfinite(div):
                early = (self.premature_min_gen is None
                         or gen is None or gen < self.premature_min_gen)
                if div < self.diversity_floor and early:
                    if not self._div_fired:
                        self._div_fired = True
                        fired.append(self._fire(
                            "premature_convergence", gen,
                            metric=self.diversity_key,
                            value=round(float(div), 6),
                            floor=self.diversity_floor))
                elif div >= self.diversity_floor:
                    self._div_fired = False  # re-arm on recovery

        if self.stagnation_window is not None:
            age = row.get("stagnation_age")
            if age is None:
                best = row.get("best")
                if best is not None and math.isfinite(best):
                    if (self._best is None
                            or best > self._best + self.improvement_eps):
                        self._best, self._stag = best, 0
                    else:
                        self._stag += 1
                age = self._stag
            if age >= self.stagnation_window:
                if not self._stag_fired:
                    self._stag_fired = True
                    fired.append(self._fire(
                        "zero_improvement", gen, age=int(age),
                        window=self.stagnation_window))
            else:
                self._stag_fired = False  # improvement re-arms
        return fired
