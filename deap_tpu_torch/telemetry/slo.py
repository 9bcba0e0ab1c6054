"""Windowed SLO curves, gates and per-phase regression attribution.

A copy of the JAX package's ``deap_tpu/telemetry/slo.py`` (standard
library only): the port keeps its own and never imports that one.

The load observatory's analysis plane (ISSUE 17): the serving stack
already journals every signal an SLO needs — per-boundary ``slo`` rows
(queue depth, segment wall seconds, cumulative arrival / shed /
deadline-miss counters), exact ``wait_s`` on every
``tenant_admitted``/``tenant_resumed`` row, and ``trace_span`` rows
with per-phase durations. This module turns those rows into:

- **windowed curves** (:func:`windowed_curve`): the journal sliced
  into fixed-width time windows, each window carrying arrival rate,
  shed rate, deadline-miss rate and exact admission / queue-wait /
  segment percentiles — a latency *curve* over the run instead of one
  end-of-run blob;
- **gates** (:class:`SloSpec`, :func:`evaluate_gates`): declarative
  pass/fail thresholds over a curve's worst window, journaled as
  ``slo_gate`` rows;
- **regression attribution** (:func:`attribute_regression`): the
  end-to-end latency delta between two runs decomposed into per-phase
  percentile deltas from the trace spans, so the report says
  "``segment`` +1.8 s at p99", not "it got slower".

Live (non-journal) consumers use the same math through
:class:`~deap_tpu_torch.telemetry.metrics.HistogramSnapshot`: snapshot a
cumulative histogram at a window's edges, ``delta()`` the pair, and
``quantile()`` the delta — cumulative-only counts cannot give
windowed percentiles, snapshots can.

Like ``report.py`` and ``metrics.py`` this module imports **nothing
but the standard library** — a box rendering SLO curves from a
shipped journal must never initialise a CUDA context
(``tests/test_torch_telemetry_copies.py`` pins the no-torch guarantee).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Optional, Sequence

__all__ = ["CURVE_METRICS", "DEFAULT_SLOS", "SLO_JOURNAL_KINDS",
           "SloSpec", "attribute_regression", "evaluate_gates",
           "exact_quantile", "phase_samples", "windowed_curve"]

#: journal kinds this plane writes (documented in the
#: docs/advanced/telemetry.md kind table; drift-gated by
#: tests/test_loadgen.py alongside SERVICE_JOURNAL_KINDS)
SLO_JOURNAL_KINDS = ("loadgen_run", "slo_gate")


def exact_quantile(samples: Sequence[float], q: float
                   ) -> Optional[float]:
    """The q-th order statistic (nearest-rank, the Prometheus
    convention's exact twin): ``None`` on no samples."""
    if not samples:
        return None
    xs = sorted(samples)
    rank = max(1, math.ceil(q * len(xs)))
    return xs[min(rank, len(xs)) - 1]


# --------------------------------------------------------- curves ----

#: the windowed-curve metric vocabulary — what :class:`SloSpec` may
#: gate on. Rates are per-window fractions; latencies are exact
#: per-window percentiles (seconds).
CURVE_METRICS = ("admission_p99", "queue_wait_p99", "segment_p99",
                 "shed_rate", "deadline_miss_rate", "arrival_rate")


def windowed_curve(rows: Iterable[Dict[str, Any]],
                   window_s: float = 1.0) -> List[Dict[str, Any]]:
    """Slice journal ``rows`` (dicts with ``t``/``kind``) into
    ``window_s``-wide windows and compute each window's SLO sample.

    Per window: ``arrivals`` (``job_submitted`` rows) and
    ``arrival_rate`` (/s), ``sheds``/``shed_rate`` (``load_shed``
    rows; rate over arrivals+sheds — offered load),
    ``deadline_misses``/``deadline_miss_rate``, ``admission_p99``
    (fresh ``tenant_admitted`` ``wait_s``), ``queue_wait_p99``
    (admissions *and* resumes — the full queue-wait distribution) and
    ``segment_p99`` (``slo`` rows' ``segment_s``). Latency fields are
    ``None`` in windows with no samples (distinguish "no data" from
    "0 s"). Windows are anchored at the first row's ``t``."""
    rows = [r for r in rows if isinstance(r.get("t"), (int, float))]
    if not rows:
        return []
    window_s = float(window_s)
    if window_s <= 0:
        raise ValueError("window_s must be positive")
    t0 = min(r["t"] for r in rows)
    t_hi = max(r["t"] for r in rows)
    n_win = max(1, int(math.floor((t_hi - t0) / window_s)) + 1)
    wins: List[Dict[str, Any]] = []
    for i in range(n_win):
        wins.append({"t0": round(t0 + i * window_s, 6),
                     "t1": round(t0 + (i + 1) * window_s, 6),
                     "arrivals": 0, "sheds": 0, "deadline_misses": 0,
                     "_adm": [], "_wait": [], "_seg": []})
    for r in rows:
        w = wins[min(n_win - 1,
                     int((r["t"] - t0) / window_s))]
        kind = r.get("kind")
        if kind == "job_submitted":
            w["arrivals"] += 1
        elif kind == "load_shed":
            w["sheds"] += int(r.get("new", 1) or 1)
        elif kind == "deadline_exceeded":
            w["deadline_misses"] += 1
        elif kind == "tenant_admitted":
            wait = r.get("wait_s")
            if wait is not None:
                w["_adm"].append(float(wait))
                w["_wait"].append(float(wait))
        elif kind == "tenant_resumed":
            wait = r.get("wait_s")
            if wait is not None:
                w["_wait"].append(float(wait))
        elif kind == "slo":
            seg = r.get("segment_s")
            if seg is not None:
                w["_seg"].append(float(seg))
    for w in wins:
        offered = w["arrivals"] + w["sheds"]
        w["arrival_rate"] = round(w["arrivals"] / window_s, 4)
        w["shed_rate"] = (round(w["sheds"] / offered, 4)
                          if offered else 0.0)
        w["deadline_miss_rate"] = (
            round(w["deadline_misses"] / max(1, w["arrivals"]), 4))
        w["admission_p99"] = exact_quantile(w.pop("_adm"), 0.99)
        w["queue_wait_p99"] = exact_quantile(w.pop("_wait"), 0.99)
        w["segment_p99"] = exact_quantile(w.pop("_seg"), 0.99)
    return wins


# ---------------------------------------------------------- gates ----

@dataclass(frozen=True)
class SloSpec:
    """One declarative SLO: gate ``metric`` (a :data:`CURVE_METRICS`
    name) at ``threshold`` over a curve's worst window. Windows with
    no samples don't count against the gate — an empty window is
    absence of evidence, not a 0-second latency."""

    name: str
    metric: str
    threshold: float
    description: str = ""

    def __post_init__(self):
        if self.metric not in CURVE_METRICS:
            raise ValueError(f"unknown SLO metric {self.metric!r}; "
                             f"expected one of {CURVE_METRICS}")

    def worst(self, curve: Sequence[Dict[str, Any]]
              ) -> Optional[float]:
        vals = [w[self.metric] for w in curve
                if w.get(self.metric) is not None]
        return max(vals) if vals else None

    def check(self, curve: Sequence[Dict[str, Any]]
              ) -> Dict[str, Any]:
        worst = self.worst(curve)
        ok = worst is None or worst <= self.threshold
        return {"slo": self.name, "metric": self.metric,
                "threshold": self.threshold,
                "worst": (round(worst, 6) if worst is not None
                          else None),
                "ok": bool(ok), "windows": len(curve)}


#: a serviceable default gate set — bench/tests tighten or loosen per
#: traffic model; thresholds here are deliberately generous so the
#: defaults only catch order-of-magnitude regressions
DEFAULT_SLOS = (
    SloSpec("admission_p99", "admission_p99", 30.0,
            "fresh submissions admitted within 30 s at p99"),
    SloSpec("queue_wait_p99", "queue_wait_p99", 60.0,
            "no tenant (incl. resumes) queued over 60 s at p99"),
    SloSpec("segment_p99", "segment_p99", 30.0,
            "scheduler segments under 30 s at p99"),
    SloSpec("shed_rate", "shed_rate", 0.05,
            "under 5% of offered load shed per window"),
    SloSpec("deadline_miss_rate", "deadline_miss_rate", 0.01,
            "under 1% of admitted arrivals miss their deadline"),
)


def evaluate_gates(curve: Sequence[Dict[str, Any]],
                   specs: Sequence[SloSpec] = DEFAULT_SLOS,
                   journal=None, **journal_ctx: Any
                   ) -> List[Dict[str, Any]]:
    """Check every spec against the curve's worst window; returns the
    gate dicts (``ok`` per spec). With a ``journal``
    (:class:`~deap_tpu_torch.telemetry.journal.RunJournal`), each gate also
    lands as one ``slo_gate`` row (plus ``journal_ctx`` — e.g. the
    traffic-model name) so the verdicts ride the same artifact as the
    evidence."""
    gates = [spec.check(curve) for spec in specs]
    if journal is not None:
        for g in gates:
            journal.event("slo_gate", **g, **journal_ctx)
    return gates


# ---------------------------------------------------- attribution ----

def _span_phase(row: Dict[str, Any]) -> Optional[str]:
    """The attribution key of one ``trace_span`` row: the scheduler's
    per-tenant ``segment`` span keeps its name (its ``phase`` label is
    ``device``, but "the segment got slower" is the operator-facing
    statement); every other span attributes to its tracing-plane
    phase, falling back to its name."""
    name = row.get("name")
    if name == "segment":
        return "segment"
    return row.get("phase") or name


def phase_samples(rows: Iterable[Dict[str, Any]]
                  ) -> Dict[str, List[float]]:
    """Per-phase duration samples from a journal's ``trace_span``
    rows (see :func:`_span_phase` for the key)."""
    out: Dict[str, List[float]] = {}
    for r in rows:
        if r.get("kind") != "trace_span":
            continue
        phase = _span_phase(r)
        dur = r.get("dur_s")
        if phase is None or dur is None:
            continue
        out.setdefault(phase, []).append(float(dur))
    return out


def _end_to_end(rows: Iterable[Dict[str, Any]]) -> List[float]:
    """Per-tenant submit→finish wall seconds from the journal's
    monotonic ``t`` stamps."""
    start: Dict[str, float] = {}
    out: List[float] = []
    for r in rows:
        tid = r.get("tenant_id")
        if tid is None or not isinstance(r.get("t"), (int, float)):
            continue
        if r.get("kind") == "job_submitted":
            start.setdefault(tid, r["t"])
        elif r.get("kind") == "tenant_finished" and tid in start:
            out.append(r["t"] - start.pop(tid))
    return out


def attribute_regression(base_rows: Sequence[Dict[str, Any]],
                         probe_rows: Sequence[Dict[str, Any]],
                         q: float = 0.99) -> Dict[str, Any]:
    """Decompose the end-to-end latency delta between two runs into
    per-phase percentile deltas.

    ``base_rows``/``probe_rows`` are two journals' rows (baseline and
    suspect run of comparable workloads). End-to-end is per-tenant
    submit→finish; phases come from the trace spans (run both with
    ``trace_sample`` on). Returns the phase table sorted by delta
    descending plus ``top_phase`` — the named culprit ("``segment``
    +1.8 s at p99"), or ``None`` when nothing regressed."""
    base_pha = phase_samples(base_rows)
    probe_pha = phase_samples(probe_rows)
    table: List[Dict[str, Any]] = []
    for phase in sorted(set(base_pha) | set(probe_pha)):
        pa = exact_quantile(base_pha.get(phase, ()), q)
        pb = exact_quantile(probe_pha.get(phase, ()), q)
        delta = (pb or 0.0) - (pa or 0.0)
        table.append({"phase": phase,
                      "base_q": (round(pa, 6) if pa is not None
                                 else None),
                      "probe_q": (round(pb, 6) if pb is not None
                                  else None),
                      "delta_s": round(delta, 6),
                      "n_base": len(base_pha.get(phase, ())),
                      "n_probe": len(probe_pha.get(phase, ()))})
    table.sort(key=lambda r: r["delta_s"], reverse=True)
    e2e_a = exact_quantile(_end_to_end(base_rows), q)
    e2e_b = exact_quantile(_end_to_end(probe_rows), q)
    top = table[0] if table and table[0]["delta_s"] > 0 else None
    return {
        "q": q,
        "end_to_end_base": (round(e2e_a, 6) if e2e_a is not None
                            else None),
        "end_to_end_probe": (round(e2e_b, 6) if e2e_b is not None
                             else None),
        "end_to_end_delta": (round(e2e_b - e2e_a, 6)
                             if None not in (e2e_a, e2e_b) else None),
        "phases": table,
        "top_phase": (top["phase"] if top else None),
        "top_delta_s": (top["delta_s"] if top else None),
    }
