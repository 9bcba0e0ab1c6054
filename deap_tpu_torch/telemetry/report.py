"""Terminal run report for any telemetry journal — **no torch import**.

A copy of the JAX package's ``deap_tpu/telemetry/report.py`` (standard
library only): the port keeps its own and never imports that one.

Renders a JSONL :class:`~deap_tpu_torch.telemetry.journal.RunJournal` into a
human-readable run-health report: header fingerprint, per-probe
sparklines over the meter rows, the alarm timeline, retrace summary and
the span p50/p99 table. This is the triage tool for a box that cannot
(or must not) initialise a backend — summarising a card run's journal on
a laptop, or inside CI where attaching the single-client runtime is
forbidden — so the module imports nothing but the standard library.

To keep that guarantee it loads ``journal.py``'s parser by file path
(the ``deap_tpu_torch`` package ``__init__`` imports torch; ``journal.py``
itself does not), and ``tests/test_torch_telemetry_copies.py`` pins
"renders a journal without torch in ``sys.modules``" in a subprocess.

Usage::

    python bench_report.py --health run.jsonl      # the wired-up entry
    python -m deap_tpu_torch.telemetry.report run.jsonl  # torch already loaded
"""

from __future__ import annotations

import importlib.util
import math
import os
import sys
from typing import Any, Dict, List, Optional

__all__ = ["render_attribution", "render_fleet", "render_report",
           "render_slo", "render_trace", "sparkline", "main"]

_SPARK = "▁▂▃▄▅▆▇█"
_MAX_SPARK = 48  # terminal budget per series

_journal_mod = None
_tracing_mod = None
_slo_mod = None
_federation_mod = None


def _journal():
    """journal.py loaded standalone (not via the package, which would
    drag in torch) — shares the exact parser, including the torn-tail
    handling."""
    global _journal_mod
    if _journal_mod is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "journal.py")
        spec = importlib.util.spec_from_file_location(
            "_deap_tpu_torch_journal_standalone", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _journal_mod = mod
    return _journal_mod


def _tracing():
    """tracing.py loaded standalone — same no-torch guarantee as
    :func:`_journal` (tracing.py is pure stdlib)."""
    global _tracing_mod
    if _tracing_mod is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "tracing.py")
        spec = importlib.util.spec_from_file_location(
            "_deap_tpu_torch_tracing_standalone", path)
        mod = importlib.util.module_from_spec(spec)
        # dataclass processing resolves cls.__module__ through
        # sys.modules — register before exec (stdlib-only, so this
        # pulls nothing else in)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _tracing_mod = mod
    return _tracing_mod


def _slo():
    """slo.py loaded standalone — same no-torch guarantee as
    :func:`_journal` (slo.py is pure stdlib)."""
    global _slo_mod
    if _slo_mod is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "slo.py")
        spec = importlib.util.spec_from_file_location(
            "_deap_tpu_torch_slo_standalone", path)
        mod = importlib.util.module_from_spec(spec)
        # dataclass processing resolves cls.__module__ through
        # sys.modules — register before exec
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _slo_mod = mod
    return _slo_mod


def _federation():
    """federation.py loaded standalone — same no-torch guarantee as
    :func:`_journal` (federation.py is pure stdlib and loads its own
    siblings by path)."""
    global _federation_mod
    if _federation_mod is None:
        path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "federation.py")
        spec = importlib.util.spec_from_file_location(
            "_deap_tpu_torch_federation_standalone", path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _federation_mod = mod
    return _federation_mod


def sparkline(values: List[float], width: int = _MAX_SPARK) -> str:
    """Unicode sparkline of a numeric series; non-finite points render
    as ``·``. Longer series are strided down to ``width`` points."""
    vals = list(values)
    if not vals:
        return ""
    if len(vals) > width:
        vals = [vals[(i * len(vals)) // width] for i in range(width)]
    finite = [v for v in vals if isinstance(v, (int, float))
              and math.isfinite(v)]
    if not finite:
        return "·" * len(vals)
    lo, hi = min(finite), max(finite)
    span = hi - lo
    out = []
    for v in vals:
        if not (isinstance(v, (int, float)) and math.isfinite(v)):
            out.append("·")
        elif span == 0:
            out.append(_SPARK[3])
        else:
            out.append(_SPARK[min(int((v - lo) / span * 8), 7)])
    return "".join(out)


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if not math.isfinite(v):
            return str(v)
        return f"{v:.6g}"
    return str(v)


def _meter_series(events: List[Dict[str, Any]]):
    """meter rows → {metric: [(gen, value), ...]} for scalar numerics
    (histogram lists are skipped — sparklines are per-scalar)."""
    series: Dict[str, List] = {}
    for e in events:
        if e.get("kind") != "meter":
            continue
        gen = e.get("gen")
        for k, v in e.items():
            if k in ("kind", "t", "gen", "tenant_id"):
                continue
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                continue
            series.setdefault(k, []).append((gen, v))
    return series


def _tenant_sections(events: List[Dict[str, Any]], out: List[str]
                     ) -> bool:
    """Multi-tenant serving journals: group meter/alarm/lifecycle rows
    by ``tenant_id`` and render one per-tenant block (metric
    sparklines + that tenant's alarm timeline), plus the scheduler's
    admission/eviction ledger. Tenant blocks are grouped by loop
    **family** (from the ``job_submitted`` rows) so GP / island /
    scan-family lanes read as separate cohorts. Returns True when the
    journal was multi-tenant (the caller then skips the single-run
    sections that would interleave tenants)."""
    tenants: Dict[str, List[Dict[str, Any]]] = {}
    families: Dict[str, str] = {}
    for e in events:
        tid = e.get("tenant_id")
        if tid is not None:
            tenants.setdefault(str(tid), []).append(e)
            if e.get("kind") == "job_submitted" and "family" in e:
                families[str(tid)] = str(e["family"])
    if not tenants:
        return False

    prewarms = [e for e in events if e.get("kind") == "prewarm"]
    if prewarms:
        total = sum(e.get("compile_s", 0.0) for e in prewarms)
        out.append(f"- prewarm: {len(prewarms)} bucket program(s), "
                   f"{total:.3f}s compiling")
    segs = [e for e in events if e.get("kind") == "segment"
            and "tenant_id" not in e]
    if segs:
        out.append(f"- {len(segs)} scheduler segment(s)")

    out.append("")
    out.append(f"## Tenants ({len(tenants)})")
    by_family: Dict[str, List[str]] = {}
    for tid in sorted(tenants):
        by_family.setdefault(families.get(tid, "?"), []).append(tid)
    for family in sorted(by_family):
        if len(by_family) > 1 or family != "?":
            out.append("")
            out.append(f"### family {family} "
                       f"({len(by_family[family])} tenant(s))")
        for tid in by_family[family]:
            rows = tenants[tid]
            out.append("")
            out.append(f"#### tenant {tid}")
            life = {k: sum(1 for e in rows if e.get("kind") == k)
                    for k in ("tenant_admitted", "tenant_evicted",
                              "tenant_resumed", "tenant_finished")}
            fin = next((e for e in rows
                        if e.get("kind") == "tenant_finished"), None)
            bits = [f"evicted×{life['tenant_evicted']}"
                    if life["tenant_evicted"] else None,
                    f"resumed×{life['tenant_resumed']}"
                    if life["tenant_resumed"] else None]
            status = (f"{fin.get('status', 'finished')} at gen "
                      f"{fin.get('gen')}" if fin else "in flight")
            out.append("- " + ", ".join(
                [status] + [b for b in bits if b]))
            series = _meter_series(rows)
            if series:
                width = max(len(k) for k in series)
                for name in sorted(series):
                    vals = [v for _, v in series[name]]
                    out.append(
                        f"{name.ljust(width)}  {sparkline(vals)}  "
                        f"min={_fmt(min(vals))} "
                        f"max={_fmt(max(vals))} "
                        f"last={_fmt(vals[-1])}")
            alarms = [e for e in rows if e.get("kind") == "alarm"]
            for a in alarms:
                detail = ", ".join(
                    f"{k}={_fmt(v)}" for k, v in a.items()
                    if k not in ("kind", "t", "alarm", "gen",
                                 "tenant_id"))
                out.append(
                    f"- gen {a.get('gen')} ▲ **{a.get('alarm')}**"
                    + (f" ({detail})" if detail else ""))
    return True


def _fmt_bytes(n: Any) -> str:
    if not isinstance(n, (int, float)):
        return "?"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return (f"{n:.0f} {unit}" if unit == "B"
                    else f"{n:.2f} {unit}")
        n /= 1024
    return "?"


def _program_table(events: List[Dict[str, Any]], out: List[str]
                   ) -> None:
    """The program-observatory plane: one row per ``program_profile``
    event — what XLA actually built (flops / bytes / compile time) and
    whether the donation contract held (aliased bytes)."""
    profiles = [e for e in events if e.get("kind") == "program_profile"]
    if not profiles:
        return
    out.append("")
    out.append(f"## Programs ({len(profiles)} compiled)")
    out.append("")
    out.append("| program | hlo | flops | bytes accessed | "
               "aliased (donated) | compile s |")
    out.append("|---|---|---|---|---|---|")
    for p in profiles:
        flops = p.get("flops")
        byt = p.get("bytes_accessed")
        aliased = p.get("aliased_bytes")
        don = " ▲ donating but 0 aliased" if (
            p.get("donating") and not aliased) else ""
        out.append(
            f"| {p.get('label')} | {str(p.get('hlo_hash'))[:8]} | "
            f"{_fmt(flops) if flops is not None else '?'} | "
            f"{_fmt_bytes(byt)} | {_fmt_bytes(aliased)}{don} | "
            f"{_fmt(p.get('compile_s'))} |")
    errors = [e for e in events
              if e.get("kind") == "program_profile_error"]
    for e in errors:
        out.append(f"- ▲ profile failed for {e.get('label')}: "
                   f"{e.get('error')}")
    drift = [e for e in events if e.get("kind") == "alarm"
             and e.get("alarm") == "hlo_drift"]
    for e in drift:
        out.append(f"- ▲ **hlo_drift**: {e.get('program')} recompiled "
                   f"{e.get('prev_hlo_hash')} → {e.get('hlo_hash')} "
                   "(same input signature — silent retrace regression)")


def _slo_section(events: List[Dict[str, Any]], out: List[str]) -> None:
    """Scheduler SLO timeline from the per-boundary ``slo`` samples:
    queue depth / occupancy / gens-per-sec sparklines per bucket plus
    the eviction ledger."""
    slos = [e for e in events if e.get("kind") == "slo"]
    if not slos:
        return
    buckets: Dict[str, List[Dict[str, Any]]] = {}
    for e in slos:
        buckets.setdefault(str(e.get("bucket", "?")), []).append(e)
    out.append("")
    out.append("## Scheduler SLO (per segment boundary)")
    for name in sorted(buckets):
        rows = buckets[name]
        out.append("")
        out.append(f"### bucket {name} ({len(rows)} segments)")
        for metric, label in (("queue_depth", "queue depth"),
                              ("occupancy", "occupancy"),
                              ("gens_per_sec", "gens/s")):
            vals = [e.get(metric) for e in rows
                    if isinstance(e.get(metric), (int, float))]
            if vals:
                out.append(f"{label.ljust(12)} {sparkline(vals)}  "
                           f"min={_fmt(min(vals))} "
                           f"max={_fmt(max(vals))} "
                           f"last={_fmt(vals[-1])}")
        waits = [e.get("segment_s") for e in rows
                 if isinstance(e.get("segment_s"), (int, float))]
        if waits:
            s = sorted(waits)
            out.append(
                f"segment wall  p50={_fmt(s[(len(s) - 1) // 2])}s "
                f"p99={_fmt(s[min(len(s) - 1, int(0.99 * (len(s) - 1)))])}s"
                f" max={_fmt(s[-1])}s")
    evicted = [e for e in events if e.get("kind") == "tenant_evicted"]
    resumed = [e for e in events if e.get("kind") == "tenant_resumed"]
    if evicted or resumed:
        out.append("")
        out.append(f"- swap ledger: {len(evicted)} eviction(s), "
                   f"{len(resumed)} resume(s)")
        for e in evicted[:10]:
            out.append(f"  - gen {e.get('gen')}: {e.get('tenant_id')} "
                       "evicted (checkpoint swap unit)")


def _loadgen_section(events: List[Dict[str, Any]], out: List[str]
                     ) -> None:
    """Load-observatory evidence: the ``loadgen_run`` rows (one per
    generated traffic run) and the ``slo_gate`` verdict table the run
    journaled next to them."""
    runs = [e for e in events if e.get("kind") == "loadgen_run"]
    gates = [e for e in events if e.get("kind") == "slo_gate"]
    if not (runs or gates):
        return
    out.append("")
    out.append("## Load observatory")
    _restart_keys = ("restart_t", "restart_ready_t",
                     "time_to_first_result_after_restart_s")
    for e in runs:
        tallies = ", ".join(
            f"{k}×{v}" for k, v in sorted(e.items())
            if k not in ("kind", "t", "model", "seed", "speed",
                         "n_arrivals", "planned_s", "wall_s")
            and k not in _restart_keys)
        out.append(f"- loadgen {e.get('model')} (seed "
                   f"{e.get('seed')}, ×{_fmt(e.get('speed', 1.0))}): "
                   f"{e.get('n_arrivals')} arrival(s) over "
                   f"{_fmt(e.get('wall_s'))}s "
                   f"(planned {_fmt(e.get('planned_s'))}s)"
                   + (f" — {tallies}" if tallies else ""))
        if e.get("restart_t") is not None:
            rt, ready = e.get("restart_t"), e.get("restart_ready_t")
            first = e.get("time_to_first_result_after_restart_s")
            outage = (_fmt(ready - rt)
                      if isinstance(ready, (int, float))
                      and isinstance(rt, (int, float)) else "?")
            out.append(
                f"  - restart drill: killed at t={_fmt(rt)}s, "
                f"serving again at t={_fmt(ready)}s "
                f"(outage {outage}s), first result "
                + (f"+{_fmt(first)}s after the kill"
                   if first is not None else
                   "never landed after the kill ▲"))
    if gates:
        bad = [g for g in gates if not g.get("ok")]
        out.append(f"- SLO gates: {len(gates) - len(bad)}/{len(gates)} "
                   "green" + (" — **breaches:**" if bad else ""))
        for g in bad:
            out.append(f"  - ▲ {g.get('slo')}: worst "
                       f"{_fmt(g.get('worst'))} > threshold "
                       f"{_fmt(g.get('threshold'))}")


def _startup_section(events: List[Dict[str, Any]], out: List[str]
                     ) -> None:
    """Startup ledger: the ``startup_phase`` waterfall a restarted
    service journals (wal_replay → restore → prewarm → first_result)
    plus the artifact-store hit/miss tally — together they answer
    "where did the cold start go" without attaching a profiler."""
    phases = [e for e in events if e.get("kind") == "startup_phase"]
    hits = [e for e in events if e.get("kind") == "artifact_hit"]
    misses = [e for e in events if e.get("kind") == "artifact_miss"]
    if not (phases or hits or misses):
        return
    out.append("")
    out.append("## Startup ledger")
    if phases:
        # journal order IS wall order (each phase notes its duration
        # as it completes); a bar per phase scaled to the longest
        longest = max(float(e.get("seconds", 0.0)) for e in phases)
        total = 0.0
        for e in phases:
            s = float(e.get("seconds", 0.0))
            total += s
            width = (int(round(s / longest * 24))
                     if longest > 0 else 0)
            out.append(f"- {str(e.get('phase', '?')).ljust(14)} "
                       f"{_fmt(s)}s {'█' * max(width, 1)}")
        out.append(f"- startup phases total: {_fmt(total)}s "
                   "(traffic was held until prewarm finished — "
                   "`/healthz` served 503 `warming`)")
    if hits or misses:
        n = len(hits) + len(misses)
        saved = sum(float(e.get("deserialize_s", 0.0)) for e in hits)
        out.append(f"- executable artifact store: {len(hits)}/{n} "
                   f"hit(s) ({_fmt(saved)}s deserializing instead of "
                   "compiling)")
        reasons: Dict[str, int] = {}
        for e in misses:
            r = str(e.get("reason", "?"))
            reasons[r] = reasons.get(r, 0) + 1
        if reasons:
            out.append("  - misses: " + ", ".join(
                f"{k}×{v}" for k, v in sorted(reasons.items())))


def _service_section(events: List[Dict[str, Any]], out: List[str]
                     ) -> None:
    """Service-plane timeline: the autoscaler's applied decisions
    (lane moves, prewarms, spills), the auth-rejection tally, the
    graceful-drain ledger — and the ISSUE 12 fault plane: WAL
    replays, idempotent-retry hits, deadline drops, load sheds,
    driver stalls and the request-id trace index."""
    decisions = [e for e in events
                 if e.get("kind") == "autoscale_decision"]
    rejections = [e for e in events
                  if e.get("kind") == "auth_rejected"]
    drains = [e for e in events if e.get("kind") == "service_drain"]
    wal = [e for e in events if e.get("kind") == "wal_replay"]
    idem = [e for e in events
            if e.get("kind") == "idempotent_replay"]
    deads = [e for e in events
             if e.get("kind") == "deadline_exceeded"]
    sheds = [e for e in events if e.get("kind") == "load_shed"]
    stalls = [e for e in events if e.get("kind") == "driver_stall"]
    traced = [e for e in events if e.get("request_id")]
    if not (decisions or rejections or drains or wal or idem
            or deads or sheds or stalls):
        return
    out.append("")
    out.append("## Service plane")
    if decisions:
        lanes = [e for e in decisions if e.get("action") == "lanes"]
        pw = [e for e in decisions if e.get("action") == "prewarm"]
        sp = [e for e in decisions if e.get("action") == "spill"]
        out.append(f"- autoscaler: {len(lanes)} lane move(s), "
                   f"{len(pw)} prewarm(s), {len(sp)} spill(s)")
        for e in lanes[:10]:
            out.append(f"  - t={e.get('t')}s {e.get('bucket')}: "
                       f"{e.get('lanes_from')} → {e.get('lanes_to')} "
                       f"lanes (queue={e.get('queue_depth')}, "
                       f"wait_p99={_fmt(e.get('queue_wait_p99'))})")
    if rejections:
        reasons: Dict[str, int] = {}
        for e in rejections:
            r = str(e.get("reason", "?"))
            reasons[r] = reasons.get(r, 0) + 1
        out.append("- auth rejections: " + ", ".join(
            f"{k}×{v}" for k, v in sorted(reasons.items())))
    for e in drains:
        out.append(f"- drain at t={e.get('t')}s: "
                   f"{len(e.get('checkpointed', []))} tenant(s) "
                   f"checkpointed, "
                   f"{len(e.get('open_tenants', []))} stream(s) "
                   "notified")
    for e in wal:
        out.append(f"- WAL replay at t={e.get('t')}s: "
                   f"{len(e.get('replayed', []))} tenant(s) replayed "
                   f"of {e.get('records', '?')} record(s)"
                   + (", torn tail healed"
                      if e.get("torn_tail") else "")
                   + (f", {len(e['failed'])} failed"
                      if e.get("failed") else ""))
    if idem or deads or sheds:
        out.append(f"- fault plane: {len(idem)} idempotent "
                   f"replay(s), {len(deads)} deadline drop(s), "
                   f"{len(sheds)} load shed(s)")
    if stalls:
        fired = [e for e in stalls if "stalled_s" in e]
        rec = [e for e in stalls if e.get("recovered")]
        worst = max((e["stalled_s"] for e in fired), default=None)
        out.append(f"- driver stalls: {len(fired)} fired / "
                   f"{len(rec)} recovered"
                   + (f" (worst {_fmt(worst)}s)" if worst else ""))
        for e in fired[:3]:
            tail = [ln for ln in str(e.get("stack", ""))
                    .strip().splitlines() if ln.strip()]
            out.append(f"  - t={e.get('t')}s stalled "
                       f"{_fmt(e.get('stalled_s'))}s at step "
                       f"{e.get('steps')}: "
                       f"{tail[-1].strip() if tail else '?'}")
    if traced:
        rids: Dict[str, int] = {}
        for e in traced:
            r = str(e.get("request_id"))
            rids[r] = rids.get(r, 0) + 1
        sample = next((r for r, n in rids.items() if n > 1),
                      next(iter(rids)))
        path = [str(e.get("kind")) for e in traced
                if str(e.get("request_id")) == sample]
        out.append(f"- request tracing: {len(traced)} row(s) across "
                   f"{len(rids)} request id(s); e.g. {sample}: "
                   + " → ".join(path[:8]))


def _memory_section(events: List[Dict[str, Any]], out: List[str]
                    ) -> None:
    """Flight-recorder device-memory trajectory: live device bytes per
    boundary as a sparkline, plus the captured trace/pprof artifact
    paths."""
    mems = [e for e in events if e.get("kind") == "device_memory"]
    traces = [e for e in events if e.get("kind") == "flight_trace"]
    if not mems and not traces:
        return
    out.append("")
    out.append("## Flight recorder")
    if mems:
        vals, steps = [], []
        for e in mems:
            live = e.get("live_bytes")
            if isinstance(live, dict):
                vals.append(sum(v for v in live.values()
                                if isinstance(v, (int, float))))
                steps.append(e.get("step"))
        if vals:
            out.append(
                f"device memory  {sparkline(vals)}  "
                f"min={_fmt_bytes(min(vals))} "
                f"max={_fmt_bytes(max(vals))} "
                f"last={_fmt_bytes(vals[-1])} "
                f"({len(vals)} boundary snapshots, steps "
                f"{steps[0]}–{steps[-1]})")
        pprofs = [e.get("profile_path") for e in mems
                  if e.get("profile_path")]
        if pprofs:
            out.append(f"- {len(pprofs)} pprof snapshot(s), first: "
                       f"{pprofs[0]}")
    for e in traces:
        out.append(f"- xplane trace of segment [{e.get('lo')}, "
                   f"{e.get('hi')}): {e.get('dir')}")


def _tuning_section(events: List[Dict[str, Any]], out: List[str]
                    ) -> None:
    """Tuning ledger — the dispatch tuner's journaled decisions
    (``tuning_decision``: per-key winner, decision source, probe cost,
    cache hits) and any drift evictions (``tuning_invalidation`` — a
    program recompiled to a different HLO, so its measured winners
    were discarded). Rendered for solo and multi-tenant journals
    alike: a stale or identity-failed dispatch choice is a
    whole-process property."""
    decisions = [e for e in events if e.get("kind") == "tuning_decision"]
    evictions = [e for e in events
                 if e.get("kind") == "tuning_invalidation"]
    if not decisions and not evictions:
        return
    out.append("")
    out.append("## Tuning ledger")
    out.append("")
    last: Dict[tuple, Dict[str, Any]] = {}
    hits: Dict[tuple, int] = {}
    for e in decisions:
        key = (str(e.get("knob", "?")), str(e.get("bucket", "")))
        last[key] = e
        if e.get("cache_hit"):
            hits[key] = hits.get(key, 0) + 1
    out.append("| knob | bucket | winner | source | probe s "
               "| cache hits |")
    out.append("|---|---|---|---|---|---|")
    for key in sorted(last):
        e = last[key]
        probe = e.get("probe_s")
        out.append(f"| {key[0]} | {key[1] or '—'} "
                   f"| {e.get('winner', '?')} | {e.get('source', '?')} "
                   f"| {_fmt(probe) if probe is not None else '—'} "
                   f"| {hits.get(key, 0)} |")
    failed = [e for e in decisions if e.get("identity") == "failed"]
    if failed:
        out.append(f"- ▲ {len(failed)} probe(s) failed the candidate "
                   "identity check — static default kept")
    for e in evictions:
        out.append(f"- drift eviction: {e.get('key')} (program "
                   f"{e.get('program')}, {e.get('reason')})")


def render_report(path: str, lines: Optional[List[str]] = None) -> str:
    """The full report as one string (also returned line-by-line into
    ``lines`` when given — bench_report prints as it renders)."""
    out: List[str] = [] if lines is None else lines
    events = _journal().read_journal(path)

    out.append(f"# Run report: {os.path.basename(path)}")
    out.append("")
    if getattr(events, "tear_offset", None) is not None:
        out.append(f"**torn tail** at byte {events.tear_offset} — the "
                   "writer was killed mid-line; rows below are the "
                   "complete prefix")
    if getattr(events, "skipped_offsets", None):
        out.append(f"{len(events.skipped_offsets)} malformed interior "
                   f"line(s) skipped (byte offsets "
                   f"{events.skipped_offsets[:5]}…)")

    header = next((e for e in events if e.get("kind") == "header"), None)
    if header is not None:
        env = header.get("env", {})
        out.append("- env: " + ", ".join(
            f"{k}={v}" for k, v in env.items()))
        if "toolbox" in header:
            out.append("- toolbox digest: "
                       f"{header['toolbox'].get('digest')}")
    runs = [e for e in events if e.get("kind") == "run_start"]
    if runs:
        out.append("- runs: " + ", ".join(
            str(e.get("algorithm", "?")) for e in runs))

    retraces = [e for e in events if e.get("kind") == "retrace"]
    compiles = [e for e in events if e.get("kind") == "compile"]
    line = (f"- compiles: {len(compiles)}"
            f", retraces after steady: {len(retraces)}")
    if retraces:
        line += (f" (**{sum(e.get('dur_s', 0.0) for e in retraces):.3f}s"
                 " recompiling — investigate shape/closure churn**)")
    out.append(line)

    # which execution the variation plane resolved to (fused kernel /
    # fused XLA / unfused composition; GP compaction device vs host) —
    # a fallback here is the run silently not using the fast path
    dispatches = [e for e in events
                  if e.get("kind") == "variation_dispatch"]
    if dispatches:
        counts: dict = {}
        for e in dispatches:
            key = (str(e.get("op", "?")), str(e.get("path", "?")))
            counts[key] = counts.get(key, 0) + 1
        out.append("- variation dispatch: " + ", ".join(
            f"{op}→{path}×{c}"
            for (op, path), c in sorted(counts.items())))
        fallbacks = [e for e in dispatches if e.get("path") == "unfused"
                     and e.get("reason") not in (None, "disabled")]
        if fallbacks:
            out.append(f"  - ▲ {len(fallbacks)} fused-plane fallback(s):"
                       f" {fallbacks[0].get('reason')}")

    # ------------------------------------------------- tuning ledger ----
    _tuning_section(events, out)

    # ----------------------------------------- multi-tenant journals ----
    if _tenant_sections(events, out):
        # per-tenant blocks replace the single-run meter/alarm
        # sections (which would interleave tenants); the scheduler-
        # wide planes (SLO timeline, compiled programs, flight
        # recorder) and the summary still apply to the process
        _slo_section(events, out)
        _loadgen_section(events, out)
        _startup_section(events, out)
        _service_section(events, out)
        _program_table(events, out)
        _memory_section(events, out)
        summary = next((e for e in reversed(events)
                        if e.get("kind") == "summary"), None)
        if summary is not None:
            out.append("")
            out.append("## Summary")
            out.append("- " + ", ".join(
                f"{k}={_fmt(v)}" for k, v in summary.items()
                if k not in ("kind", "t")))
        return "\n".join(out)

    # ------------------------------------------------ probe sparklines ----
    series = _meter_series(events)
    if series:
        out.append("")
        out.append("## Metrics (per generation)")
        out.append("")
        width = max(len(k) for k in series)
        for name in sorted(series):
            pts = series[name]
            vals = [v for _, v in pts]
            out.append(f"{name.ljust(width)}  {sparkline(vals)}  "
                       f"min={_fmt(min(vals))} max={_fmt(max(vals))} "
                       f"last={_fmt(vals[-1])}")

    # ------------------------------------------- resilience timeline ----
    segs = [e for e in events if e.get("kind") == "segment"]
    resumed = [e for e in events if e.get("kind") == "resumed"]
    preempted = [e for e in events if e.get("kind") == "preempted"]
    degraded = [e for e in events if e.get("kind") == "degraded"]
    corrupt = [e for e in events
               if e.get("kind") == "checkpoint_corrupt"]
    quarantine = [e for e in events if e.get("kind") == "quarantine"]
    if segs or resumed or preempted or degraded or corrupt:
        out.append("")
        out.append("## Resilience (segments / recoveries)")
        out.append("")
        if resumed:
            # run-id chaining: each resume names the run it continues,
            # so a preempted run's journals stitch into one timeline
            chain = " → ".join(
                [str(resumed[0].get("resumed_from"))]
                + [str(e.get("run_id")) for e in resumed])
            out.append(f"- run chain: {chain}")
            for e in resumed:
                out.append(f"- resumed at gen {e.get('step')} from run "
                           f"{e.get('resumed_from')}")
        if segs:
            lo = min(e.get("lo", 0) for e in segs)
            hi = max(e.get("hi", 0) for e in segs)
            out.append(f"- {len(segs)} segment(s) covering gens "
                       f"[{lo}, {hi}]")
        for e in preempted:
            out.append(f"- ▲ **preempted** at gen {e.get('step')} "
                       f"(signal {e.get('signum')}) — checkpoint saved, "
                       "clean exit")
        for e in degraded:
            out.append(
                f"- ▲ **degraded** segment [{e.get('lo')}, "
                f"{e.get('hi')}): {e.get('error_kind')} attempt "
                f"{e.get('attempt')}, backoff {e.get('backoff_s')}s"
                + (f", action: {e['action']}" if e.get("action") else ""))
        for e in corrupt:
            out.append(f"- ▲ **corrupt checkpoint** skipped: "
                       f"{os.path.basename(str(e.get('path', '?')))}")
        if quarantine:
            total = sum(e.get("n", 0) for e in quarantine)
            out.append(f"- {total} non-finite evaluation(s) quarantined "
                       f"across {len(quarantine)} event(s)")

    hv = [e for e in events if e.get("kind") == "hv_exact"]
    if hv:
        out.append("")
        out.append("## Exact hypervolume samples (host, native)")
        for e in hv:
            out.append(f"- gen {e.get('gen')}: {_fmt(e.get('value'))} "
                       f"({e.get('n_points')} sampled points)")

    # ----------------------------------------------------- alarm timeline ----
    alarms = [e for e in events if e.get("kind") == "alarm"]
    out.append("")
    out.append(f"## Alarms ({len(alarms)})")
    out.append("")
    if alarms:
        for a in alarms:
            detail = ", ".join(
                f"{k}={_fmt(v)}" for k, v in a.items()
                if k not in ("kind", "t", "alarm", "gen"))
            out.append(f"- gen {a.get('gen')} ▲ **{a.get('alarm')}**"
                       + (f" ({detail})" if detail else ""))
    else:
        out.append("- none — no tripwire fired (or no HealthMonitor "
                   "was attached)")

    # --------------------------------------------------------- span table ----
    spans = [e for e in events if e.get("kind") == "span"]
    if spans:
        out.append("")
        out.append("## Spans (host wall time)")
        out.append("")
        out.append("| span | count | total s | p50 s | p99 s |")
        out.append("|---|---|---|---|---|")
        for s in sorted(spans, key=lambda s: -s.get("total_s", 0)):
            out.append(
                f"| {s.get('name')} | {s.get('count')} | "
                f"{s.get('total_s', 0):.6f} | {s.get('p50_s', 0):.6f} | "
                f"{s.get('p99_s', 0):.6f} |")

    summary = next((e for e in reversed(events)
                    if e.get("kind") == "summary"), None)
    if summary is not None:
        out.append("")
        out.append("## Summary")
        out.append("- " + ", ".join(
            f"{k}={_fmt(v)}" for k, v in summary.items()
            if k not in ("kind", "t")))
    return "\n".join(out)


# ------------------------------------------------- trace waterfall ----

_BAR_WIDTH = 40  # terminal budget for the waterfall gutter


def _trace_groups(path: str):
    """All generations of the journal at ``path`` (rotated ``.N``
    predecessors from kill-9 restarts, oldest first, then the live
    file) parsed into ``(header_row_or_None, rows)`` pairs — the
    shape :func:`tracing.assemble_trace` stitches across."""
    jm = _journal()
    groups = []
    for p in jm.journal_generations(path):
        rows = jm.read_journal(p, strict=False)
        header = next((e for e in rows
                       if e.get("kind") == "header"), None)
        groups.append((header, rows))
    return groups


def _resolve_request_id(groups, ident: str) -> Optional[str]:
    """``--trace`` accepts either a request id or a tenant id; tenant
    ids resolve through the ``job_submitted``/``trace_span`` rows that
    carry both."""
    for _, rows in groups:
        for e in rows:
            if e.get("request_id") == ident:
                return ident
    for _, rows in groups:
        for e in rows:
            if (e.get("tenant_id") == ident and e.get("request_id")):
                return str(e["request_id"])
    return None


def _waterfall(spans: List[Dict[str, Any]], out: List[str]) -> None:
    lo = min(s["start"] for s in spans)
    hi = max(s["end"] for s in spans)
    total = max(hi - lo, 1e-9)
    name_w = max(len(str(s.get("name", "?"))) for s in spans)
    for s in spans:
        a = int((s["start"] - lo) / total * _BAR_WIDTH)
        b = int((s["end"] - lo) / total * _BAR_WIDTH)
        b = max(b, a + 1)
        bar = " " * a + "█" * (b - a) + " " * (_BAR_WIDTH - b)
        extra = []
        if s.get("phase"):
            extra.append(str(s["phase"]))
        if s.get("tenant_id"):
            extra.append(f"tenant={s['tenant_id']}")
        if s.get("hlo_hash"):
            extra.append(f"hlo={str(s['hlo_hash'])[:8]}")
        if s.get("gen") is not None:
            extra.append(f"gen={s['gen']}")
        if s.get("synthetic"):
            extra.append("synthetic")
        for link in s.get("links") or []:
            if isinstance(link, dict) and link.get("xplane_dir"):
                extra.append(f"xplane={link['xplane_dir']}")
        out.append(
            f"{str(s.get('name', '?')).ljust(name_w)} |{bar}| "
            f"+{s['start'] - lo:8.3f}s {s.get('dur_s', 0.0):9.4f}s"
            + (f"  ({', '.join(extra)})" if extra else ""))


def render_trace(path: str, ident: str,
                 perfetto_out: Optional[str] = None) -> str:
    """The span waterfall for one request (or tenant) id, stitched
    across every generation of the journal at ``path`` — the
    ``report.py --trace`` view. With ``perfetto_out`` the assembled
    spans are also written as Chrome/Perfetto trace-event JSON."""
    tr = _tracing()
    if os.path.isdir(path):
        path = os.path.join(path, "journal.jsonl")
    groups = _trace_groups(path)
    out: List[str] = []
    rid = _resolve_request_id(groups, ident)
    if rid is None:
        return (f"no journal row carries request or tenant id "
                f"{ident!r} under {path} — was the service started "
                "with trace_sample set?")
    trace = tr.assemble_trace(groups, tr.trace_id_for(rid))
    spans = trace["spans"]
    if not spans:
        return (f"request {rid}: no trace_span rows for trace "
                f"{trace['trace_id']} — was trace_sample set?")

    out.append(f"# Trace {trace['trace_id']}")
    out.append("")
    out.append(f"- request id: {rid}")
    if ident != rid:
        out.append(f"- resolved from tenant id: {ident}")
    if len(groups) > 1:
        out.append(f"- stitched across {len(groups)} journal "
                   "generation(s) (restart/rotation)")
    lo = min(s["start"] for s in spans)
    hi = max(s["end"] for s in spans)
    out.append(f"- {len(spans)} span(s), {hi - lo:.3f}s end to end")
    if trace["orphans"]:
        out.append(f"- ▲ {len(trace['orphans'])} orphan span(s) "
                   "(parent row missing — lost journal generation?)")
    out.append("")
    out.append("## Waterfall")
    out.append("")
    _waterfall(spans, out)

    # per-phase latency decomposition: where the request's wall time
    # actually went (phases overlap the root span, so the column sums
    # against the end-to-end wall, not to it)
    phases: Dict[str, List[float]] = {}
    for s in spans:
        if s.get("phase"):
            phases.setdefault(str(s["phase"]), []).append(
                float(s.get("dur_s", 0.0) or 0.0))
    if phases:
        out.append("")
        out.append("## Phase latency")
        out.append("")
        out.append("| phase | spans | total s | % of wall |")
        out.append("|---|---|---|---|")
        order = list(getattr(tr, "PHASES", ())) + sorted(
            k for k in phases if k not in getattr(tr, "PHASES", ()))
        wall = max(hi - lo, 1e-9)
        for ph in order:
            if ph not in phases:
                continue
            tot = sum(phases[ph])
            out.append(f"| {ph} | {len(phases[ph])} | {tot:.4f} | "
                       f"{100.0 * tot / wall:.1f}% |")

    if perfetto_out:
        tr.write_perfetto(perfetto_out, spans)
        out.append("")
        out.append(f"- perfetto export: {perfetto_out} "
                   "(open at ui.perfetto.dev)")
    return "\n".join(out)


def _fmt_opt(v: Any) -> str:
    return "—" if v is None else _fmt(v)


def render_slo(path: str, window_s: float = 1.0) -> str:
    """The windowed SLO-curve table + gate verdicts for one journal —
    the ``report.py --slo`` view (stdlib-only, like the health
    report)."""
    sl = _slo()
    if os.path.isdir(path):
        path = os.path.join(path, "journal.jsonl")
    events = _journal().read_journal(path)
    curve = sl.windowed_curve(events, window_s=window_s)
    out: List[str] = []
    out.append(f"# SLO curves: {os.path.basename(path)}")
    out.append("")
    if not curve:
        out.append("- no timestamped rows — nothing to window")
        return "\n".join(out)
    out.append(f"- {len(curve)} window(s) of {_fmt(window_s)}s")
    out.append("")
    out.append("| window | arrivals/s | shed | ddl miss | adm p99 s "
               "| wait p99 s | seg p99 s |")
    out.append("|---|---|---|---|---|---|---|")
    for w in curve:
        out.append(
            f"| {_fmt(w['t0'])}–{_fmt(w['t1'])} "
            f"| {_fmt(w['arrival_rate'])} "
            f"| {_fmt(w['shed_rate'])} "
            f"| {_fmt(w['deadline_miss_rate'])} "
            f"| {_fmt_opt(w['admission_p99'])} "
            f"| {_fmt_opt(w['queue_wait_p99'])} "
            f"| {_fmt_opt(w['segment_p99'])} |")
    out.append("")
    out.append("## Gates (worst window vs threshold)")
    out.append("")
    out.append("| gate | metric | threshold | worst | verdict |")
    out.append("|---|---|---|---|---|")
    for g in sl.evaluate_gates(curve):
        out.append(f"| {g['slo']} | {g['metric']} "
                   f"| {_fmt(g['threshold'])} | {_fmt_opt(g['worst'])} "
                   f"| {'ok' if g['ok'] else '**FAIL**'} |")
    drills = [e for e in events if e.get("kind") == "loadgen_run"
              and e.get("restart_t") is not None]
    if drills:
        out.append("")
        out.append("## Restart drill")
        out.append("")
        for e in drills:
            first = e.get("time_to_first_result_after_restart_s")
            out.append(
                f"- {e.get('model')}: service killed at "
                f"t={_fmt(e.get('restart_t'))}s, serving again at "
                f"t={_fmt_opt(e.get('restart_ready_t'))}s; first "
                "result landed "
                + (f"{_fmt(first)}s after the kill"
                   if first is not None
                   else "**never** after the kill"))
    return "\n".join(out)


def render_attribution(base_path: str, probe_path: str,
                       q: float = 0.99) -> str:
    """Per-phase regression attribution between two journals (base,
    probe) — the two-journal form of ``report.py --slo``."""
    sl = _slo()
    jm = _journal()
    paths = []
    for p in (base_path, probe_path):
        if os.path.isdir(p):
            p = os.path.join(p, "journal.jsonl")
        paths.append(p)
    base = jm.read_journal(paths[0])
    probe = jm.read_journal(paths[1])
    att = sl.attribute_regression(base, probe, q=q)
    out: List[str] = []
    out.append(f"# Regression attribution (p{int(q * 100)}): "
               f"{os.path.basename(paths[0])} → "
               f"{os.path.basename(paths[1])}")
    out.append("")
    out.append(f"- end to end: {_fmt_opt(att['end_to_end_base'])}s → "
               f"{_fmt_opt(att['end_to_end_probe'])}s "
               f"(Δ {_fmt_opt(att['end_to_end_delta'])}s)")
    if att["top_phase"]:
        out.append(f"- **top regressing phase: {att['top_phase']} "
                   f"+{_fmt(att['top_delta_s'])}s**")
    else:
        out.append("- no phase regressed")
    if att["phases"]:
        out.append("")
        out.append("| phase | base s | probe s | Δ s | n base "
                   "| n probe |")
        out.append("|---|---|---|---|---|---|")
        for row in att["phases"]:
            out.append(f"| {row['phase']} | {_fmt_opt(row['base_q'])} "
                       f"| {_fmt_opt(row['probe_q'])} "
                       f"| {_fmt(row['delta_s'])} | {row['n_base']} "
                       f"| {row['n_probe']} |")
    else:
        out.append("- no trace_span rows in either journal — run the "
                   "service with trace_sample set")
    return "\n".join(out)


def render_fleet(root: str, window_s: float = 1.0) -> str:
    """The fleet observatory view (``report.py --fleet``): every
    registered process's journal generations merged into one
    monotonic-rebased timeline, with per-process health columns, the
    fleet-wide SLO curve, and the traces that crossed a process
    boundary (stdlib-only, like every other view)."""
    fed = _federation()
    summary = fed.fleet_summary(root, window_s=window_s)
    procs: Dict[str, Any] = summary["processes"]
    rows = summary["rows"]
    out: List[str] = []
    out.append(f"# Fleet: {os.path.abspath(root)}")
    out.append("")
    if not procs:
        out.append("- no registered processes under this root "
                   "(expected <root>/<process_id>/journal.jsonl)")
        return "\n".join(out)
    timed = [r for r in rows if r.get("wall") is not None]
    span = ((max(r["wall"] for r in timed)
             - min(r["wall"] for r in timed)) if timed else 0.0)
    out.append(f"- {len(procs)} process(es), {len(rows)} merged "
               f"rows, {_fmt(span)}s of fleet timeline")
    out.append("")
    out.append("## Processes")
    out.append("")
    out.append("| process | gens | rows | tears | alarms | stalls "
               "| canary ok/fail | sheds | ddl miss | firing alerts |")
    out.append("|---|---|---|---|---|---|---|---|---|---|")
    for pid in sorted(procs):
        h = procs[pid]
        flags = []
        if h["missing_headers"]:
            flags.append(f"▲{h['missing_headers']} headerless")
        alarm_n = sum(h["alarms"].values())
        firing = ", ".join(h["firing_alerts"]) if h["firing_alerts"] \
            else "—"
        out.append(
            f"| {pid}{' ' + ' '.join(flags) if flags else ''} "
            f"| {h['generations']} | {h['rows']} | {h['torn_tails']} "
            f"| {alarm_n} | {h['driver_stalls']} "
            f"| {h['canary_ok']}/{h['canary_failed']} "
            f"| {h['load_sheds']} | {h['deadline_misses']} "
            f"| {firing} |")
    alarm_kinds: Dict[str, int] = {}
    for h in procs.values():
        for k, n in h["alarms"].items():
            alarm_kinds[k] = alarm_kinds.get(k, 0) + n
    if alarm_kinds:
        out.append("")
        out.append("- fleet alarms: " + ", ".join(
            f"{k}×{n}" for k, n in sorted(alarm_kinds.items())))

    curve = summary["curve"]
    if curve:
        out.append("")
        out.append("## Fleet SLO curve")
        out.append("")
        out.append(f"- {len(curve)} window(s) of {_fmt(window_s)}s "
                   "over the merged timeline")
        out.append("")
        out.append("| window | arrivals/s | shed | ddl miss "
                   "| adm p99 s | wait p99 s | seg p99 s |")
        out.append("|---|---|---|---|---|---|---|")
        for w in curve:
            out.append(
                f"| {_fmt(w['t0'])}–{_fmt(w['t1'])} "
                f"| {_fmt(w['arrival_rate'])} "
                f"| {_fmt(w['shed_rate'])} "
                f"| {_fmt(w['deadline_miss_rate'])} "
                f"| {_fmt_opt(w['admission_p99'])} "
                f"| {_fmt_opt(w['queue_wait_p99'])} "
                f"| {_fmt_opt(w['segment_p99'])} |")
        out.append("")
        out.append("## Fleet gates (worst window vs threshold)")
        out.append("")
        out.append("| gate | metric | threshold | worst | verdict |")
        out.append("|---|---|---|---|---|")
        for g in _slo().evaluate_gates(curve):
            out.append(
                f"| {g['slo']} | {g['metric']} "
                f"| {_fmt(g['threshold'])} | {_fmt_opt(g['worst'])} "
                f"| {'ok' if g['ok'] else '**FAIL**'} |")

    xt = summary["cross_traces"]
    out.append("")
    out.append("## Cross-process traces")
    out.append("")
    if not xt:
        out.append("- none (no trace id spans more than one member — "
                   "single process, or trace_sample unset)")
    else:
        for rec in xt[:10]:
            rid = rec.get("request_id")
            out.append(
                f"- `{rec['trace_id']}`: {rec['spans']} span(s) "
                f"across {', '.join(rec['processes'])}"
                + (f" (request {rid})" if rid else ""))
        if len(xt) > 10:
            out.append(f"- … and {len(xt) - 10} more")
        top = xt[0]
        ident = top.get("request_id")
        if ident:
            trace = fed.fleet_trace(root, ident)
            if trace and trace["spans"]:
                out.append("")
                out.append(f"### Waterfall: request {ident} "
                           f"({', '.join(trace['processes'])})")
                out.append("")
                _waterfall(trace["spans"], out)
    return "\n".join(out)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    trace_id = perfetto = None
    if "--trace" in argv:
        i = argv.index("--trace")
        if i + 1 >= len(argv):
            print("usage: report.py --trace <request-id|tenant-id> "
                  "[--perfetto out.json] <journal.jsonl|run-dir>",
                  file=sys.stderr)
            return 2
        trace_id = argv[i + 1]
        del argv[i:i + 2]
    if "--perfetto" in argv:
        i = argv.index("--perfetto")
        if i + 1 >= len(argv):
            print("--perfetto needs an output path", file=sys.stderr)
            return 2
        perfetto = argv[i + 1]
        del argv[i:i + 2]
    slo_view = "--slo" in argv
    if slo_view:
        argv.remove("--slo")
    fleet_view = "--fleet" in argv
    if fleet_view:
        argv.remove("--fleet")
    watch_s = None
    if "--watch" in argv:
        i = argv.index("--watch")
        # optional interval value; defaults to 2 s
        if i + 1 < len(argv) and not argv[i + 1].startswith("-"):
            try:
                watch_s = float(argv[i + 1])
                del argv[i:i + 2]
            except ValueError:
                watch_s = 2.0
                del argv[i:i + 1]
        else:
            watch_s = 2.0
            del argv[i:i + 1]
    window_s = 1.0
    if "--window" in argv:
        i = argv.index("--window")
        if i + 1 >= len(argv):
            print("--window needs a seconds value", file=sys.stderr)
            return 2
        window_s = float(argv[i + 1])
        del argv[i:i + 2]
    paths = [a for a in argv if not a.startswith("-")]
    if not paths:
        print("usage: report.py [--trace <request-id|tenant-id> "
              "[--perfetto out.json]] [--slo [--window s]] "
              "[--fleet [--watch [s]]] "
              "<journal.jsonl|fleet-root> [...]",
              file=sys.stderr)
        return 2
    if fleet_view:
        import time as _time
        while True:
            text = "\n\n".join(render_fleet(p, window_s=window_s)
                               for p in paths)
            if watch_s is not None:
                # live refresh: clear screen + home, rerender
                sys.stdout.write("\x1b[2J\x1b[H")
            print(text)
            if watch_s is None:
                return 0
            sys.stdout.flush()
            try:
                _time.sleep(watch_s)
            except KeyboardInterrupt:
                return 0
    if slo_view:
        # one journal: windowed curves + gates; two journals:
        # curves for each, then base → probe attribution
        for p in paths:
            print(render_slo(p, window_s=window_s))
        if len(paths) == 2:
            print()
            print(render_attribution(paths[0], paths[1]))
        return 0
    for p in paths:
        if trace_id is not None:
            print(render_trace(p, trace_id, perfetto_out=perfetto))
        else:
            print(render_report(p))
    return 0


if __name__ == "__main__":
    sys.exit(main())
