"""Fleet journal federation — many processes, one timeline.

A copy of the JAX package's ``deap_tpu/telemetry/federation.py`` (standard
library only): the port keeps its own and never imports that one.

Every observability surface before ISSUE 19 reads ONE process's
journal. The router tier and rolling upgrades (ROADMAP items 1 and 4)
put several driver processes behind one front end, so this module
defines the **fleet root** contract and the federator that merges the
member journals back into a single story:

- **Layout.** A fleet root is a directory of per-process journal
  dirs: ``<root>/<process_id>/journal.jsonl`` plus that journal's
  rotated ``.N`` generations (kill-9 restarts) and an optional
  ``meta.json`` written at registration. :func:`register_process`
  creates the dir and returns the journal path for the process to
  open — registration IS the directory, so a kill-9'd member needs no
  deregistration and a scraper needs no lockfile.
- **Merge.** Journal ``t`` values are monotonic offsets from each
  file's own epoch; each generation's header carries ``wall_start``,
  so ``wall_start + t`` rebases every row onto one wall-clock axis —
  exactly the epoch-rebase discipline
  :func:`~deap_tpu_torch.telemetry.tracing.assemble_trace` uses across
  restarts, applied across processes. :func:`federate` returns the
  merged rows (each stamped with its ``process`` and absolute
  ``wall`` seconds) sorted into one fleet timeline, tolerating torn
  tails and headerless generations in any member
  (``read_journal(strict=False)``; a generation whose header was
  lost keeps its rows at the timeline origin rather than poisoning
  the merge).
- **Stitch.** Trace ids derive deterministically from request ids
  (:func:`~deap_tpu_torch.telemetry.tracing.trace_id_for`), so spans for
  one request emitted by *different processes* (client + server, or
  a tenant migrated between drivers) already share a trace id with
  zero coordination — :func:`fleet_trace` assembles the cross-process
  waterfall and :func:`cross_process_traces` lists the trace ids that
  actually span members.
- **Rollup.** :func:`process_health` summarises each member (rows,
  generations, tears, alarms, stalls, canary verdicts, firing
  alerts); :func:`fleet_curve` re-windows the merged timeline through
  :func:`~deap_tpu_torch.telemetry.slo.windowed_curve` for the fleet-wide
  SLO view. ``report.py --fleet`` renders all of it (with ``--watch``
  for a live refresh).

Like its siblings this module imports **nothing but the standard
library** and loads ``journal.py``/``tracing.py``/``slo.py`` by file
path, so a fleet report renders on a box with no torch installed
(``tests/test_torch_telemetry_copies.py`` pins the no-torch subprocess guarantee).
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["register_process", "fleet_processes", "process_groups",
           "process_health", "federate", "fleet_curve",
           "fleet_trace", "cross_process_traces", "fleet_summary"]

#: the journal filename every member opens inside its process dir
JOURNAL_NAME = "journal.jsonl"

#: registration metadata filename (optional; scrapers must not
#: require it — a member that died before writing it still federates)
META_NAME = "meta.json"

_here = os.path.dirname(os.path.abspath(__file__))
_mods: Dict[str, Any] = {}


def _load(fname: str):
    """A sibling telemetry module loaded standalone by path (never
    through the ``deap_tpu_torch`` package, which imports torch). Registered
    in ``sys.modules`` before exec so dataclass processing resolves
    ``cls.__module__`` (the report.py pattern)."""
    if fname not in _mods:
        spec = importlib.util.spec_from_file_location(
            "_deap_tpu_torch_fed_" + fname[:-3], os.path.join(_here, fname))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod
        spec.loader.exec_module(mod)
        _mods[fname] = mod
    return _mods[fname]


def _journal():
    return _load("journal.py")


def _tracing():
    return _load("tracing.py")


def _slo():
    return _load("slo.py")


# ------------------------------------------------------ fleet root ----

def register_process(root: str, process_id: Optional[str] = None,
                     **meta: Any) -> str:
    """Create ``<root>/<process_id>/`` and return the journal path
    inside it (pass to :class:`~deap_tpu_torch.telemetry.journal.RunJournal`
    or as a service/scheduler root's journal). ``process_id``
    defaults to ``proc-<pid>``; extra ``meta`` lands in ``meta.json``
    (best-effort — federation never requires it)."""
    pid = str(process_id) if process_id else f"proc-{os.getpid()}"
    if os.sep in pid or pid in (".", ".."):
        raise ValueError(f"process_id {pid!r} must be a plain name")
    d = os.path.join(str(root), pid)
    os.makedirs(d, exist_ok=True)
    try:
        with open(os.path.join(d, META_NAME), "w") as fh:
            json.dump({"process_id": pid, "pid": os.getpid(),
                       **meta}, fh, sort_keys=True)
            fh.write("\n")
    except OSError:
        pass
    return os.path.join(d, JOURNAL_NAME)


def fleet_processes(root: str) -> List[str]:
    """The registered process ids under ``root`` (sorted): every
    subdirectory holding at least one journal generation."""
    jm = _journal()
    out = []
    try:
        entries = sorted(os.listdir(root))
    except OSError:
        return []
    for name in entries:
        d = os.path.join(root, name)
        if not os.path.isdir(d):
            continue
        if jm.journal_generations(os.path.join(d, JOURNAL_NAME)):
            out.append(name)
    return out


def process_meta(root: str, process_id: str) -> Dict[str, Any]:
    """The member's ``meta.json`` (``{}`` when absent/unreadable)."""
    try:
        with open(os.path.join(root, process_id, META_NAME)) as fh:
            meta = json.load(fh)
        return meta if isinstance(meta, dict) else {}
    except (OSError, ValueError):
        return {}


def process_groups(root: str, process_id: str
                   ) -> List[Tuple[Optional[dict], Any]]:
    """One member's journal generations, oldest first, parsed into
    the ``(header_row_or_None, rows)`` pairs
    :func:`~deap_tpu_torch.telemetry.tracing.assemble_trace` stitches
    across (torn tails tolerated — ``strict=False``)."""
    jm = _journal()
    path = os.path.join(root, process_id, JOURNAL_NAME)
    groups: List[Tuple[Optional[dict], Any]] = []
    for p in jm.journal_generations(path):
        try:
            rows = jm.read_journal(p, strict=False)
        except OSError:
            continue
        header = next((e for e in rows
                       if e.get("kind") == "header"), None)
        groups.append((header, rows))
    return groups


# ----------------------------------------------------------- merge ----

def federate(root: str) -> Dict[str, Any]:
    """Merge every member's journal generations into one
    monotonic-rebased fleet timeline.

    Returns ``{"root", "processes": {pid: health}, "rows"}`` where
    ``rows`` is the merged timeline sorted by absolute time: each row
    is a copy of the journal row plus ``process`` (the member id) and
    ``wall`` (``header.wall_start + t`` — the epoch rebase; rows from
    a generation whose header was torn away get ``wall = t`` and the
    member's health notes the missing header). The sort is stable on
    ``(wall, process)`` so equal-time rows order deterministically."""
    processes: Dict[str, Dict[str, Any]] = {}
    merged: List[Dict[str, Any]] = []
    for pid in fleet_processes(root):
        groups = process_groups(root, pid)
        processes[pid] = process_health(groups,
                                        meta=process_meta(root, pid))
        for header, rows in groups:
            wall0 = float((header or {}).get("wall_start", 0.0))
            for row in rows:
                r = dict(row)
                r["process"] = pid
                r["wall"] = wall0 + float(row.get("t", 0.0) or 0.0)
                merged.append(r)
    merged.sort(key=lambda r: (r["wall"], r["process"]))
    return {"root": str(root), "processes": processes,
            "rows": merged}


def process_health(groups: List[Tuple[Optional[dict], Any]],
                   meta: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """One member's health column: row/generation counts, torn-tail
    and missing-header flags, alarm/stall/shed/deadline tallies, the
    canary verdict counts, currently-firing alerts (the last ``alert``
    row per name wins) and the member's absolute time span."""
    n_rows = 0
    tears = 0
    missing_header = 0
    alarms: Dict[str, int] = {}
    stalls = canary_ok = canary_failed = sheds = deadline = 0
    alert_state: Dict[str, str] = {}
    lo = hi = None
    for header, rows in groups:
        wall0 = float((header or {}).get("wall_start", 0.0))
        if header is None:
            missing_header += 1
        n_rows += len(rows)
        if getattr(rows, "tear_offset", None) is not None:
            tears += 1
        for row in rows:
            kind = row.get("kind")
            w = wall0 + float(row.get("t", 0.0) or 0.0)
            lo = w if lo is None else min(lo, w)
            hi = w if hi is None else max(hi, w)
            if kind == "alarm":
                a = str(row.get("alarm", "?"))
                alarms[a] = alarms.get(a, 0) + 1
            elif kind == "driver_stall" and "stalled_s" in row:
                stalls += 1
            elif kind == "canary_ok":
                canary_ok += 1
            elif kind == "canary_failed":
                canary_failed += 1
            elif kind == "load_shed":
                sheds += 1
            elif kind == "deadline_exceeded":
                deadline += 1
            elif kind == "alert":
                alert_state[str(row.get("name", "?"))] = \
                    str(row.get("state", "?"))
    return {
        "generations": len(groups), "rows": n_rows,
        "torn_tails": tears, "missing_headers": missing_header,
        "alarms": alarms, "driver_stalls": stalls,
        "canary_ok": canary_ok, "canary_failed": canary_failed,
        "load_sheds": sheds, "deadline_misses": deadline,
        "firing_alerts": sorted(n for n, s in alert_state.items()
                                if s == "firing"),
        "wall_lo": lo, "wall_hi": hi,
        "meta": meta or {},
    }


def fleet_curve(rows: List[Dict[str, Any]],
                window_s: float = 1.0) -> List[Dict[str, Any]]:
    """The fleet-wide windowed SLO curve: the merged timeline's rows
    re-anchored to the fleet's earliest wall second and fed through
    :func:`~deap_tpu_torch.telemetry.slo.windowed_curve` (which windows on
    ``t``)."""
    sl = _slo()
    timed = [r for r in rows
             if isinstance(r.get("wall"), (int, float))]
    if not timed:
        return []
    t0 = min(r["wall"] for r in timed)
    rebased = [dict(r, t=r["wall"] - t0) for r in timed]
    return sl.windowed_curve(rebased, window_s=window_s)


# ---------------------------------------------------------- traces ----

def _all_groups(root: str) -> List[Tuple[Optional[dict], Any]]:
    groups: List[Tuple[Optional[dict], Any]] = []
    for pid in fleet_processes(root):
        groups.extend(process_groups(root, pid))
    return groups


def resolve_request_id(root: str, ident: str) -> Optional[str]:
    """``ident`` as a request id, or resolved from a tenant id via
    any member's rows that carry both (the ``report.py --trace``
    convention, fleet-wide)."""
    groups = _all_groups(root)
    for _, rows in groups:
        for e in rows:
            if e.get("request_id") == ident:
                return ident
    for _, rows in groups:
        for e in rows:
            if e.get("tenant_id") == ident and e.get("request_id"):
                return str(e["request_id"])
    return None


def fleet_trace(root: str, ident: str) -> Optional[Dict[str, Any]]:
    """One request's trace assembled across EVERY member's journal
    generations — the deterministic trace id stitches spans emitted
    by different processes with zero coordination. Returns the
    :func:`~deap_tpu_torch.telemetry.tracing.assemble_trace` dict plus
    ``request_id`` and ``processes`` (which members contributed
    spans), or ``None`` when no member knows ``ident``."""
    tr = _tracing()
    rid = resolve_request_id(root, ident)
    if rid is None:
        return None
    trace_id = tr.trace_id_for(rid)
    contributing: List[str] = []
    groups: List[Tuple[Optional[dict], Any]] = []
    for pid in fleet_processes(root):
        pg = process_groups(root, pid)
        groups.extend(pg)
        if any(e.get("kind") == "trace_span"
               and e.get("trace_id") == trace_id
               for _, rows in pg for e in rows):
            contributing.append(pid)
    trace = tr.assemble_trace(groups, trace_id)
    trace["request_id"] = rid
    trace["processes"] = contributing
    return trace


def cross_process_traces(root: str) -> List[Dict[str, Any]]:
    """The trace ids whose spans appear in more than one member —
    the proof a request (or a migrated tenant) crossed a process
    boundary. Returns ``[{"trace_id", "request_id", "processes",
    "spans"}]`` sorted by span count descending."""
    seen: Dict[str, Dict[str, Any]] = {}
    for pid in fleet_processes(root):
        for _, rows in process_groups(root, pid):
            for e in rows:
                if e.get("kind") != "trace_span":
                    continue
                tid = e.get("trace_id")
                if not tid:
                    continue
                rec = seen.setdefault(
                    tid, {"trace_id": tid, "request_id": None,
                          "processes": set(), "spans": 0})
                rec["processes"].add(pid)
                rec["spans"] += 1
                if rec["request_id"] is None and e.get("request_id"):
                    rec["request_id"] = str(e["request_id"])
    out = [dict(r, processes=sorted(r["processes"]))
           for r in seen.values() if len(r["processes"]) > 1]
    out.sort(key=lambda r: (-r["spans"], r["trace_id"]))
    return out


# --------------------------------------------------------- summary ----

def fleet_summary(root: str, window_s: float = 1.0
                  ) -> Dict[str, Any]:
    """Everything ``report.py --fleet`` renders, in one call: the
    federated timeline, per-process health, the fleet SLO curve and
    the cross-process trace index."""
    fed = federate(root)
    return {
        "root": fed["root"],
        "processes": fed["processes"],
        "rows": fed["rows"],
        "curve": fleet_curve(fed["rows"], window_s=window_s),
        "cross_traces": cross_process_traces(root),
    }
