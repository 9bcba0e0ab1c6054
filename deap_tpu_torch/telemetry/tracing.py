"""Distributed tracing plane — span-structured request waterfalls.

A copy of the JAX package's ``deap_tpu/telemetry/tracing.py`` (standard
library only): the port keeps its own and never imports that one.

The fourth observability layer (after journal rows, Prometheus
instruments, and the flight recorder), and the one that makes the
other three composable: one ``trace_id`` threads a request from the
client socket through the HTTP front end, the WAL fsync, the command
queue, scheduler admission, AOT compile, device segments, checkpoint
flushes, and the wire encode — each phase a ``trace_span`` journal
row that `report.py --trace` renders as a terminal waterfall and
:func:`write_perfetto` exports as Chrome/Perfetto trace-event JSON.

Design constraints this module answers:

* **Stdlib only, no package imports at module scope.** The client and
  ``report.py`` load this file standalone by path (no ``deap_tpu_torch`` —
  and therefore no torch — in the process); the lazy ``broadcast``
  lookup in :func:`emit_current` is guarded for exactly that case.
* **Deterministic ids.** ``trace_id`` and the root span id derive
  from the request id by hashing (:func:`trace_id_for`,
  :func:`span_id_for`), so the client, the service, and a
  kill-9-restarted service that recovered the request id from its WAL
  all agree on the same trace without any coordination — that is the
  entire cross-restart stitching mechanism.
* **Lifecycle spans are always on.** The sampling knob
  (``trace_sample``) gates high-volume detail spans; the tenant
  lifecycle (queue wait → admission → segment[i] → checkpoint →
  finished) is emitted whenever tracing is enabled at all, so the
  waterfall is never missing its spine.

W3C trace-context interop: :func:`format_traceparent` /
:func:`parse_traceparent` speak the ``00-<trace>-<span>-<flags>``
header format, so an external frontend's traceparent is honoured
(its trace id wins; its span becomes the root span's parent).
"""

from __future__ import annotations

import contextlib
import contextvars
import hashlib
import json
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "PHASES", "TraceContext", "Tracer",
    "trace_id_for", "span_id_for", "new_span_id",
    "format_traceparent", "parse_traceparent",
    "current", "use", "current_ids", "emit_current",
    "assemble_trace", "perfetto_events", "write_perfetto",
]

#: Canonical phase labels — the buckets of the per-phase latency
#: decomposition (and the ``phase`` label values of the
#: ``deap_service_phase_seconds`` histogram in telemetry/metrics.py).
PHASES = ("queue_wait", "wal_fsync", "admission", "compile",
          "device", "checkpoint", "wire_encode", "replay", "build")

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


# ------------------------------------------------------------- ids ----

def trace_id_for(request_id: str) -> str:
    """The deterministic 32-hex trace id for a request id.

    Every process that knows the request id — the submitting client,
    the serving process, a restarted-after-kill-9 serving process that
    replayed the id out of its WAL — derives the identical trace id,
    which is what stitches one waterfall across restarts."""
    h = hashlib.sha256(b"deap-tpu-trace:" + str(request_id).encode())
    return h.hexdigest()[:32]


def span_id_for(request_id: str, name: str) -> str:
    """A deterministic 16-hex span id for a (request, span-name)
    pair. Used for the root ``request`` span so resume spans emitted
    after a restart can parent onto it without the original row."""
    h = hashlib.sha256(
        b"deap-tpu-span:" + str(request_id).encode() + b":"
        + str(name).encode())
    return h.hexdigest()[:16]


def new_span_id() -> str:
    """A random 16-hex span id for ordinary child spans."""
    return os.urandom(8).hex()


def root_span_id(request_id: str) -> str:
    """The deterministic id of the request's root span."""
    return span_id_for(request_id, "request")


# ----------------------------------------------------- traceparent ----

def format_traceparent(trace_id: str, span_id: str,
                       sampled: bool = True) -> str:
    """Render a W3C ``traceparent`` header value (version 00)."""
    return "00-%s-%s-%s" % (trace_id, span_id,
                            "01" if sampled else "00")


def parse_traceparent(header: Optional[str]
                      ) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, span_id, sampled)`` from a ``traceparent`` header,
    or ``None`` when absent/malformed (all-zero ids are malformed per
    the W3C spec and rejected here too)."""
    if not header:
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    _, trace_id, span_id, flags = m.groups()
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id, bool(int(flags, 16) & 0x01)


# --------------------------------------------------------- context ----

@dataclass(frozen=True)
class TraceContext:
    """The ambient identity of the request currently being served.

    ``sampled`` is the tracer's per-trace decision for *detail* spans;
    lifecycle spans (``always=True``) ignore it."""
    trace_id: str
    span_id: str
    request_id: Optional[str] = None
    sampled: bool = True

    def traceparent(self) -> str:
        return format_traceparent(self.trace_id, self.span_id,
                                  self.sampled)

    def child(self, span_id: Optional[str] = None) -> "TraceContext":
        return TraceContext(self.trace_id, span_id or new_span_id(),
                            self.request_id, self.sampled)


_CURRENT: contextvars.ContextVar[Optional[TraceContext]] = \
    contextvars.ContextVar("deap_tpu_trace_context", default=None)


def current() -> Optional[TraceContext]:
    """The ambient :class:`TraceContext`, or ``None`` outside a
    request."""
    return _CURRENT.get()


@contextlib.contextmanager
def use(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the ambient trace context for the block.
    ``None`` is a no-op (so call sites need no conditional)."""
    if ctx is None:
        yield
        return
    token = _CURRENT.set(ctx)
    try:
        yield
    finally:
        _CURRENT.reset(token)


def current_ids() -> Dict[str, Any]:
    """``{trace_id, span_id, request_id}`` of the ambient context for
    stamping onto foreign journal rows (e.g. ``program_profile``), or
    ``{}`` outside a request."""
    ctx = _CURRENT.get()
    if ctx is None:
        return {}
    out: Dict[str, Any] = {"trace_id": ctx.trace_id,
                           "span_id": ctx.span_id}
    if ctx.request_id is not None:
        out["request_id"] = ctx.request_id
    return out


def emit_current(name: str, dur_s: float, phase: Optional[str] = None,
                 always: bool = False,
                 links: Optional[List[Dict[str, Any]]] = None,
                 **attrs: Any) -> None:
    """Emit a ``trace_span`` row against the *ambient* context via
    journal broadcast — for layers that hold no tracer reference
    (costs observatory, checkpoint writer, the profiling bridge).
    No ambient context, or a context sampled out (unless ``always``),
    means no row. Safe under standalone load: when the journal module
    is unimportable the call is a silent no-op."""
    ctx = _CURRENT.get()
    if ctx is None or not (always or ctx.sampled):
        return
    try:
        from deap_tpu_torch.telemetry.journal import broadcast
    except Exception:
        return
    row: Dict[str, Any] = dict(
        name=name, phase=phase, dur_s=round(float(dur_s), 6),
        trace_id=ctx.trace_id, span_id=new_span_id(),
        parent_id=ctx.span_id)
    if ctx.request_id is not None:
        row["request_id"] = ctx.request_id
    if links:
        row["links"] = links
    row.update(attrs)
    broadcast("trace_span", **row)


# ---------------------------------------------------------- tracer ----

class Tracer:
    """Span factory bound to a journal and a sampling rate.

    ``sample`` is the ``trace_sample`` knob: a float in [0, 1]
    deciding *per trace* (deterministically, from the trace id's
    leading bits) whether detail spans are recorded. Lifecycle spans
    pass ``always=True`` and are emitted regardless. ``phase_observe``
    — when set — receives ``(phase, dur_s)`` for every emitted span
    with a phase, feeding the ``deap_service_phase_seconds``
    histogram."""

    def __init__(self, journal: Any = None, sample: float = 1.0,
                 phase_observe: Optional[
                     Callable[[str, float], None]] = None):
        self.journal = journal
        self.sample = float(sample)
        self.phase_observe = phase_observe

    # -- context -------------------------------------------------------

    def sampled(self, trace_id: str) -> bool:
        """Deterministic per-trace sampling decision: the trace id's
        leading 32 bits as a uniform draw in [0, 1)."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return (int(trace_id[:8], 16) / 0x100000000) < self.sample

    def context_for(self, request_id: str,
                    traceparent: Optional[str] = None
                    ) -> TraceContext:
        """The trace context for an incoming request: a valid
        ``traceparent`` header wins (its trace continues, its span
        becomes the parent); otherwise both ids derive from the
        request id."""
        parsed = parse_traceparent(traceparent)
        if parsed is not None:
            trace_id, span_id, flag = parsed
            return TraceContext(trace_id, span_id, request_id,
                                flag and self.sampled(trace_id))
        trace_id = trace_id_for(request_id)
        return TraceContext(trace_id, root_span_id(request_id),
                            request_id, self.sampled(trace_id))

    # -- emission ------------------------------------------------------

    def emit(self, name: str, dur_s: float,
             ctx: Optional[TraceContext] = None,
             phase: Optional[str] = None, always: bool = False,
             span_id: Optional[str] = None,
             parent_id: Optional[str] = None,
             links: Optional[List[Dict[str, Any]]] = None,
             **attrs: Any) -> None:
        """Record one finished span (duration measured by the caller).
        ``ctx`` defaults to the ambient context; no context → no row.
        The phase histogram observes every phase-carrying span the
        moment a context exists — sampling gates only the journal
        row, so ``deap_service_phase_seconds`` stays complete at any
        sample rate while the per-trace waterfall detail is paid for
        by the sampled minority."""
        ctx = ctx if ctx is not None else _CURRENT.get()
        if ctx is None:
            return
        if phase is not None and self.phase_observe is not None:
            self.phase_observe(phase, float(dur_s))
        if not (always or ctx.sampled):
            return
        row: Dict[str, Any] = dict(
            name=name, phase=phase,
            dur_s=round(float(dur_s), 6),
            trace_id=ctx.trace_id,
            span_id=span_id or new_span_id(),
            parent_id=(parent_id if parent_id is not None
                       else ctx.span_id))
        if row["parent_id"] == row["span_id"]:
            row["parent_id"] = None  # a root span has no parent
        if ctx.request_id is not None:
            row.setdefault("request_id", ctx.request_id)
        if links:
            row["links"] = links
        row.update(attrs)
        if self.journal is not None:
            self.journal.event("trace_span", **row)
        else:
            try:
                from deap_tpu_torch.telemetry.journal import broadcast
            except Exception:
                return
            broadcast("trace_span", **row)

    @contextlib.contextmanager
    def span(self, name: str, ctx: Optional[TraceContext] = None,
             phase: Optional[str] = None, always: bool = False,
             span_id: Optional[str] = None,
             parent_id: Optional[str] = None,
             links: Optional[List[Dict[str, Any]]] = None,
             **attrs: Any):
        """Time the block and emit it as one span. The block runs with
        the (child) context ambient, so spans opened inside it parent
        correctly and :func:`current_ids` stamps foreign rows."""
        ctx = ctx if ctx is not None else _CURRENT.get()
        if ctx is None:
            yield None
            return
        sid = span_id or new_span_id()
        child = TraceContext(ctx.trace_id, sid, ctx.request_id,
                             ctx.sampled)
        t0 = time.perf_counter()
        token = _CURRENT.set(child)
        try:
            yield child
        finally:
            _CURRENT.reset(token)
            self.emit(name, time.perf_counter() - t0, ctx=ctx,
                      phase=phase, always=always, span_id=sid,
                      parent_id=parent_id, links=links, **attrs)


# -------------------------------------------------------- assembly ----

def assemble_trace(row_groups: Iterable[Tuple[Optional[dict],
                                              Iterable[dict]]],
                   trace_id: str) -> Dict[str, Any]:
    """Stitch one trace out of (possibly several, possibly rotated)
    journals.

    ``row_groups`` is an iterable of ``(header_row_or_None, rows)``
    pairs — one pair per journal file, oldest first. Journal ``t``
    values are monotonic offsets from each file's own epoch; the
    header's ``wall_start`` rebases them onto one wall-clock axis so
    pre-kill and post-restart spans order correctly.

    Returns ``{"trace_id", "spans", "orphans", "root"}`` where each
    span dict gains ``start`` (absolute seconds; span rows carry their
    *end* time) and ``orphans`` lists span ids whose ``parent_id``
    resolves neither to a span in the trace nor to the deterministic
    root. A missing root span (e.g. only the post-restart journal
    survived and the root row was in the rotated file that got lost)
    is synthesized and marked ``synthetic: True``."""
    spans: List[Dict[str, Any]] = []
    for header, rows in row_groups:
        wall = float((header or {}).get("wall_start", 0.0))
        for row in rows:
            if row.get("kind") != "trace_span":
                continue
            if row.get("trace_id") != trace_id:
                continue
            s = dict(row)
            end = wall + float(row.get("t", 0.0))
            s["start"] = end - float(row.get("dur_s", 0.0) or 0.0)
            s["end"] = end
            spans.append(s)
    spans.sort(key=lambda s: s["start"])

    ids = {s["span_id"] for s in spans}
    root = next((s for s in spans
                 if s.get("parent_id") is None
                 or s["parent_id"] not in ids), None)
    rid = next((s.get("request_id") for s in spans
                if s.get("request_id")), None)
    det_root = root_span_id(rid) if rid is not None else None
    have_root = det_root is not None and det_root in ids
    if not have_root and det_root is not None:
        lo = min((s["start"] for s in spans), default=0.0)
        hi = max((s["end"] for s in spans), default=0.0)
        spans.insert(0, {
            "kind": "trace_span", "name": "request", "phase": None,
            "trace_id": trace_id, "span_id": det_root,
            "parent_id": None, "request_id": rid,
            "start": lo, "end": hi,
            "dur_s": round(hi - lo, 6), "synthetic": True,
        })
        ids.add(det_root)
        root = spans[0]
    elif have_root:
        root = next(s for s in spans if s["span_id"] == det_root)

    # orphan check by span id, not object identity: a retried request
    # re-handled server-side emits the deterministic root row once per
    # attempt — every copy is the root, none is an orphan
    root_sid = root["span_id"] if root is not None else None
    orphans = [s["span_id"] for s in spans
               if s.get("parent_id") is not None
               and s["parent_id"] not in ids
               and s["span_id"] != root_sid]
    return {"trace_id": trace_id, "spans": spans,
            "orphans": orphans, "root": root}


# -------------------------------------------------------- perfetto ----

def perfetto_events(spans: Iterable[Dict[str, Any]]
                    ) -> List[Dict[str, Any]]:
    """Chrome/Perfetto trace-event JSON events for assembled spans
    (``"ph": "X"`` complete events; zero-duration spans become
    instants). Load the output at ``ui.perfetto.dev`` or
    ``chrome://tracing``."""
    events: List[Dict[str, Any]] = []
    for s in spans:
        dur_us = float(s.get("dur_s", 0.0) or 0.0) * 1e6
        args = {k: v for k, v in s.items()
                if k not in ("kind", "t", "name", "start", "end",
                             "dur_s")
                and v is not None}
        base = dict(name=s.get("name", "?"), pid=1,
                    tid=s.get("tenant_id") or s.get("request_id")
                    or "trace",
                    ts=round(float(s.get("start", 0.0)) * 1e6, 3),
                    args=args)
        if dur_us <= 0.0:
            events.append(dict(base, ph="i", s="t"))
        else:
            events.append(dict(base, ph="X",
                               dur=round(dur_us, 3)))
    return events


def write_perfetto(path: str,
                   spans: Iterable[Dict[str, Any]]) -> str:
    """Write assembled spans as a Perfetto-loadable trace-event file;
    returns ``path``."""
    payload = {"traceEvents": perfetto_events(spans),
               "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(payload, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return path
