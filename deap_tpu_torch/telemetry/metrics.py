"""Host-side serving metrics registry + Prometheus text exposition.

A copy of the JAX package's ``deap_tpu/telemetry/metrics.py`` (standard
library only): the port keeps its own and never imports that one.

The third observability plane's *external* surface: while the journal
(:mod:`~deap_tpu_torch.telemetry.journal`) is one run's append-only history,
this registry is the **current state** of a serving process — queue
depths, lane occupancy, per-tenant throughput, segment/checkpoint
latency distributions — exported in the Prometheus text exposition
format (``metrics_text``) and optionally served over HTTP
(:func:`serve_metrics`, a stdlib-only ``/metrics`` endpoint). This is
the first externally scrapeable surface of the stack and the opening
move toward the RPC front end (ROADMAP item 1): an operator pointing
Prometheus at a :class:`~deap_tpu_torch.serving.scheduler.Scheduler` gets
per-bucket SLO series with zero extra wiring.

Like :mod:`~deap_tpu_torch.telemetry.report`, this module imports **nothing
but the standard library** — scraping a metrics snapshot must never
initialise a CUDA context (``tests/test_torch_telemetry_copies.py`` pins the no-torch
guarantee by loading the file standalone in a subprocess).

Three instrument kinds, the Prometheus trio:

- :class:`Counter` — monotone totals (evictions, resumes, retries);
- :class:`Gauge` — set-to-current values (queue depth, occupancy,
  per-tenant gens/s);
- :class:`Histogram` — cumulative-bucket latency distributions
  (queue-wait, segment and checkpoint seconds) with exact
  ``_sum``/``_count`` series, so p50/p99 are recoverable by any
  Prometheus-compatible consumer.

All instruments take label sets at observation time::

    reg = MetricsRegistry()
    depth = reg.gauge("deap_serving_queue_depth",
                      "jobs waiting per bucket", labels=("bucket",))
    depth.set(3, bucket="onemax/16")
    print(reg.metrics_text())

Thread safety: one lock per registry — the scheduler's driver thread
and the HTTP server thread share instruments safely.
"""

from __future__ import annotations

import http.server
import math
import threading
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "HistogramSnapshot",
           "MetricsRegistry", "MetricsServer", "SERVING_PHASE_BUCKETS",
           "SERVING_SEGMENT_BUCKETS", "SERVING_WAIT_BUCKETS",
           "alarms_total", "alert_state_gauge", "get_registry",
           "metrics_text", "phase_histogram", "serve_metrics",
           "startup_phase_histogram"]

#: default histogram bucket bounds (seconds) — spans sub-ms host work
#: to multi-minute compiles; ``+Inf`` is implicit
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0)

# ---- per-metric serving bucket overrides (ISSUE 17 satellite) ----
# BENCH_SERVICE.json measured queue-wait p99 at 14.2 s under the
# bursty pair — with DEFAULT_BUCKETS every observation past 10 s
# collapses into the 30 s bucket and a windowed p99 reads "30.0" for
# anything between 10.001 and 30 s. These tuples keep bucket-
# resolution percentiles finite and useful across the measured burst
# range (and well past it: abandoned-tenant waits can reach minutes
# before the autoscaler spills them).

#: queue-wait / admission latency (seconds): dense through the
#: measured 10–60 s burst range, finite out to 10 minutes
SERVING_WAIT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                        1.0, 2.5, 5.0, 10.0, 15.0, 20.0, 30.0, 45.0,
                        60.0, 90.0, 120.0, 300.0, 600.0)

#: scheduler segment wall seconds: sub-ms device steps through
#: fault-injected multi-second stalls (DelaySegment) without
#: saturating
SERVING_SEGMENT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                           0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 20.0,
                           30.0, 60.0, 120.0, 300.0)

#: per-phase request latency (tracing plane): spans sub-ms WAL
#: fsyncs to multi-minute compiles and burst queue waits
SERVING_PHASE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
                         0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                         15.0, 30.0, 60.0, 120.0, 300.0, 600.0)

_NAME_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or not set(name) <= _NAME_OK:
        raise ValueError(f"invalid metric name {name!r}")
    return name


def _escape_label(value: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v: float) -> str:
    """Exposition-format float: integers render bare, specials render
    as +Inf/-Inf/NaN per the text format."""
    if isinstance(v, float):
        if math.isinf(v):
            return "+Inf" if v > 0 else "-Inf"
        if math.isnan(v):
            return "NaN"
        if v == int(v) and abs(v) < 1e15:
            return str(int(v))
        return repr(v)
    return str(v)


def _labels_key(declared: Tuple[str, ...], given: Dict[str, str]
                ) -> Tuple[str, ...]:
    extra = set(given) - set(declared)
    missing = set(declared) - set(given)
    if extra or missing:
        raise ValueError(
            f"label mismatch: declared {declared}, got {tuple(given)}")
    return tuple(str(given[k]) for k in declared)


def _render_labels(declared: Sequence[str], key: Sequence[str],
                   extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(v)}"' for n, v in zip(declared, key)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    """Shared plumbing: name/help/type, declared label names, one
    child per observed label-value tuple."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str],
                 lock: threading.Lock):
        self.name = _check_name(name)
        self.help = str(help)
        self.labels = tuple(str(label) for label in labels)
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}

    def _child(self, given: Dict[str, str], default):
        key = _labels_key(self.labels, given)
        child = self._children.get(key)
        if child is None:
            child = self._children[key] = default()
        return child

    def samples(self) -> Iterable[Tuple[str, str, float]]:
        """``(suffix, label-block, value)`` rows — exposition order."""
        raise NotImplementedError

    def expose(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} {self.kind}"]
        for suffix, block, value in self.samples():
            out.append(f"{self.name}{suffix}{block} {_fmt_value(value)}")
        return out


class Counter(_Instrument):
    """Monotone total. ``inc`` only — decreasing a counter is a bug the
    registry refuses to allow."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only increase")
        with self._lock:
            child = self._child(labels, lambda: [0.0])
            child[0] += amount

    def value(self, **labels: str) -> float:
        with self._lock:
            key = _labels_key(self.labels, labels)
            child = self._children.get(key)
            return float(child[0]) if child else 0.0

    def samples(self):
        # copy under the lock, render outside it: a concurrent inc()
        # creating a new label child must not blow up ("dictionary
        # changed size during iteration") mid-scrape — the exposition
        # path used to iterate _children unlocked (ISSUE 19 satellite;
        # hammer-tested by tests/test_alerts.py)
        with self._lock:
            items = [(key, self._children[key][0])
                     for key in sorted(self._children)]
        for key, value in items:
            yield "", _render_labels(self.labels, key), value


class Gauge(_Instrument):
    """Set-to-current value (queue depth, occupancy, gens/s)."""

    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        with self._lock:
            self._child(labels, lambda: [0.0])[0] = float(value)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        with self._lock:
            self._child(labels, lambda: [0.0])[0] += amount

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self.inc(-amount, **labels)

    def value(self, **labels: str) -> float:
        with self._lock:
            key = _labels_key(self.labels, labels)
            child = self._children.get(key)
            return float(child[0]) if child else 0.0

    def samples(self):
        with self._lock:   # see Counter.samples
            items = [(key, self._children[key][0])
                     for key in sorted(self._children)]
        for key, value in items:
            yield "", _render_labels(self.labels, key), value


class _HistChild:
    __slots__ = ("counts", "total", "n")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets
        self.total = 0.0
        self.n = 0


class HistogramSnapshot:
    """A point-in-time copy of one histogram child's cumulative state
    — the windowed-percentile primitive (ISSUE 17).

    Prometheus histograms are cumulative: ``counts``/``total``/``n``
    only ever grow, so a quantile over the raw child mixes every
    observation since process start. Subtracting two snapshots
    (:meth:`delta`) yields the distribution of exactly the
    observations that landed *between* them, and :meth:`quantile` on
    the delta is the windowed percentile that SLO curves
    (:mod:`deap_tpu_torch.telemetry.slo`) gate on."""

    __slots__ = ("buckets", "counts", "total", "n")

    def __init__(self, buckets: Tuple[float, ...],
                 counts: Sequence[int], total: float, n: int):
        self.buckets = tuple(buckets)
        self.counts = tuple(counts)
        self.total = float(total)
        self.n = int(n)

    def delta(self, earlier: "HistogramSnapshot") -> "HistogramSnapshot":
        """The observations between ``earlier`` and ``self`` (both
        snapshots of the same histogram child, ``earlier`` taken
        first)."""
        if self.buckets != earlier.buckets:
            raise ValueError("snapshot bucket bounds differ — not the "
                             "same histogram")
        return HistogramSnapshot(
            self.buckets,
            [a - b for a, b in zip(self.counts, earlier.counts)],
            self.total - earlier.total, self.n - earlier.n)

    def quantile(self, q: float) -> Optional[float]:
        """Bucket-resolution quantile over this snapshot's (or
        delta's) observations; ``None`` when empty, ``+Inf`` past the
        top finite bucket — same contract as
        :meth:`Histogram.quantile`."""
        if self.n <= 0:
            return None
        rank = q * self.n
        for bound, c in zip(self.buckets, self.counts):
            if c >= rank:
                return bound
        return float("inf")

    def mean(self) -> Optional[float]:
        return self.total / self.n if self.n > 0 else None


class Histogram(_Instrument):
    """Cumulative-bucket distribution with exact sum/count. Buckets are
    upper bounds (``le``); the ``+Inf`` bucket is implicit and always
    equals ``_count``, per the exposition format."""

    kind = "histogram"

    def __init__(self, name, help, labels, lock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket")

    def observe(self, value: float, **labels: str) -> None:
        value = float(value)
        with self._lock:
            child = self._child(
                labels, lambda: _HistChild(len(self.buckets)))
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    child.counts[i] += 1
            child.total += value
            child.n += 1

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Bucket-resolution quantile (the upper bound of the bucket
        the q-th observation falls in) — the host-side twin of the
        PromQL ``histogram_quantile`` the exported series feed."""
        with self._lock:
            key = _labels_key(self.labels, labels)
            child = self._children.get(key)
            if child is None or child.n == 0:
                return None
            rank = q * child.n
            for bound, c in zip(self.buckets, child.counts):
                if c >= rank:
                    return bound
            return float("inf")

    def snapshot(self, **labels: str) -> HistogramSnapshot:
        """A consistent point-in-time copy of one child's cumulative
        state. An unobserved label set snapshots as all-zero (so
        ``later.delta(earlier)`` works uniformly across children that
        appear mid-window)."""
        with self._lock:
            key = _labels_key(self.labels, labels)
            child = self._children.get(key)
            if child is None:
                return HistogramSnapshot(
                    self.buckets, [0] * len(self.buckets), 0.0, 0)
            return HistogramSnapshot(self.buckets, list(child.counts),
                                     child.total, child.n)

    def label_sets(self) -> List[Dict[str, str]]:
        """The label sets observed so far — e.g. every ``phase`` the
        tracing plane has fed ``deap_service_phase_seconds``."""
        with self._lock:
            return [dict(zip(self.labels, key))
                    for key in sorted(self._children)]

    def samples(self):
        # consistent per-child copy under the lock (see
        # Counter.samples): a mid-copy observe would otherwise tear a
        # child's counts/total/n apart across the exposition
        with self._lock:
            items = [(key, list(child.counts), child.total, child.n)
                     for key, child in sorted(self._children.items())]
        for key, counts, total, n in items:
            for bound, c in zip(self.buckets, counts):
                yield "_bucket", _render_labels(
                    self.labels, key, f'le="{_fmt_value(bound)}"'), c
            yield "_bucket", _render_labels(self.labels, key,
                                            'le="+Inf"'), n
            yield "_sum", _render_labels(self.labels, key), total
            yield "_count", _render_labels(self.labels, key), n


class MetricsRegistry:
    """One process's (or one scheduler's) instrument set.

    Instruments are create-or-get by name: calling :meth:`counter`
    twice with one name returns the same instrument (with a type/label
    mismatch raising), so subsystems can declare their metrics
    independently and still share a registry.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get_or_make(self, cls, name, help, labels, **kw):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls) or \
                        inst.labels != tuple(labels):
                    raise ValueError(
                        f"metric {name!r} re-declared as {cls.__name__}"
                        f"{tuple(labels)} (was {type(inst).__name__}"
                        f"{inst.labels})")
                want = kw.get("buckets")
                if want is not None and isinstance(inst, Histogram) \
                        and inst.buckets != tuple(
                            sorted(float(b) for b in want)):
                    # a silent bucket mismatch would make a per-metric
                    # override a no-op — the saturation bug would
                    # survive looking fixed
                    raise ValueError(
                        f"histogram {name!r} re-declared with buckets "
                        f"{tuple(want)} (was {inst.buckets})")
                return inst
            inst = cls(name, help, labels, self._lock, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_make(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_make(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._get_or_make(Histogram, name, help, labels,
                                 buckets=buckets)

    def metrics_text(self) -> str:
        """The full registry in Prometheus text exposition format
        (version 0.0.4) — what ``GET /metrics`` returns."""
        with self._lock:
            instruments = sorted(self._instruments.values(),
                                 key=lambda i: i.name)
        out: List[str] = []
        for inst in instruments:
            out.extend(inst.expose())
        return "\n".join(out) + ("\n" if out else "")


#: process-default registry — what the scheduler and resilience engine
#: record into unless handed their own
_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _DEFAULT


class MetricsServer:
    """A daemon-thread HTTP server exposing one registry at
    ``/metrics``. Close it (or let the process exit) to stop."""

    CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    def __init__(self, registry: MetricsRegistry,
                 host: str = "127.0.0.1", port: int = 0):
        self.registry = registry
        server = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.split("?")[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                body = server.registry.metrics_text().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", server.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # scrapes are not log lines
                pass

        self._httpd = http.server.ThreadingHTTPServer((host, port),
                                                      _Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}/metrics"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="deap-tpu-metrics",
            daemon=True)
        self._thread.start()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self) -> "MetricsServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def resolve_registry(spec) -> Optional[MetricsRegistry]:
    """The ``metrics=`` argument convention shared by the scheduler
    and the resilience engine: ``None``/``False`` → metrics off,
    ``True`` → the process default registry, a registry instance →
    itself."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return get_registry()
    if not isinstance(spec, MetricsRegistry):
        raise TypeError(f"metrics= expects a MetricsRegistry, True or "
                        f"None, got {type(spec).__name__}")
    return spec


def phase_histogram(registry: Optional[MetricsRegistry] = None
                    ) -> Histogram:
    """Declare (or fetch) the per-phase request-latency histogram
    ``deap_service_phase_seconds{phase=...}`` on ``registry`` (default:
    the process registry). The tracing plane's metrics face: every
    emitted span with a phase label observes here, generalizing the
    autoscaler's queue-wait signal to all phases (see
    ``telemetry/tracing.py`` ``PHASES`` for the label vocabulary)."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        "deap_service_phase_seconds",
        "Per-phase request latency from the tracing plane "
        "(queue_wait, wal_fsync, admission, compile, device, "
        "checkpoint, wire_encode, replay, build).",
        labels=("phase",), buckets=SERVING_PHASE_BUCKETS)


def startup_phase_histogram(registry: Optional[MetricsRegistry] = None
                            ) -> Histogram:
    """Declare (or fetch) the startup waterfall histogram
    ``deap_service_startup_phase_seconds{phase=...}`` on ``registry``
    (default: the process registry). One observation per phase per
    service start — wal_replay (reading + rebuilding accepted jobs),
    restore (checkpoint payload verify + materialise), prewarm
    (warm-handoff lattice compile/deserialize), first_result (start →
    first completed tenant). The metrics face of the journal's
    ``startup_phase`` rows (docs/advanced/coldstart.md)."""
    reg = registry if registry is not None else get_registry()
    return reg.histogram(
        "deap_service_startup_phase_seconds",
        "Per-phase service startup wall time (wal_replay, restore, "
        "prewarm, first_result) — the cold-start waterfall.",
        labels=("phase",),
        buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 15.0,
                 30.0, 60.0, 120.0))


def alarms_total(registry: Optional[MetricsRegistry] = None
                 ) -> Counter:
    """Declare (or fetch) the HealthMonitor alarm counter
    ``deap_alarms_total{kind=...}`` on ``registry`` (default: the
    process registry). Before ISSUE 19 alarms reached only the
    journal; this is their scrapeable face — the label vocabulary is
    ``probes.HealthMonitor.ALARM_KINDS`` (non_finite, clone_spike,
    premature_convergence, zero_improvement, hlo_drift, driver_stall,
    canary)."""
    reg = registry if registry is not None else get_registry()
    return reg.counter(
        "deap_alarms_total",
        "HealthMonitor alarms fired, by kind (the journal's alarm "
        "rows as a scrapeable counter).",
        labels=("kind",))


def alert_state_gauge(registry: Optional[MetricsRegistry] = None
                      ) -> Gauge:
    """Declare (or fetch) the burn-rate alert state gauge
    ``deap_alert_state{name=...}`` on ``registry`` (default: the
    process registry) — 0 inactive/resolved, 1 pending, 2 firing
    (``telemetry.alerts.ALERT_STATE_VALUES``). The service updates it
    on every alert transition, so a scraper sees exactly what
    ``GET /v1/alerts`` reports."""
    reg = registry if registry is not None else get_registry()
    return reg.gauge(
        "deap_alert_state",
        "Burn-rate alert state by rule name (0 inactive/resolved, "
        "1 pending, 2 firing).",
        labels=("name",))


def metrics_text(registry: Optional[MetricsRegistry] = None) -> str:
    """Prometheus text exposition of ``registry`` (default: the
    process registry) — exactly what ``GET /metrics`` would return."""
    return (registry if registry is not None
            else get_registry()).metrics_text()


def serve_metrics(registry: Optional[MetricsRegistry] = None,
                  host: str = "127.0.0.1", port: int = 0
                  ) -> MetricsServer:
    """Start the ``/metrics`` endpoint for ``registry`` (default: the
    process registry) on a daemon thread; returns the
    :class:`MetricsServer` (``.url`` holds the scrape target —
    ``port=0`` picks a free port). Stdlib ``http.server`` only: no new
    dependency, and safe to run beside a process that holds the card."""
    return MetricsServer(registry if registry is not None
                         else get_registry(), host=host, port=port)
