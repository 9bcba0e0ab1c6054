"""Known-answer canary tenants — the bit-identity contract as a live
production probe.

Port of :mod:`deap_tpu.serving.canary`. Identical submissions produce
byte-identical wire results. A **canary** turns that into a live check: a
tiny fixed-seed job whose wire digest is known in advance, submitted
through the *real* front end (``POST /v1/jobs`` — auth, WAL, command
queue, scheduler, wire encode: the full production path) at a
configured cadence. Every completed canary is compared digest for
digest against the reference:

- match → one ``canary_ok`` journal row (and a 0.0 sample on the
  ``canary_failure`` burn-rate alert);
- mismatch → a ``canary_failed`` journal row, the HealthMonitor
  ``canary`` alarm, a ``deap_alarms_total{kind="canary"}`` increment,
  a 1.0 sample that fires the ``canary_failure`` alert within the same
  boundary, and ``/healthz`` flipping to ``degraded`` (503).

This is the failure nothing else sees: a *silent wrong answer* (a stale
kernel build, a corrupted restore, a broken kernel) still journals
success, returns HTTP 200 and leaves every latency SLO green. The
:class:`~deap_tpu_torch.resilience.faultinject.CorruptResult` fault
proves the detection end to end.

The runner is **driver-thread-only** (called from the service's
boundary fan-out): submission is safe from the driver thread because
``POST /v1/jobs`` never round-trips through the driver — the job is
built on the calling thread, WAL-fsynced, and enqueued with
``put_nowait`` (a full command queue surfaces as a 429 the canary counts
as a shed beat, not a failure).

The reference digest is either precomputed (``expected_digest=``, the
strict mode) or learned trust-on-first-use from the first completed
canary (the default). The digests are the port's own
(:func:`deap_tpu_torch.serving.wire.result_digest`).
"""

from __future__ import annotations

import contextlib
import json
from typing import Any, Dict, Optional

from deap_tpu_torch.telemetry import tracing

__all__ = ["CANARY_JOURNAL_KINDS", "CanarySpec", "CanaryRunner"]

#: journal kinds this module writes (rows land in the scheduler
#: journal via the service; listed in SERVICE_JOURNAL_KINDS)
CANARY_JOURNAL_KINDS = ("canary_ok", "canary_failed")


class CanarySpec:
    """Configuration of the canary population.

    :param problem: registered problem name — must exist in the
        service's registry (submission 404s otherwise and counts as a
        failed beat).
    :param params: fixed params dict; together with the factory's
        fixed seed this pins the expected result bit-for-bit. Keep it
        tiny — the canary rides the production scheduler.
    :param expected_digest: the precomputed wire digest
        (``wire.pack_result(...)['digest']``); ``None`` = learn from
        the first completion (trust-on-first-use).
    :param cadence_boundaries: segment boundaries between canary
        submissions.
    :param max_in_flight: concurrent canaries (1 is right unless the
        cadence outruns the canary's own runtime).
    :param tenant_prefix: canary tenant ids are
        ``<prefix>-<n>`` — also the substring
        :class:`~deap_tpu_torch.resilience.faultinject.CorruptResult`
        targets by default.
    """

    def __init__(self, problem: str,
                 params: Optional[Dict[str, Any]] = None, *,
                 expected_digest: Optional[str] = None,
                 cadence_boundaries: int = 20,
                 max_in_flight: int = 1,
                 tenant_prefix: str = "canary"):
        self.problem = str(problem)
        self.params = dict(params or {})
        self.expected_digest = (str(expected_digest)
                                if expected_digest else None)
        self.cadence_boundaries = max(1, int(cadence_boundaries))
        self.max_in_flight = max(1, int(max_in_flight))
        self.tenant_prefix = str(tenant_prefix)


class CanaryRunner:
    """The live canary loop, driven by the service at every segment
    boundary (driver thread only — no locks, no clocks of its own)."""

    def __init__(self, spec: CanarySpec):
        self.spec = spec
        #: the active reference digest (spec's, or learned)
        self.reference = spec.expected_digest
        self.submitted = 0
        self.ok = 0
        self.failed = 0
        self.shed = 0
        self._in_flight: Dict[str, str] = {}   # tenant id -> request id
        self._countdown = 0   # boundaries until the next submission

    # -- the boundary hook --------------------------------------------

    def on_boundary(self, service, t: float) -> None:
        """One canary beat: verdicts for completed canaries first
        (so an injected corruption is detected at the very boundary
        the canary finishes), then the cadence-gated next submission.
        ``t`` is the service-relative time fed to the alert engine."""
        self._check(service, t)
        self._maybe_submit(service)

    # -- verdicts ------------------------------------------------------

    def _check(self, service, t: float) -> None:
        for tid in list(self._in_flight):
            with service._lock:
                view = service._views.get(tid)
            if view is None:               # withdrawn (shed race)
                del self._in_flight[tid]
                continue
            if not view.done.is_set():
                continue
            rid = self._in_flight.pop(tid)
            payload = view.result_payload()
            digest = payload["digest"] if payload else None
            if digest is not None and view.status == "finished":
                if self.reference is None:
                    # trust-on-first-use: the first completion IS the
                    # known answer; journal it so the learned
                    # reference is auditable
                    self.reference = digest
                    self._ok(service, t, tid, rid, digest,
                             learned=True)
                elif digest == self.reference:
                    self._ok(service, t, tid, rid, digest)
                else:
                    self._failed(service, t, tid, rid, digest,
                                 reason="digest_mismatch")
            else:
                # a canary that cannot complete is a failure of the
                # path, not of bit-identity — same alarm, distinct
                # reason
                self._failed(service, t, tid, rid, digest,
                             reason=f"status:{view.status}")

    def _ok(self, service, t: float, tid: str, rid: str,
            digest: str, learned: bool = False) -> None:
        self.ok += 1
        row = dict(tenant_id=tid, request_id=rid, digest=digest,
                   boundary=self._boundary(service))
        if learned:
            row["learned"] = True
        service.journal.event("canary_ok", **row)
        self._observe(service, t, 0.0)

    def _failed(self, service, t: float, tid: str, rid: str,
                digest: Optional[str], reason: str) -> None:
        self.failed += 1
        service.journal.event(
            "canary_failed", tenant_id=tid, request_id=rid,
            expected=self.reference, got=digest, reason=reason,
            boundary=self._boundary(service))
        if service.health is not None:
            service.health.canary(tenant_id=tid, reason=reason,
                                  expected=self.reference,
                                  got=digest)
        service._alarm_metric("canary")
        self._observe(service, t, 1.0)

    def _observe(self, service, t: float, value: float) -> None:
        if service.alerts is not None:
            service.alerts.observe(t, "canary_fail", value)

    @staticmethod
    def _boundary(service) -> Optional[int]:
        return getattr(service.scheduler, "_boundaries", None)

    # -- submission ----------------------------------------------------

    def prime(self, service) -> None:
        """Bootstrap from the driver's *idle* loop: segment boundaries
        only happen while work runs, so a fully idle service would
        never submit its first canary. When nothing is in flight and
        the cadence countdown has expired, submit directly — the
        canary's own segments then drive the boundary cadence. (The
        countdown still only decrements at boundaries, so an idle
        service is probed when its first beat — or returning traffic —
        restarts the boundary clock, never in a busy loop.)"""
        if self._in_flight or self._countdown > 0:
            return
        self._submit(service)
        self._countdown = self.spec.cadence_boundaries

    def _maybe_submit(self, service) -> None:
        if self._countdown > 0:
            self._countdown -= 1
            return
        if len(self._in_flight) >= self.spec.max_in_flight:
            return
        self._submit(service)
        self._countdown = self.spec.cadence_boundaries

    def _submit(self, service) -> None:
        """Submit one canary through the real front end. Driver-thread
        safe: ``POST /v1/jobs`` builds + WAL-fsyncs on the calling
        thread and enqueues with ``put_nowait`` — it never waits on
        the driver. Sheds (429/503/queue-full) are counted, not
        alarmed: an overloaded service refusing its own canary is load
        shedding working as designed."""
        self.submitted += 1
        tid = f"{self.spec.tenant_prefix}-{self.submitted}"
        body = json.dumps({"problem": self.spec.problem,
                           "params": self.spec.params,
                           "tenant_id": tid}).encode()
        headers: Dict[str, str] = {}
        token = getattr(service, "_canary_token", None)
        if token:
            headers["Authorization"] = "Bearer " + token
        rid = service.next_request_id({})
        ctx = service.trace_context(rid)
        cm = (tracing.use(ctx) if ctx is not None
              else contextlib.nullcontext())
        try:
            with cm:
                code, _, _, _ = service.handle(
                    "POST", "/v1/jobs", headers, body,
                    request_id=rid)
        except Exception:
            code = 0
        if code == 200:
            self._in_flight[tid] = rid
        else:
            self.shed += 1

    # -- inspection ----------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``/healthz`` detail block."""
        return {"submitted": self.submitted, "ok": self.ok,
                "failed": self.failed, "shed": self.shed,
                "in_flight": len(self._in_flight),
                "reference": self.reference}
