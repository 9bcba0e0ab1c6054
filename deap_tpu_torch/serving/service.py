"""Network service plane — the RPC front end over the ask-tell scheduler.

Port of :mod:`deap_tpu.serving.service`: a **stdlib-only** HTTP front
end (``http.server.ThreadingHTTPServer`` + JSON) that serves evolution
as a network service over :class:`~deap_tpu_torch.serving.scheduler.
Scheduler`, with an autoscaling control loop closing the SLO feedback
path and a graceful drain that reuses the resilience plane's checkpoint
machinery.

**The queue handoff.** The scheduler is a single-threaded data
structure by contract (:class:`~deap_tpu_torch.serving.scheduler.
SchedulerBusyError`); an HTTP server is many threads by construction.
One **driver thread** owns the scheduler outright
(``Scheduler.bind_driver``): front-end request threads never touch it —
they enqueue commands onto a ``queue.Queue`` and read a driver-maintained
**mirror** of job state (status/gen/result, updated only by the driver,
read under a lock). The scheduler therefore runs exactly as it does
in-process — same admission order, same segment cadence — which is what
makes the service's per-tenant results **bit-identical** to in-process
runs (equal wire digests, :func:`deap_tpu_torch.serving.wire.
result_digest`).

**The fault-tolerance layer:**

- *Durable admission.* Every accepted job is recorded in a
  crash-consistent **admission WAL** (:class:`~deap_tpu_torch.serving.
  wal.AdmissionWAL` — CRC-framed records, fsync **before** the submit
  ACK) so a ``kill -9`` between accept and the driver's admission loses
  nothing: a restarted service replays every accepted-not-done record
  (rebuilding jobs from the problem registry — journaled
  ``wal_replay``), and tenants that already ran resume from their
  checkpoints. Client-supplied **idempotency keys** make submit retries
  safe: a duplicate key maps to the same tenant (journaled
  ``idempotent_replay``) instead of admitting a twin.
- *Deadlines.* A submit may carry ``deadline_s``; a request already
  expired at the front end gets 504 immediately, and a command whose
  deadline expires while queued is dropped by the driver **before** it
  reaches the scheduler (journaled ``deadline_exceeded``; result polls
  for that tenant return 504).
- *Load shedding.* ``max_pending`` bounds in-flight jobs and the command
  queue is bounded with it: past the bound, submits get **429 +
  Retry-After** — never a hang, never a 500 — journaled ``load_shed``.
- *Driver watchdog.* With ``watchdog_s`` set, a monitor thread journals
  ``driver_stall`` (with the driver thread's stack) when no progress
  heartbeat lands within the budget, fires the HealthMonitor
  ``driver_stall`` alarm, flips ``/healthz`` to 503 and — opt-in
  ``watchdog_exit`` — exits the process so a supervisor restarts into
  the WAL/checkpoint recovery path.
- *Fault injection.* ``fault_plan`` fires deterministic service-shaped
  faults (:class:`~deap_tpu_torch.resilience.faultinject.DropResponse` /
  ``DelaySegment`` / ``KillServiceAt`` / ``TornWAL`` / ``CorruptResult``)
  at the driver-step, segment-boundary, segment, response-write,
  WAL-append and result seams.

**The wire protocol** (all JSON; newline-delimited on streams; every
response echoes an ``X-Request-Id`` — client-supplied or generated —
that is threaded through the journal):

====================================  =================================
``POST /v1/jobs``                     submit ``{"problem", "params",
                                      "tenant_id"?, "idempotency_key"?,
                                      "deadline_s"?}`` (or ``{"jobs":
                                      [...]}``) → ``{"tenant_id"}``
``GET /v1/jobs/<id>``                 status ``{"status", "gen", "ngen"}``
``GET /v1/jobs/<id>/result[?wait=1]`` the wire-encoded result
                                      (byte-exact arrays + digest); 504
                                      when the job's deadline expired
``GET /v1/jobs/<id>/stream``          NDJSON per-segment events until a
                                      terminal event
``GET /v1/results?ids=a,b``           batch result fetch
``GET /healthz``                      liveness (``ok`` / ``warming`` /
                                      ``draining`` / ``stalled`` /
                                      ``degraded``; only ``ok`` answers
                                      200) + a JSON detail body
``GET /metrics``                      the scheduler's Prometheus registry
``GET /v1/alerts``                    the burn-rate alert engine's state
``POST /v1/drain``                    begin graceful drain
====================================  =================================

Live migration (``POST /v1/migrate``, ``drain?handoff=``,
:meth:`EvolutionService.migrate`, :meth:`EvolutionService.adopt_orphans`)
is not ported yet: each raises (or answers 501) naming ROADMAP A13b.

**Problems, not pickles.** A network client cannot ship a toolbox; the
server is built with a registry of named **problem factories**
(``problems={"onemax": factory}``), each mapping ``(tenant_id, params)``
to a :class:`~deap_tpu_torch.serving.tenant.Job` (its generator seeded
from the params). Equal factories → equal bucket keys → shared engines,
exactly as in-process; factories being pure functions of their
arguments is what makes WAL replay deterministic.

**Auth & quotas.** ``tokens={token: {"tenant": name, "max_jobs": n}}``
enables bearer-token auth: a token sees only its own jobs; ``max_jobs``
bounds its in-flight jobs (HTTP 429 past it). Rejections journal an
``auth_rejected`` event.

**Autoscaling.** Every ``autoscale_every``-th driver step reads
``Scheduler.slo_snapshot()`` into an :class:`~deap_tpu_torch.serving.
autoscale.AutoscalePolicy`; applied decisions — lane-budget changes,
predicted-lattice prewarms and pressure spills — each journal an
``autoscale_decision`` event.

**Graceful drain.** On SIGTERM (:class:`deap_tpu_torch.resilience.drain.
DrainSignal`) or ``POST /v1/drain``: new submissions get 503, the
in-flight segment finishes, every resident tenant is checkpointed
(tenant-stamped meta — ``Scheduler.checkpoint_all``), a
``service_drain`` event is journaled, streams receive a terminal
``drained`` event. A new service over the same root replays the WAL and
resumes every drained tenant bit for bit
(``Scheduler(resume_tenants=True)``).
"""

from __future__ import annotations

import contextlib
import http.server
import json
import os
import queue
import sys
import threading
import time
import traceback
import urllib.parse
from typing import Any, Callable, Dict, List, Optional, Tuple

from deap_tpu_torch.resilience.faultinject import (InjectedCorruption,
                                                   InjectedDrop,
                                                   InjectedReject,
                                                   corrupt_pytree)
from deap_tpu_torch.serving import wire
from deap_tpu_torch.serving.autoscale import (AutoscaleConfig,
                                              AutoscalePolicy)
from deap_tpu_torch.serving.canary import CanaryRunner, CanarySpec
from deap_tpu_torch.serving.scheduler import Scheduler
from deap_tpu_torch.serving.tenant import Job, bucket_key
from deap_tpu_torch.serving.wal import AdmissionWAL
from deap_tpu_torch.telemetry import tracing
from deap_tpu_torch.telemetry.alerts import (ALERT_STATE_VALUES,
                                             AlertEngine, service_rules)

__all__ = ["EvolutionService", "SERVICE_JOURNAL_KINDS"]

#: journal kinds this module writes (the JAX service's set). ``alert``
#: rows come from the burn-rate engine (telemetry/alerts.py),
#: ``canary_ok``/``canary_failed`` from the known-answer canary runner
#: (serving/canary.py) — both driven from the service's boundary
#: fan-out, so their rows land in the scheduler journal alongside
#: everything else. The migration kinds are written once live migration
#: is ported (ROADMAP A13b).
SERVICE_JOURNAL_KINDS = ("service_request", "service_drain",
                         "autoscale_decision", "auth_rejected",
                         "wal_replay", "idempotent_replay",
                         "deadline_exceeded", "load_shed",
                         "driver_stall", "trace_span",
                         "startup_phase", "alert",
                         "canary_ok", "canary_failed",
                         "migration_offer", "migration_adopted",
                         "orphan_adopted", "compat_restore")

#: file the warm-handoff lattice manifest persists to, next to the WAL
WARM_MANIFEST_NAME = "warm_manifest.json"

#: warm-manifest file format; readers skip unknown formats
WARM_MANIFEST_FORMAT = 1

#: start the driver (and thus the warm-handoff prewarm) BEFORE the
#: WAL replay's job-factory builds, overlapping the two restart phases;
#: on a single hardware thread the two GIL-bound phases only contend,
#: so the restart path falls back to sequential there
_OVERLAP_REPLAY = os.environ.get(
    "DEAP_TPU_TORCH_OVERLAP_REPLAY", "").lower() in ("1", "true", "yes") \
    or (os.cpu_count() or 1) > 1


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP A13b: live migration)")


class _HttpError(Exception):
    def __init__(self, code: int, message: str,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(message)
        self.code = code
        self.message = message
        self.headers = headers or {}


class _JobView:
    """The driver-maintained mirror of one job, readable by any
    front-end thread under the service lock. The driver writes; HTTP
    threads read — never the scheduler's own Tenant objects. The
    result is held raw and wire-encoded **lazily on the requesting
    thread** (cached), so a thousand finishing tenants never serialise
    base64 on the driver's critical path."""

    __slots__ = ("tenant_id", "problem", "token", "status", "gen",
                 "ngen", "error", "done", "request_id", "deadline",
                 "idempotency_key", "_raw", "_encoded", "_enc_lock")

    def __init__(self, tenant_id: str, problem: str, token: str,
                 request_id: str = "", deadline: Optional[float] = None,
                 idempotency_key: Optional[str] = None):
        self.tenant_id = tenant_id
        self.problem = problem
        self.token = token
        self.status = "submitted"
        self.gen = 0
        self.ngen: Optional[int] = None
        self.error: Optional[str] = None
        self.done = threading.Event()
        self.request_id = request_id
        #: absolute monotonic deadline for ADMISSION (None = none):
        #: the driver drops the submit command past it
        self.deadline = deadline
        self.idempotency_key = idempotency_key
        self._raw: Any = None
        self._encoded: Optional[Dict[str, Any]] = None
        self._enc_lock = threading.Lock()

    def set_result(self, raw: Any) -> None:
        self._raw = raw

    def result_payload(self) -> Optional[Dict[str, Any]]:
        if self._raw is None:
            return None
        with self._enc_lock:
            if self._encoded is None:
                self._encoded = wire.pack_result(self._raw)
            return self._encoded

    def as_dict(self) -> Dict[str, Any]:
        out = {"tenant_id": self.tenant_id, "problem": self.problem,
               "status": self.status, "gen": self.gen,
               "ngen": self.ngen}
        if self.error is not None:
            out["error"] = self.error
        return out


class EvolutionService:
    """Serve a :class:`Scheduler` over a loopback/LAN socket.

    :param root: scheduler root (journal + admission WAL + per-tenant
        run dirs); a restarted service over the same root replays the
        WAL and resumes drained/killed tenants.
    :param problems: ``{name: factory}`` where
        ``factory(tenant_id, params) -> Job`` builds the job
        server-side (the factory owns toolbox/key/init construction,
        so identical submissions are bit-reproducible — the WAL-replay
        determinism contract).
    :param tokens: ``{token: {"tenant": str, "max_jobs": int|None}}``
        bearer auth + per-token in-flight quota; ``None`` = open.
    :param autoscale: ``True`` (default policy) /
        :class:`AutoscalePolicy` / ``None`` (off).
    :param autoscale_every: driver steps between autoscale ticks.
    :param wal: admission WAL on/off (default on; off loses accepted
        jobs on a kill, for overhead comparisons only).
    :param max_pending: bound on in-flight (not yet terminal) jobs —
        past it, submits are shed with 429 + ``Retry-After``
        (``load_shed`` journaled); ``None`` = unbounded. The command
        queue is bounded alongside it.
    :param retry_after_s: the ``Retry-After`` value (seconds) sent
        with shed/quota 429s.
    :param max_poll_s: server-side clamp for client-supplied long-poll
        ``timeout=`` values (malformed values are a 400, never a 500).
    :param watchdog_s: driver-stall budget: with no driver heartbeat
        for this long, journal ``driver_stall`` (+ stack dump), fire
        the HealthMonitor ``driver_stall`` alarm, flip ``/healthz`` to
        503. ``None`` = no watchdog.
    :param watchdog_exit: escalate a detected stall to process exit
        (``os._exit``) so a supervisor restarts into WAL/checkpoint
        recovery. Off by default.
    :param health: a :class:`~deap_tpu_torch.telemetry.probes.HealthMonitor`
        receiving the watchdog's ``driver_stall`` alarms.
    :param fault_plan: a :class:`~deap_tpu_torch.resilience.faultinject.
        FaultPlan` fired at the service's deterministic seams
        (``step`` / ``boundary`` / ``segment`` / ``http_response`` /
        ``wal_append`` / ``result``; ``segment`` fires INSIDE the
        scheduler's segment-latency window, so a ``DelaySegment``
        there is attributable to the segment phase; the ``migration``
        seams of ``KillDuringHandoff`` come with live migration,
        ROADMAP A13b) — the chaos-test hook.
    :param step_hook: optional ``hook(step_count)`` run on the driver
        thread after every scheduler step — the deterministic
        fault-injection seam (drain-mid-segment tests, bursty-load
        generators) in the spirit of ``resilience/faultinject.py``.
    :param alerts: the burn-rate alert plane: ``True``
        (default) builds an :class:`~deap_tpu_torch.telemetry.alerts.
        AlertEngine` over :func:`~deap_tpu_torch.telemetry.alerts.
        service_rules` (canary failures, shed rate, deadline-miss
        rate), journaling ``alert`` transition rows and serving
        ``GET /v1/alerts`` + the ``deap_alert_state`` gauge; pass an
        engine instance for custom rules, or ``None``/``False`` to
        disable. Firing alerts flip ``/healthz`` to ``degraded``
        (503).
    :param canary: a :class:`~deap_tpu_torch.serving.canary.CanarySpec`
        (or prebuilt :class:`~deap_tpu_torch.serving.canary.CanaryRunner`)
        enabling known-answer canary tenants — fixed-seed jobs
        submitted through the real front end at a boundary cadence,
        digest-checked against a precomputed (or trust-on-first-use)
        reference. ``None`` (default) = no canaries.
    :param compat_restore: open the checkpoint compat gate: this
        build may restore checkpoints stamped by a DIFFERENT
        deap_tpu_torch version — the rolling-upgrade adoption path. Every cross-version restore journals a
        ``compat_restore`` row; with the gate closed (default) such
        restores raise ``CheckpointFormatError`` loudly.
    :param scheduler_kwargs: forwarded to :class:`Scheduler`
        (``max_lanes``, ``segment_len``, ``fair_quantum``,
        ``metrics``, ``compile_cache``, ``trace_sample`` — the
        distributed-tracing knob: spans from the HTTP front end, the
        WAL fsync, the command queue and the scheduler lifecycle all
        land in the scheduler journal as ``trace_span`` rows, …).
    """

    def __init__(self, root: str,
                 problems: Dict[str, Callable[[str, dict], Job]], *,
                 host: str = "127.0.0.1", port: int = 0,
                 tokens: Optional[Dict[str, dict]] = None,
                 autoscale=None, autoscale_every: int = 1,
                 wal: bool = True,
                 max_pending: Optional[int] = None,
                 retry_after_s: float = 1.0,
                 max_poll_s: float = 600.0,
                 watchdog_s: Optional[float] = None,
                 watchdog_exit: bool = False,
                 health=None,
                 fault_plan=None,
                 step_hook: Optional[Callable[[int], None]] = None,
                 alerts=True,
                 canary=None,
                 compat_restore: bool = False,
                 **scheduler_kwargs):
        self.root = str(root)
        self.problems = dict(problems)
        self.tokens = dict(tokens) if tokens else None
        if autoscale is True:
            autoscale = AutoscalePolicy(AutoscaleConfig())
        self.policy: Optional[AutoscalePolicy] = autoscale or None
        self.autoscale_every = max(1, int(autoscale_every))
        self.max_pending = (int(max_pending) if max_pending else None)
        self.retry_after_s = float(retry_after_s)
        self.max_poll_s = float(max_poll_s)
        self.watchdog_s = (float(watchdog_s) if watchdog_s else None)
        self.watchdog_exit = bool(watchdog_exit)
        self.health = health
        self.fault_plan = fault_plan
        self.step_hook = step_hook
        scheduler_kwargs.setdefault("resume_tenants", True)
        self.scheduler = Scheduler(self.root,
                                   boundary_cb=self._on_boundary,
                                   fault_hook=self._sched_fault,
                                   **scheduler_kwargs)
        self.journal = self.scheduler.journal

        # ---- active observability plane: burn-rate alert
        # engine + known-answer canary tenants, both driven from the
        # boundary fan-out on the driver thread (deterministic order,
        # no extra threads, no clocks inside the engine)
        if alerts is True:
            alerts = AlertEngine(service_rules(),
                                 journal=self.journal,
                                 on_transition=self._on_alert)
        elif alerts:
            if alerts.journal is None:
                alerts.journal = self.journal
            if alerts.on_transition is None:
                alerts.on_transition = self._on_alert
        self.alerts: Optional[AlertEngine] = alerts or None
        if isinstance(canary, CanarySpec):
            canary = CanaryRunner(canary)
        self.canary: Optional[CanaryRunner] = canary or None
        self._canary_token: Optional[str] = None
        if self.canary is not None and self.tokens is not None:
            # internal quota-free bearer identity for the canary's
            # own submits; never handed out
            self._canary_token = "canary-" + os.urandom(12).hex()
            self.tokens[self._canary_token] = {"tenant": "canary",
                                               "max_jobs": None}
        self._last_boundary: Optional[float] = None
        # previous boundary's cumulative load counters — the deltas
        # are the live shed/deadline-miss rate samples the alert
        # engine burns on
        self._prev_load = {"arrivals": 0, "sheds": 0,
                           "deadline_misses": 0}

        self._lock = threading.Lock()
        # job factories run tensor ops; dozens of request threads
        # building at once contend with the driver — bound the
        # concurrency (2 builders keeps construction overlapped with
        # the driver without thrashing it)
        self._build_sem = threading.Semaphore(2)
        self._views: Dict[str, _JobView] = {}
        self._subs: Dict[str, List[queue.Queue]] = {}
        # bounded command queue: overload surfaces as a 429 at submit
        # time, never as an unbounded memory queue behind a wedged
        # driver (maxsize 0 = unbounded when load shedding is off)
        self._cmds: "queue.Queue" = queue.Queue(
            maxsize=(max(64, 4 * self.max_pending)
                     if self.max_pending else 0))
        self._seq = 0
        self._rid_seq = 0
        self._steps = 0
        self._idem: Dict[str, str] = {}   # idempotency key -> tenant
        if compat_restore:
            # rolling upgrade: this (newer) build may restore
            # checkpoints stamped by a different deap_tpu_torch version
            # — every such restore is journaled as ``compat_restore``
            from deap_tpu_torch.support.checkpoint import \
                set_compat_restore
            set_compat_restore(True)
        self._touched: set = set()        # tenant ids polled since
        #                                   the driver's last drain of
        #                                   the interaction set
        self._rep_jobs: Dict[str, Job] = {}   # driver-thread only
        self._drain_req = threading.Event()
        self._drained = threading.Event()
        self._closed = False
        # watchdog state: the driver refreshes _beat at every loop
        # iteration; the monitor compares against watchdog_s
        self._beat = time.monotonic()
        self._stalled = False
        self._watch_stop = threading.Event()
        self._exit_fn = os._exit   # injectable for tests

        # ---- startup ledger: phase wall-times journaled as
        # ``startup_phase`` rows + the deap_service_startup_phase_
        # seconds{phase} histogram
        self._t_start = time.monotonic()
        self._startup_phases: Dict[str, float] = {}
        self._first_result_pending = True
        from deap_tpu_torch.support import checkpoint as _ckpt_mod
        self._restore_s0 = _ckpt_mod.restore_seconds_total()
        # ---- warm handoff: the previous process's bucket-lattice
        # manifest (problem/params/lanes/horizon per bucket), read
        # BEFORE the driver starts; non-empty → the driver prewarms
        # the recorded lattice before pumping any submit, and
        # /healthz answers "warming" (503) until it finishes
        self._warm_manifest_path = os.path.join(self.root,
                                                WARM_MANIFEST_NAME)
        self._warm_recorded: Dict[str, Dict[str, Any]] = {}
        self._warm_dirty = False
        self._warm_plan = self._read_warm_manifest()
        self._warming = bool(self._warm_plan)
        # prewarm progress for the /healthz detail body
        self._warm_total = len(self._warm_plan)
        self._warm_done = 0

        # ---- durable admission: open (healing any torn tail) and
        # replay the WAL BEFORE any thread starts — recovered jobs are
        # queued as ordinary submit commands the driver applies first
        self.wal: Optional[AdmissionWAL] = None
        if wal:
            self.wal = AdmissionWAL(os.path.join(self.root,
                                                 "admission.wal"))
        # the driver starts FIRST: with a warm manifest present it
        # begins prewarming the recorded lattice immediately, fully
        # overlapped with the main thread's WAL replay below (the
        # job-factory builds) — the two dominant restart phases run
        # concurrently instead of back to back. The replay batch is
        # still the first submit command the driver can see: the HTTP
        # server (the only other producer) starts after replay.
        self._driver = threading.Thread(target=self._drive,
                                        name="deap-tpu-service-driver",
                                        daemon=True)
        if not _OVERLAP_REPLAY:
            if self.wal is not None:
                t0 = time.perf_counter()
                self._replay_wal()
                self._note_startup_phase(
                    "wal_replay", time.perf_counter() - t0)
        self._driver.start()
        if _OVERLAP_REPLAY and self.wal is not None:
            t0 = time.perf_counter()
            self._replay_wal()
            self._note_startup_phase(
                "wal_replay", time.perf_counter() - t0)

        self._httpd = _ServiceHTTPServer((host, port), self)
        self.host, self.port = self._httpd.server_address[:2]
        self.url = f"http://{self.host}:{self.port}"
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="deap-tpu-service-http", daemon=True)
        self._http_thread.start()
        self._watchdog = None
        if self.watchdog_s:
            self._watchdog = threading.Thread(
                target=self._watch, name="deap-tpu-service-watchdog",
                daemon=True)
            self._watchdog.start()
        self.journal.event("service_request", route="start",
                           url=self.url,
                           problems=sorted(self.problems),
                           auth=self.tokens is not None,
                           autoscale=self.policy is not None,
                           wal=self.wal is not None,
                           watchdog_s=self.watchdog_s)

    # ------------------------------------------------- WAL admission ----

    def _replay_wal(self) -> None:
        """Resubmit every accepted-not-done WAL record: jobs that ran
        resume from their tenant-stamped checkpoints, jobs killed
        before admission re-run deterministically from their problem
        factory. Runs in ``__init__`` before the HTTP server exists,
        so replay can never race a fresh submit for the same
        idempotency key — the key map is complete before the first
        request lands."""
        state = self.wal.replay()
        # no ownership resolution: nothing migrates before live
        # migration is ported (ROADMAP A13b), so no tenant was
        # transferred away
        transferred_away: List[str] = []
        self._idem.update(state.idempotency)
        replayed, failed = [], []
        batch: List[Tuple[Job, str]] = []
        for tid, rec in state.pending.items():
            problem = rec.get("problem")
            view = _JobView(tid, str(problem), str(rec.get("token", "")),
                            request_id=str(rec.get("request_id", "")),
                            idempotency_key=rec.get("idempotency_key"))
            self._views[tid] = view
            factory = self.problems.get(problem)
            if factory is None:
                view.status = "failed"
                view.error = f"unknown problem {problem!r} at replay"
                view.done.set()
                self._wal_done(tid, "failed")
                failed.append(tid)
                continue
            try:
                job = factory(tid, dict(rec.get("params") or {}))
            except Exception as e:
                view.status = "failed"
                view.error = f"{type(e).__name__}: {e}"
                view.done.set()
                self._wal_done(tid, "failed")
                failed.append(tid)
                continue
            job.request_id = rec.get("request_id") or None
            job._wal_params = dict(rec.get("params") or {})
            view.ngen = int(job.ngen)
            view.status = "recovered"
            batch.append((job, str(problem)))
            replayed.append(tid)
            # stitch the recovered job back onto its original trace:
            # the request id in the WAL record derives the same
            # trace id the pre-kill process used, and the replay
            # span parents on the request's deterministic root span
            # — one waterfall across the restart, no orphans
            tr = self.scheduler.tracer
            if tr is not None and job.request_id:
                tr.emit("request.replay", 0.0,
                        ctx=tr.context_for(job.request_id),
                        phase="replay", always=True, tenant_id=tid,
                        problem=str(problem))
        if batch:
            # ONE command for the whole recovered cohort: the driver
            # repacks all N tenants in a single boundary instead of N
            # one-at-a-time admissions — and a 200-tenant replay can
            # never deadlock a bounded command queue while the driver
            # is still busy prewarming
            self._cmds.put(("submit_many", batch))
        if state.records or state.tear_offset is not None:
            self.journal.event(
                "wal_replay", records=len(state.records),
                replayed=sorted(replayed), failed=sorted(failed),
                transferred=sorted(transferred_away),
                idempotency_keys=len(state.idempotency),
                torn_tail=state.tear_offset is not None)

    def _wal_accept_batch(self, fresh, token: str,
                          request_id: str) -> None:
        """One durability point for a whole submit batch: N accept
        records, one write, ONE fsync — the ACK follows only after
        the last record is on disk."""
        if self.wal is None or not fresh:
            return
        self.wal.append_many([
            ("accept", dict(tenant_id=job.tenant_id, problem=problem,
                            params=getattr(job, "_wal_params", None),
                            idempotency_key=view.idempotency_key,
                            request_id=request_id, token=token))
            for job, view, problem in fresh])
        self._fire_fault("wal_append", path=self.wal.path,
                         seq=self.wal.n_appended)

    def _wal_done(self, tenant_id: str, status: str) -> None:
        if self.wal is not None:
            try:
                self.wal.append("done", tenant_id=tenant_id,
                                status=status)
            except ValueError:
                pass  # closing race: the WAL replays it next start

    # ---------------------------------------- warm handoff + startup ----

    def _note_startup_phase(self, phase: str, seconds: float) -> None:
        """One startup-waterfall slice: journaled (``startup_phase``)
        and observed on ``deap_service_startup_phase_seconds``."""
        seconds = round(float(seconds), 6)
        self._startup_phases[phase] = seconds
        self.journal.event("startup_phase", phase=phase,
                           seconds=seconds)
        reg = self.scheduler.metrics
        if reg is not None:
            from deap_tpu_torch.telemetry.metrics import \
                startup_phase_histogram
            startup_phase_histogram(reg).observe(seconds, phase=phase)

    def _read_warm_manifest(self) -> List[Dict[str, Any]]:
        """The previous process's lattice records (tolerant read: a
        missing/torn/foreign-format manifest is an empty plan)."""
        try:
            with open(self._warm_manifest_path, "r") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return []
        if not isinstance(doc, dict) \
                or doc.get("format") != WARM_MANIFEST_FORMAT:
            return []
        buckets = doc.get("buckets")
        return [b for b in buckets if isinstance(b, dict)] \
            if isinstance(buckets, list) else []

    def _write_warm_manifest(self) -> None:
        """Atomically persist the live lattice next to the WAL —
        driver thread only (it owns ``_warm_recorded``)."""
        doc = {"format": WARM_MANIFEST_FORMAT,
               "buckets": [dict(v, label=k) for k, v in
                           sorted(self._warm_recorded.items())]}
        tmp = self._warm_manifest_path + ".tmp"
        try:
            with open(tmp, "w") as fh:
                json.dump(doc, fh, sort_keys=True, indent=1)
            os.replace(tmp, self._warm_manifest_path)
            self._warm_dirty = False
        except OSError:
            pass  # best-effort: a missed write only costs warmth

    def _record_warm_bucket(self, label: str, problem: str,
                            params: Optional[dict], lanes: int,
                            horizon: int) -> None:
        """Fold one bucket observation into the warm manifest (driver
        thread only); persists when the lattice actually changed."""
        prev = self._warm_recorded.get(label)
        entry = {"problem": str(problem),
                 "params": dict(params or {}),
                 "lanes": int(lanes), "horizon": int(horizon)}
        if prev is not None:
            # keep the first representative's params (any tenant of
            # the bucket reproduces the same programs — bucket_key is
            # tenant-blind), refresh only the tuned knobs: per-tenant
            # param churn then never rewrites the manifest
            entry["problem"], entry["params"] = \
                prev["problem"], prev["params"]
            entry["horizon"] = max(entry["horizon"], prev["horizon"])
        if prev != entry:
            self._warm_recorded[label] = entry
            self._warm_dirty = True
        if self._warm_dirty:
            self._write_warm_manifest()

    def _warm_start(self) -> None:
        """Prewarm the recorded lattice BEFORE the driver pumps any
        command — runs on the driver thread (the scheduler's exclusive
        owner), so the replayed cohort's first repack finds its
        programs already loaded (from the artifact store when one is
        active, else compiled). ``/healthz`` answers ``warming`` (503)
        for the duration; any failure degrades to a normal cold start."""
        plan, self._warm_plan = self._warm_plan, []
        if not plan:
            self._warming = False
            return
        t0 = time.perf_counter()
        warmed = 0
        try:
            for rec in plan:
                self._warm_done += 1   # buckets attempted, for /healthz
                factory = self.problems.get(str(rec.get("problem")))
                if factory is None:
                    continue
                try:
                    job = factory("__prewarm__",
                                  dict(rec.get("params") or {}))
                    warmed += self.scheduler.prewarm(
                        [job], lane_counts=[int(rec.get("lanes", 1))])
                except Exception:
                    continue  # cold-compile fallback for this bucket
        finally:
            self._warming = False
            self._note_startup_phase("prewarm",
                                     time.perf_counter() - t0)
            self.journal.event("service_request", route="warm_start",
                               buckets=len(plan), warmed=warmed)

    def _note_first_result(self) -> None:
        """First tenant completion after start: close the startup
        ledger (restore delta + start→first-result wall)."""
        self._first_result_pending = False
        from deap_tpu_torch.support.checkpoint import \
            restore_seconds_total
        self._note_startup_phase(
            "restore", restore_seconds_total() - self._restore_s0)
        self._note_startup_phase(
            "first_result", time.monotonic() - self._t_start)

    def _fire_fault(self, event: str, **ctx) -> None:
        if self.fault_plan is not None:
            self.fault_plan.fire(event, **ctx)

    def _on_alert(self, tr: Dict[str, Any]) -> None:
        """Alert transitions → the ``deap_alert_state{name}`` gauge
        (0 inactive/resolved, 1 pending, 2 firing)."""
        reg = self.scheduler.metrics
        if reg is not None:
            from deap_tpu_torch.telemetry.metrics import alert_state_gauge
            alert_state_gauge(reg).set(
                ALERT_STATE_VALUES[tr["to"]], name=tr["name"])

    def _alarm_metric(self, kind: str) -> None:
        """HealthMonitor alarms → ``deap_alarms_total{kind}`` —
        alarms used to reach only the journal."""
        reg = self.scheduler.metrics
        if reg is not None:
            from deap_tpu_torch.telemetry.metrics import alarms_total
            alarms_total(reg).inc(kind=kind)

    def _sched_fault(self, event: str, **ctx) -> None:
        """The scheduler's fault seam (``fault_hook``), stamped with
        the driver step count so step-addressed faults
        (``DelaySegment(step=n, event="segment")``) fire inside the
        segment-latency window of a chosen step."""
        self._fire_fault(event, step=self._steps + 1, **ctx)

    # ------------------------------------------------------- tracing ----

    def trace_context(self, request_id: str,
                      traceparent: Optional[str] = None):
        """The request's :class:`~deap_tpu_torch.telemetry.tracing.
        TraceContext` (honouring an incoming ``traceparent`` header),
        or ``None`` when the scheduler was built without
        ``trace_sample``."""
        tr = self.scheduler.tracer
        if tr is None:
            return None
        return tr.context_for(request_id, traceparent)

    def _tspan(self, name: str, **kw):
        """A tracer span bound to the ambient request context — a
        no-op context manager when tracing is off or the caller is
        outside a traced request."""
        tr = self.scheduler.tracer
        if tr is None or tracing.current() is None:
            return contextlib.nullcontext()
        return tr.span(name, **kw)

    def _result_payload(self, view: _JobView):
        """``view.result_payload()`` with the first (cache-filling)
        wire encode timed into the *submitting* request's trace — a
        later poll pays the encode, so the span joins the trace that
        owns the tenant, not the poll's."""
        tr = self.scheduler.tracer
        if tr is None or not view.request_id \
                or view._encoded is not None or view._raw is None:
            return view.result_payload()
        t0 = time.perf_counter()
        payload = view.result_payload()
        tr.emit("wire.encode", time.perf_counter() - t0,
                ctx=tr.context_for(view.request_id),
                phase="wire_encode", tenant_id=view.tenant_id)
        return payload

    # ----------------------------------------------------- lifecycle ----

    @property
    def draining(self) -> bool:
        return self._drain_req.is_set()

    @property
    def stalled(self) -> bool:
        """The watchdog's current verdict (``/healthz`` mirrors it)."""
        return self._stalled

    def drain(self, wait: bool = True,
              timeout: Optional[float] = None) -> bool:
        """Begin graceful drain: refuse new submissions, finish the
        in-flight segment, checkpoint every resident tenant, journal
        ``service_drain``, end streams. Safe to call from any thread —
        including a signal handler (``wait=False`` there). Returns
        True once drained (always True when ``wait=False``... check
        :attr:`drained`)."""
        self._drain_req.set()
        try:
            self._cmds.put_nowait(("wake",))
        except queue.Full:
            pass  # the driver polls the drain flag regardless
        if wait:
            return self._drained.wait(timeout)
        return True

    @property
    def drained(self) -> bool:
        return self._drained.is_set()

    # ------------------------------------- zero-downtime operations ----

    def migrate(self, tenant_id: str, target_url: str,
                timeout_s: float = 30.0,
                wait_s: float = 120.0) -> Dict[str, Any]:
        """Live-migrate one tenant to the peer service at
        ``target_url`` — not ported yet: raises
        ``NotImplementedError`` naming ROADMAP A13b."""
        raise _not_ported("EvolutionService.migrate")

    def adopt_orphans(self, fleet_root: str,
                      process_id: Optional[str] = None) -> List[str]:
        """Adopt the accepted-not-terminal tenants of dead fleet members
        — not ported yet: raises ``NotImplementedError`` naming ROADMAP
        A13b."""
        raise _not_ported("EvolutionService.adopt_orphans")

    def install_signal_handlers(self):
        """Install a SIGTERM/SIGINT → :meth:`drain` handler (main
        thread only); returns the :class:`~deap_tpu_torch.resilience.drain.
        DrainSignal` so the caller can uninstall it."""
        from deap_tpu_torch.resilience.drain import DrainSignal
        ds = DrainSignal(lambda signum: self.drain(wait=False))
        ds.install()
        return ds

    def close(self, timeout: float = 30.0) -> None:
        if self._closed:
            return
        self._closed = True
        self._watch_stop.set()
        self.drain(wait=True, timeout=timeout)
        self._httpd.shutdown()
        self._httpd.server_close()
        self._http_thread.join(timeout=5)
        self._driver.join(timeout=timeout)
        if self.wal is not None:
            self.wal.close()

    def __enter__(self) -> "EvolutionService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------- the driver ----

    def _drive(self) -> None:
        sched = self.scheduler
        sched.bind_driver()
        try:
            # warm handoff: restore the previous process's lattice
            # before touching the command queue — the WAL-replay batch
            # then repacks against already-loaded programs
            self._warm_start()
            while not self._drain_req.is_set():
                self._beat = time.monotonic()
                self._drain_touches()
                runnable = sched.runnable
                n = self._pump_commands(block=not runnable)
                # admission grace: while submissions are streaming in,
                # give the queue a few 10 ms windows before stepping —
                # rapid-fire submits land in ONE repack at a warmed
                # lattice point instead of compiling a 1-lane program
                # for the first arrival (measured: a 2.1 s stall)
                grace = 0
                while n and grace < 5 and not self._drain_req.is_set():
                    time.sleep(0.01)
                    n = self._pump_commands(block=False)
                    grace += 1
                if self._drain_req.is_set():
                    break
                if sched.runnable:
                    sched.step()
                    self._steps += 1
                    self._beat = time.monotonic()
                    self._fire_fault("step", step=self._steps)
                    if self.step_hook is not None:
                        self.step_hook(self._steps)
                    if self._steps % self.autoscale_every == 0:
                        self._autoscale_tick()
                elif self.canary is not None:
                    # idle bootstrap: with nothing runnable there are
                    # no boundaries, so the canary primes itself here
                    self.canary.prime(self)
            # ------------------------------------------- graceful drain
            self._pump_commands(block=False)
            saved = sched.checkpoint_all()
            open_views = []
            with self._lock:
                for v in self._views.values():
                    if not v.done.is_set():
                        v.status = "drained"
                        open_views.append(v)
            self.journal.event(
                "service_drain",
                checkpointed=sorted(saved),
                open_tenants=sorted(v.tenant_id for v in open_views),
                migrated=[], steps=self._steps)
            for v in open_views:
                self._publish(v.tenant_id,
                              {"event": "drained",
                               "tenant_id": v.tenant_id, "gen": v.gen})
                self._publish(v.tenant_id, None)
                v.done.set()
        finally:
            try:
                sched.close()
            finally:
                self._drained.set()

    def _drain_touches(self) -> None:
        """Fold the front end's interaction set into the tenants'
        idleness clocks (the spill actuator's signal) — driver thread
        only, so the scheduler contract holds."""
        with self._lock:
            if not self._touched:
                return
            touched, self._touched = self._touched, set()
        for tid in touched:
            t = self.scheduler.tenants.get(tid)
            if t is not None:
                t.note_interaction()

    def _pump_commands(self, block: bool) -> int:
        try:
            cmd = self._cmds.get(timeout=0.05) if block \
                else self._cmds.get_nowait()
        except queue.Empty:
            return 0
        n = 0
        while True:
            self._apply(cmd)
            n += 1
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return n

    def _apply(self, cmd: Tuple) -> None:
        if cmd[0] == "wake":
            return
        if cmd[0] == "submit":
            _, job, problem = cmd
            self._apply_submit(job, problem)
        elif cmd[0] == "submit_many":
            # 3-tuples are WAL-replay era commands with no enqueue
            # stamp; fresh submits carry one for the cmd.queue span
            t_enq = cmd[2] if len(cmd) > 2 else None
            for job, problem in cmd[1]:
                self._apply_submit(job, problem, t_enq=t_enq)

    def _apply_submit(self, job: Job, problem: str,
                      t_enq: Optional[float] = None) -> None:
        # admission is ASYNCHRONOUS: the front end already built the
        # Job (factories run on request threads — they must be
        # thread-safe pure constructors), ACKed, and registered the
        # view; the driver only performs the single-threaded scheduler
        # mutation. Scheduler-side errors surface through the mirror
        # (status "failed") and the stream's terminal event.
        tid = job.tenant_id
        with self._lock:
            view = self._views[tid]
        # the command-queue handoff latency (front-end ACK → driver
        # pickup) as a detail span — sampled, per tenant
        tr = self.scheduler.tracer
        if tr is not None and t_enq is not None and view.request_id:
            tr.emit("cmd.queue", max(0.0, time.monotonic() - t_enq),
                    ctx=tr.context_for(view.request_id),
                    tenant_id=tid)
        # deadline admission control: an expired command is DROPPED
        # here — it never reaches the scheduler; the client's result
        # poll sees 504
        if view.deadline is not None \
                and time.monotonic() > view.deadline:
            view.error = "deadline expired before admission"
            view.status = "deadline_exceeded"
            view.done.set()
            self.journal.event("deadline_exceeded", tenant_id=tid,
                               problem=problem, stage="driver",
                               request_id=view.request_id)
            self.scheduler.note_deadline_miss()
            self._wal_done(tid, "deadline_exceeded")
            self._publish(tid, {"event": "deadline_exceeded",
                                "tenant_id": tid})
            self._publish(tid, None)
            return
        try:
            self.scheduler.submit(job)
        except Exception as e:
            view.error = f"{type(e).__name__}: {e}"
            view.status = "failed"
            view.done.set()
            self.journal.event("service_request", route="submit",
                               tenant_id=tid, problem=problem,
                               request_id=view.request_id,
                               error=view.error)
            self._wal_done(tid, "failed")
            self._publish(tid, {"event": "failed", "tenant_id": tid,
                                "error": view.error})
            self._publish(tid, None)
            return
        bucket = self.scheduler.buckets[bucket_key(job)]
        self._rep_jobs.setdefault(bucket.label, job)
        self._record_warm_bucket(bucket.label, problem,
                                 getattr(job, "_wal_params", None),
                                 bucket.max_lanes, bucket.horizon)
        tenant = self.scheduler.tenants[tid]
        view.status = ("resuming" if tenant.has_checkpoint
                       else "queued")
        self.journal.event("service_request", route="submit",
                           tenant_id=tid, problem=problem,
                           request_id=view.request_id,
                           resume=tenant.has_checkpoint)

    # boundary fan-out: runs on the driver thread inside step()
    def _on_boundary(self, bucket_label: str,
                     updates: List[Dict[str, Any]]) -> None:
        self._beat = time.monotonic()
        self._last_boundary = self._beat
        self._fire_fault("boundary", step=self._steps + 1,
                         bucket=bucket_label)
        for u in updates:
            t = u["tenant"]
            with self._lock:
                view = self._views.get(t.id)
                has_subs = bool(self._subs.get(t.id))
            if view is None:
                continue
            view.gen = u["gen"]
            ev = {"event": "segment", "tenant_id": t.id,
                  "bucket": bucket_label,
                  "gen_from": u["gen_before"], "gen": u["gen"]}
            if has_subs and u["chunk"] is not None:
                # the per-segment results: this segment's logbook
                # record rows, byte-exact on the wire
                ev["records"] = wire.pack(u["chunk"])
            self._publish(t.id, ev)
            if u["finished"]:
                raw = t.result
                try:
                    # the silent-wrong-answer seam: a CorruptResult
                    # fault raises here and the raw result is
                    # perturbed BEFORE the view publishes it — every
                    # success signal below still fires, only the
                    # canary's digest compare can tell
                    self._fire_fault("result", step=self._steps + 1,
                                     tenant_id=t.id)
                except InjectedCorruption:
                    raw = corrupt_pytree(raw)
                view.set_result(raw)
                view.status = t.status
                self._wal_done(t.id, t.status)
                if self._first_result_pending:
                    self._note_first_result()
                view.done.set()
                self._publish(t.id, {"event": t.status,
                                     "tenant_id": t.id,
                                     "gen": u["gen"]})
                self._publish(t.id, None)
        if self.canary is not None or self.alerts is not None:
            self._observability_tick()

    def _observability_tick(self) -> None:
        """Driver thread, once per boundary fan-out: canary verdicts
        and cadence submissions first (so an injected corruption is
        alarmed at the boundary it finishes), then the live alert
        samples — this boundary's shed/deadline-miss deltas — and one
        deterministic alert-engine tick."""
        t = time.monotonic() - self._t_start
        if self.canary is not None:
            self.canary.on_boundary(self, t)
        if self.alerts is None:
            return
        counts = self.scheduler.load_counts()
        arrivals = sum(counts["arrivals"].values())
        d_arr = arrivals - self._prev_load["arrivals"]
        d_shed = counts["sheds"] - self._prev_load["sheds"]
        d_miss = (counts["deadline_misses"]
                  - self._prev_load["deadline_misses"])
        self._prev_load = {"arrivals": arrivals,
                           "sheds": counts["sheds"],
                           "deadline_misses": counts["deadline_misses"]}
        offered = d_arr + d_shed
        if offered > 0:
            self.alerts.observe(t, "shed_rate", d_shed / offered)
            self.alerts.observe(t, "deadline_miss_rate",
                                d_miss / max(1, d_arr))
        self.alerts.tick(t)

    # ------------------------------------------------------ watchdog ----

    def _watch(self) -> None:
        """The driver-stall monitor: compare the driver's heartbeat
        against ``watchdog_s``; on a stall, journal ``driver_stall``
        with a stack dump of the driver thread, fire the HealthMonitor
        alarm, flip ``/healthz`` to 503 and (opt-in) escalate to
        process exit so a supervisor restarts into WAL/checkpoint
        recovery. Re-arms — and journals the recovery — when the
        heartbeat returns."""
        interval = min(self.watchdog_s / 4.0, 0.5)
        while not self._watch_stop.wait(interval):
            if self._drain_req.is_set():
                # drain's checkpoint_all can legitimately take long;
                # the watchdog stands down once drain begins
                continue
            age = time.monotonic() - self._beat
            if age <= self.watchdog_s:
                if self._stalled:
                    self._stalled = False
                    self.journal.event("driver_stall", recovered=True,
                                       steps=self._steps)
                continue
            if self._stalled:
                continue  # already reported; wait for recovery
            self._stalled = True
            frames = sys._current_frames().get(self._driver.ident)
            stack = ("".join(traceback.format_stack(frames))
                     if frames is not None
                     else "<driver thread not running>")
            self.journal.event(
                "driver_stall", stalled_s=round(age, 3),
                steps=self._steps, budget_s=self.watchdog_s,
                escalate=self.watchdog_exit, stack=stack[-4000:])
            if self.health is not None:
                self.health.driver_stall(stalled_s=round(age, 3),
                                         steps=self._steps)
            self._alarm_metric("driver_stall")
            if self.watchdog_exit:
                # no drain, no flush beyond the journal line above
                # (journal writes flush per row): the recovery path is
                # the supervisor restarting into WAL replay + resume
                self._exit_fn(70)

    def _autoscale_tick(self) -> None:
        if self.policy is None:
            return
        sched = self.scheduler
        snap = sched.slo_snapshot()
        decision = self.policy.decide(snap)
        if not decision:
            return
        for label, n in decision.lane_counts.items():
            before = snap[label]["lanes"]
            applied = sched.set_bucket_lanes(label, n)
            if label in self._warm_recorded:
                # the tuned knob follows into the warm manifest, so a
                # restart prewarms the lattice point the autoscaler
                # actually converged on, not the configured default
                rec = self._warm_recorded[label]
                self._record_warm_bucket(label, rec["problem"],
                                         rec["params"], applied,
                                         rec["horizon"])
            self.journal.event(
                "autoscale_decision", action="lanes", bucket=label,
                lanes_from=before, lanes_to=applied,
                reason=decision.reasons.get(label, ""),
                queue_depth=snap[label]["queue_depth"],
                queue_wait_p99=snap[label]["queue_wait_p99"])
        for label, n in decision.prewarm:
            job = self._rep_jobs.get(label)
            if job is None:
                continue
            # on the driver thread: nothing is built per lane count, so
            # this builds only for a bucket that has not run yet
            t0 = time.perf_counter()
            try:
                sched.prewarm([job], lane_counts=[n])
            except Exception as e:
                self.journal.event("autoscale_decision", action="prewarm",
                                   bucket=label, lanes=n,
                                   error=f"{type(e).__name__}: {e}")
                continue
            self.journal.event(
                "autoscale_decision", action="prewarm", bucket=label,
                lanes=n, compile_s=round(time.perf_counter() - t0, 4))
        for tid in decision.spill:
            try:
                sched.request_spill(tid)
            except KeyError:
                continue
            t = sched.tenants.get(tid)
            self.journal.event("autoscale_decision", action="spill",
                               tenant_id=tid,
                               **(sched._rid(t) if t is not None
                                  else {}))

    # ------------------------------------------------- pub/sub plumbing ----

    def _subscribe(self, tid: str) -> "queue.Queue":
        q: "queue.Queue" = queue.Queue()
        with self._lock:
            self._subs.setdefault(tid, []).append(q)
        return q

    def _unsubscribe(self, tid: str, q: "queue.Queue") -> None:
        with self._lock:
            subs = self._subs.get(tid, [])
            if q in subs:
                subs.remove(q)
            if not subs:
                self._subs.pop(tid, None)

    def _publish(self, tid: str, event: Optional[dict]) -> None:
        with self._lock:
            subs = list(self._subs.get(tid, []))
        for q in subs:
            q.put(event)

    # ----------------------------------------------------- HTTP surface ----

    def _auth(self, headers) -> Tuple[str, dict]:
        """Returns (token, info); raises :class:`_HttpError` (and
        journals ``auth_rejected``) on missing/unknown tokens."""
        if self.tokens is None:
            return "", {}
        auth = headers.get("Authorization", "")
        token = auth[7:] if auth.startswith("Bearer ") else ""
        if not token:
            self.journal.event("auth_rejected", reason="missing_token")
            raise _HttpError(401, "missing bearer token")
        info = self.tokens.get(token)
        if info is None:
            self.journal.event("auth_rejected", reason="unknown_token")
            raise _HttpError(403, "unknown token")
        return token, info

    def _active_jobs(self, token: Optional[str] = None) -> int:
        with self._lock:
            return sum(1 for v in self._views.values()
                       if not v.done.is_set()
                       and (token is None or v.token == token))

    def _check_quota(self, token: str, info: dict,
                     n_new: int = 1) -> None:
        max_jobs = info.get("max_jobs") if info else None
        if max_jobs is None:
            return
        active = self._active_jobs(token)
        if active + n_new > int(max_jobs):
            self.journal.event(
                "auth_rejected", reason="quota",
                tenant=info.get("tenant"), max_jobs=int(max_jobs),
                active=active)
            raise _HttpError(
                429,
                f"quota exceeded: {active} in-flight + "
                f"{n_new} new jobs > max_jobs={max_jobs}",
                headers={"Retry-After": self._retry_after()})

    def _retry_after(self) -> str:
        return str(max(1, int(round(self.retry_after_s))))

    def _check_load(self, n_new: int, request_id: str) -> None:
        """The load-shedding gate: past ``max_pending`` in-flight
        jobs, submits are refused with 429 + Retry-After — the bounded
        queue never hangs a client and never 500s."""
        if self.max_pending is None:
            return
        active = self._active_jobs()
        if active + n_new > self.max_pending:
            self.journal.event("load_shed", active=active,
                               new=n_new,
                               max_pending=self.max_pending,
                               request_id=request_id)
            self.scheduler.note_shed(n_new)
            raise _HttpError(
                429,
                f"overloaded: {active} jobs in flight + {n_new} new "
                f"> max_pending={self.max_pending}; retry later",
                headers={"Retry-After": self._retry_after()})

    def _view_for(self, tid: str, token: str) -> _JobView:
        with self._lock:
            view = self._views.get(tid)
        if view is None:
            raise _HttpError(404, f"unknown tenant {tid!r}")
        if self.tokens is not None and view.token != token:
            self.journal.event("auth_rejected", reason="foreign_tenant",
                               tenant_id=tid)
            raise _HttpError(403, "tenant belongs to another token")
        with self._lock:
            self._touched.add(tid)
        return view

    def _q_float(self, qs, name: str, default: float,
                 max_value: Optional[float] = None) -> float:
        """Parse one float query parameter defensively: malformed
        values are a 400 (never an unhandled ValueError → 500) and the
        result is clamped to ``[0, max_value]`` — an unclamped
        client-supplied ``timeout=`` must not pin a request thread
        for an arbitrary duration."""
        raw = qs.get(name, [None])[0]
        if raw is None or raw == "":
            value = float(default)
        else:
            try:
                value = float(raw)
            except ValueError:
                raise _HttpError(400, f"malformed {name}={raw!r}: "
                                      "expected a number")
        if value < 0.0:
            value = 0.0
        if max_value is not None:
            value = min(value, float(max_value))
        return value

    def _deadline_of(self, spec: dict, headers) -> Optional[float]:
        """The spec's admission deadline as an absolute monotonic
        stamp (``deadline_s`` field, falling back to an
        ``X-Deadline-S`` request header); malformed values are 400."""
        raw = spec.get("deadline_s")
        if raw is None:
            raw = headers.get("X-Deadline-S")
        if raw is None:
            return None
        try:
            d = float(raw)
        except (TypeError, ValueError):
            raise _HttpError(400, f"malformed deadline_s={raw!r}")
        return time.monotonic() + max(0.0, d)

    def _build_one(self, spec: dict, token: str, info: dict):
        problem = spec.get("problem")
        if problem not in self.problems:
            raise _HttpError(404, f"unknown problem {problem!r} "
                                  f"(have: {sorted(self.problems)})")
        tid = spec.get("tenant_id")
        if tid is None:
            with self._lock:
                self._seq += 1
                prefix = (info.get("tenant", "job")
                          if info else "job")
                tid = f"{prefix}-{self._seq}"
        tid = str(tid)
        # build the Job HERE, on the request thread: factories are
        # pure constructors (seed → tensors), so clients construct jobs
        # off the driver's critical path.
        # Construction errors report synchronously; the semaphore
        # bounds concurrent builds. tenant_id collisions are
        # re-checked at registration.
        params = dict(spec.get("params") or {})
        try:
            with self._build_sem:
                job = self.problems[problem](tid, dict(params))
        except Exception as e:
            raise _HttpError(400, f"{type(e).__name__}: {e}")
        if job.tenant_id != tid:
            raise _HttpError(400,
                             f"problem factory {problem!r} returned "
                             f"tenant id {job.tenant_id!r}, expected "
                             f"{tid!r}")
        # stash the raw params for the WAL accept record (replay
        # rebuilds the job through the same factory)
        job._wal_params = params
        view = _JobView(tid, problem, token)
        view.ngen = int(job.ngen)
        return job, view, problem

    def _idem_hit(self, key: Optional[str], token: str
                  ) -> Optional[_JobView]:
        """An existing tenant for this idempotency key (token-checked)
        — the safe-retry path: the client's first submit may have been
        accepted and durably WAL-logged while its response was lost."""
        if not key:
            return None
        with self._lock:
            tid = self._idem.get(str(key))
            view = self._views.get(tid) if tid is not None else None
        if view is None:
            return None
        if self.tokens is not None and view.token != token:
            self.journal.event("auth_rejected", reason="foreign_tenant",
                               tenant_id=view.tenant_id)
            raise _HttpError(403, "idempotency key belongs to another "
                                  "token")
        return view

    def _handle_submit(self, body: dict, token: str, info: dict,
                       headers, request_id: str) -> Tuple[int, dict]:
        """Single (``{"problem", "params", "tenant_id"?,
        "idempotency_key"?, "deadline_s"?}``) or batch
        (``{"jobs": [spec, ...]}``) submission — the batch form costs
        one HTTP round trip for N jobs, which matters when the client
        and server share cores."""
        if self.draining:
            raise _HttpError(503, "service is draining",
                             headers={"Retry-After": self._retry_after()})
        specs = body.get("jobs")
        batch = specs is not None
        if not batch:
            specs = [body]
        if not isinstance(specs, list) or not specs:
            raise _HttpError(400, '"jobs" must be a non-empty list')

        # resolve idempotent replays FIRST: retries of already-accepted
        # jobs cost no quota, no load-shed slot, no rebuild
        resolved: List[Optional[_JobView]] = []
        n_new = 0
        for s in specs:
            if not isinstance(s, dict):
                raise _HttpError(400, "each job spec must be an object")
            hit = self._idem_hit(s.get("idempotency_key"), token)
            resolved.append(hit)
            if hit is None:
                n_new += 1
            else:
                self.journal.event("idempotent_replay",
                                   tenant_id=hit.tenant_id,
                                   via="idempotency_key",
                                   request_id=request_id)
        if n_new:
            self._check_quota(token, info, n_new=n_new)
            self._check_load(n_new, request_id)

        # deadlines: a spec already expired at the front end is 504
        # right here — it never enters the command queue
        deadlines = [self._deadline_of(s, headers) for s in specs]
        now = time.monotonic()
        for s, d, hit in zip(specs, deadlines, resolved):
            if hit is None and d is not None and now > d:
                self.journal.event("deadline_exceeded",
                                   tenant_id=s.get("tenant_id"),
                                   problem=s.get("problem"),
                                   stage="frontend",
                                   request_id=request_id)
                self.scheduler.note_deadline_miss()
                raise _HttpError(504, "deadline expired before "
                                      "admission")

        built = []   # (job, view, problem) for the genuinely-new specs
        with self._tspan("submit.build", phase="build",
                         n_jobs=n_new):
            for s, hit, d in zip(specs, resolved, deadlines):
                if hit is not None:
                    continue
                job, view, problem = self._build_one(s, token, info)
                view.request_id = request_id
                view.deadline = d
                view.idempotency_key = s.get("idempotency_key")
                built.append((job, view, problem))
        with self._lock:
            dup = []
            for i, (job, view, _) in enumerate(built):
                old = self._views.get(job.tenant_id)
                if old is None:
                    continue
                if old.problem == view.problem \
                        and old.status != "failed":
                    # tenant-id replay: the same identity resubmitted
                    # (a post-restart client re-offering a drained/
                    # recovered job) maps to the live view instead of
                    # admitting a twin or 409ing the resume path
                    built[i] = (None, old, view.problem)
                else:
                    dup.append(job.tenant_id)
            if dup:
                raise _HttpError(409, f"tenant id(s) {dup} already "
                                      "submitted")
            for job, view, _ in built:
                if job is None:
                    continue
                self._views[job.tenant_id] = view
                if view.idempotency_key:
                    self._idem[str(view.idempotency_key)] = \
                        job.tenant_id
        fresh = [(job, view, problem) for job, view, problem in built
                 if job is not None]
        for i, (job, view, problem) in enumerate(built):
            if job is None and view.status != "failed":
                self.journal.event("idempotent_replay",
                                   tenant_id=view.tenant_id,
                                   via="tenant_id",
                                   request_id=request_id)
        for job, _, _ in fresh:
            job.request_id = request_id
        # durability point: every accept record is fsync'd BEFORE the
        # ACK below — "the client heard yes" implies "a restart
        # replays it" (one fsync for the whole batch)
        wal_cm = (self._tspan("wal.fsync", phase="wal_fsync",
                              always=True, n_jobs=len(fresh))
                  if self.wal is not None and fresh
                  else contextlib.nullcontext())
        with wal_cm:
            self._wal_accept_batch(fresh, token, request_id)
        if fresh:
            # async admission: ACK now, the driver applies at its next
            # command pump — a request thread never waits out a segment
            try:
                self._cmds.put_nowait(
                    ("submit_many",
                     [(job, problem) for job, _, problem in fresh],
                     time.monotonic()))
            except queue.Full:
                # bounded command queue saturated: shed — the WAL
                # records stand, so a retry (or restart) replays them;
                # views are withdrawn so the retry is a fresh submit
                with self._lock:
                    for job, view, _ in fresh:
                        self._views.pop(job.tenant_id, None)
                        if view.idempotency_key:
                            self._idem.pop(str(view.idempotency_key),
                                           None)
                self.journal.event(
                    "load_shed", reason="command_queue_full",
                    new=len(fresh), request_id=request_id)
                self.scheduler.note_shed(len(fresh))
                raise _HttpError(
                    429, "command queue full; retry later",
                    headers={"Retry-After": self._retry_after()})
        if self._drained.is_set():
            # lost race with a concurrent drain: the driver's final
            # pump may never see this command — fail the views loudly
            for job, view, _ in fresh:
                view.status = "drained"
                view.done.set()
        # the response tenant ids, in spec order (replays included)
        tids = []
        it = iter(built)
        for hit in resolved:
            if hit is not None:
                tids.append(hit.tenant_id)
            else:
                tids.append(next(it)[1].tenant_id)
        if batch:
            return 200, {"tenant_ids": tids, "status": "submitted"}
        return 200, {"tenant_id": tids[0], "status": "submitted"}

    def handle(self, method: str, path: str, headers, body: bytes,
               request_id: str = "") -> Tuple[int, str, bytes, bool]:
        """Route one request; returns (code, content-type, body,
        stream?) — ``stream`` means the caller takes over the socket
        (NDJSON). Front-end threads only: never touches the
        scheduler."""
        parsed = urllib.parse.urlparse(path)
        route = parsed.path.rstrip("/") or "/"
        qs = urllib.parse.parse_qs(parsed.query)
        if route == "/healthz" and method == "GET":
            firing = (self.alerts.firing()
                      if self.alerts is not None else [])
            status = ("stalled" if self._stalled
                      else "draining" if self.draining
                      else "warming" if self._warming
                      else "degraded" if firing else "ok")
            code = 200 if status == "ok" else 503
            # the detail body is additive: existing probes
            # keep the status-string + 200-only-on-ok contract
            out = {
                "status": status,
                "jobs": len(self._views),
                "problems": sorted(self.problems),
                "watchdog": {"enabled": self.watchdog_s is not None,
                             "budget_s": self.watchdog_s,
                             "stalled": self._stalled},
                "warming": {"active": self._warming,
                            "buckets_done": self._warm_done,
                            "buckets_total": self._warm_total},
                "startup_phases": dict(self._startup_phases),
                "seconds_since_boundary": (
                    round(time.monotonic() - self._last_boundary, 3)
                    if self._last_boundary is not None else None),
                "steps": self._steps,
                "firing_alerts": firing,
            }
            if self.canary is not None:
                out["canary"] = self.canary.snapshot()
            return code, "application/json", \
                json.dumps(out).encode(), False
        if route == "/metrics" and method == "GET":
            # the unified serving surface: the same registry text
            # serve_metrics() exposes, on the service's own port
            reg = self.scheduler.metrics
            text = reg.metrics_text() if reg is not None else ""
            return 200, ("text/plain; version=0.0.4; charset=utf-8"), \
                text.encode(), False
        if route == "/v1/alerts" and method == "GET":
            # unauthenticated like /healthz and /metrics: the alert
            # surface is operator plumbing, not tenant data
            eng = self.alerts
            out = {"alerts": (eng.snapshot()
                              if eng is not None else []),
                   "firing": (eng.firing()
                              if eng is not None else []),
                   "transitions": (len(eng.transitions)
                                   if eng is not None else 0)}
            return 200, "application/json", \
                json.dumps(out).encode(), False
        if route == "/v1/migrate" and method == "POST":
            # the peer-to-peer adoption endpoint of live migration
            raise _HttpError(501, str(_not_ported("POST /v1/migrate")))
        token, info = self._auth(headers)
        if route == "/v1/jobs" and method == "POST":
            payload = json.loads(body or b"{}")
            # the request's ROOT span: deterministic id derived from
            # the request id, so post-restart replay spans can parent
            # onto it without the original row (always on — the
            # waterfall's spine). A client traceparent, if any, is
            # already the ambient context and becomes its parent.
            with self._tspan("request",
                             span_id=tracing.root_span_id(request_id),
                             always=True, route="/v1/jobs"):
                code, out = self._handle_submit(payload, token, info,
                                                headers, request_id)
            return code, "application/json", \
                json.dumps(out).encode(), False
        if route == "/v1/drain" and method == "POST":
            # ?handoff=<peer-url> migrates residents to the peer:
            # live migration, not ported yet
            peer = qs.get("handoff", [None])[0]
            if peer:
                raise _HttpError(501, str(_not_ported(
                    "POST /v1/drain?handoff=")))
            self.journal.event("service_request", route="drain",
                               request_id=request_id,
                               handoff=peer or None)
            self.drain(wait=False)
            out = {"draining": True, "handoff": peer or None}
            return 200, "application/json", \
                json.dumps(out).encode(), False
        if route == "/v1/results" and method == "GET":
            # batch result fetch: one request, N tenants — the
            # long-poll deadline is shared across the batch
            ids = [i for i in qs.get("ids", [""])[0].split(",") if i]
            if not ids:
                raise _HttpError(400, "ids=<tid,[tid...]> required")
            views = [self._view_for(urllib.parse.unquote(tid), token)
                     for tid in ids]
            if qs.get("wait", ["0"])[0] not in ("0", ""):
                deadline = time.monotonic() + self._q_float(
                    qs, "timeout", default=min(300.0, self.max_poll_s),
                    max_value=self.max_poll_s)
                for v in views:
                    v.done.wait(max(0.0,
                                    deadline - time.monotonic()))
            out = {}
            for v in views:
                entry = v.as_dict()
                payload = (self._result_payload(v)
                           if v.done.is_set() else None)
                if payload is not None:
                    entry["result"] = payload
                out[v.tenant_id] = entry
            return 200, "application/json", \
                json.dumps({"results": out}).encode(), False
        if route.startswith("/v1/jobs/") and method == "GET":
            parts = route.split("/")[3:]
            tid = urllib.parse.unquote(parts[0])
            sub = parts[1] if len(parts) > 1 else ""
            view = self._view_for(tid, token)
            if sub == "":
                return 200, "application/json", \
                    json.dumps(view.as_dict()).encode(), False
            if sub == "result":
                if qs.get("wait", ["0"])[0] not in ("0", ""):
                    timeout = self._q_float(
                        qs, "timeout",
                        default=min(300.0, self.max_poll_s),
                        max_value=self.max_poll_s)
                    view.done.wait(timeout)
                if view.status == "deadline_exceeded":
                    return 504, "application/json", \
                        json.dumps(view.as_dict()).encode(), False
                if not view.done.is_set():
                    return 202, "application/json", \
                        json.dumps(view.as_dict()).encode(), False
                out = view.as_dict()
                payload = self._result_payload(view)
                if payload is not None:
                    out["result"] = payload
                return 200, "application/json", \
                    json.dumps(out).encode(), False
            if sub == "stream":
                return 200, "application/x-ndjson", b"", True
        raise _HttpError(404, f"no route {method} {route}")

    def next_request_id(self, headers) -> str:
        """The request's trace id: the client's ``X-Request-Id`` when
        present, else a generated one — echoed in the response header
        and stamped into every journal row the request touches."""
        rid = headers.get("X-Request-Id")
        if rid:
            return str(rid)[:64]
        with self._lock:
            self._rid_seq += 1
            return f"req-{os.getpid():x}-{self._rid_seq:x}"

    def stream_events(self, tid: str, token: str, write_line) -> None:
        """Drive one NDJSON stream: status line first, then every
        published event until the terminal sentinel (or service
        close). Runs on the request thread; reads only the mirror."""
        view = self._view_for(tid, token)
        q = self._subscribe(tid)
        try:
            write_line({"event": "status", **view.as_dict()})
            if view.done.is_set():
                # finished before we subscribed: emit the terminal
                # event directly from the mirror
                write_line({"event": view.status,
                            "tenant_id": tid, "gen": view.gen})
                return
            while True:
                try:
                    ev = q.get(timeout=0.5)
                except queue.Empty:
                    if self._drained.is_set() or self._closed:
                        return
                    continue
                if ev is None:
                    return
                write_line(ev)
        finally:
            self._unsubscribe(tid, q)


class _ServiceHTTPServer(http.server.ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, service: EvolutionService):
        self.service = service
        super().__init__(addr, _Handler)


class _Handler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    @property
    def svc(self) -> EvolutionService:
        return self.server.service  # type: ignore[attr-defined]

    def log_message(self, *args):  # requests are journal rows, not logs
        pass

    def _respond(self, code: int, ctype: str, payload: bytes,
                 extra: Optional[Dict[str, str]] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        for k, v in (extra or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(payload)

    def _drop_check(self, route: str) -> bool:
        """Fire the fault plan's ``http_response`` seam; True means
        the fault already decided the response — an injected drop
        (connection closed without replying) or an injected 429
        (answered here with Retry-After). Either way the request's
        server-side effects stand."""
        try:
            self.svc._fire_fault("http_response", route=route,
                                 method=self.command)
        except InjectedDrop:
            self.close_connection = True
            return True
        except InjectedReject as e:
            # a deterministic retry-storm source: every rejected client
            # sees the same Retry-After and comes back in one herd —
            # counted as a shed like a real 429
            self.svc.journal.event("load_shed", reason="injected_429",
                                   route=route)
            self.svc.scheduler.note_shed()
            self._respond(
                429, "application/json",
                json.dumps({"error": str(e)}).encode(),
                extra={"Retry-After":
                       str(max(1, int(round(e.retry_after_s))))})
            return True
        return False

    def _dispatch(self, method: str) -> None:
        rid = self.svc.next_request_id(self.headers)
        # trace propagation: a client traceparent continues the
        # client's trace; otherwise (with tracing on) the context
        # derives deterministically from the request id. Echoed in the
        # response so the client can correlate either way.
        tctx = self.svc.trace_context(rid,
                                      self.headers.get("traceparent"))
        ids = {"X-Request-Id": rid}
        if tctx is not None:
            ids["traceparent"] = tctx.traceparent()
        try:
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            try:
                with tracing.use(tctx):
                    code, ctype, payload, stream = self.svc.handle(
                        method, self.path, self.headers, body, rid)
            except _HttpError as e:
                if self._drop_check(self.path):
                    return
                self._respond(e.code, "application/json", json.dumps(
                    {"error": e.message}).encode(),
                    extra={**ids, **e.headers})
                return
            except json.JSONDecodeError as e:
                self._respond(400, "application/json", json.dumps(
                    {"error": f"bad JSON body: {e}"}).encode(),
                    extra=ids)
                return
            if self._drop_check(self.path):
                return
            if not stream:
                self._respond(code, ctype, payload, extra=ids)
                return
            # NDJSON stream: no Content-Length; the connection closes
            # when the stream ends (HTTP/1.1 read-until-close)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for k, v in ids.items():
                self.send_header(k, v)
            self.send_header("Connection", "close")
            self.end_headers()

            def write_line(ev: dict) -> None:
                self.wfile.write(json.dumps(ev).encode() + b"\n")
                self.wfile.flush()

            parsed = urllib.parse.urlparse(self.path)
            tid = urllib.parse.unquote(parsed.path.rstrip("/")
                                       .split("/")[3])
            token, _ = self.svc._auth(self.headers)
            self.svc.stream_events(tid, token, write_line)
            self.close_connection = True
        except (BrokenPipeError, ConnectionResetError):
            self.close_connection = True

    def do_GET(self):  # noqa: N802 (http.server API)
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")
