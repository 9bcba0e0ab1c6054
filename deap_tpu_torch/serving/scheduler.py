"""Ask-tell scheduler — multi-tenant serving over the run axis.

Port of :mod:`deap_tpu.serving.scheduler`. The host control loop in front
of :class:`~deap_tpu_torch.serving.multirun.MultiRunEngine`: jobs are **submitted**, admitted into **shape buckets**
(:func:`~deap_tpu_torch.serving.tenant.bucket_key`), packed up to
``max_lanes`` tenants per device batch on the pow-2 lane lattice, and
advanced **segment by segment** — the ResilientRun cadence: every
segment boundary is a host sync where telemetry rows drain (journaled
per ``tenant_id``), health tripwires run (an early-stop frees the
lane), finished tenants return their solo-format results, and the
crash-consistent per-tenant checkpoint is written. That checkpoint is
also the **swap unit**: when jobs queue behind a full batch, resident
tenants past their fairness quantum are evicted at the boundary
(checkpoint → drop lane) and later resumed bit-exactly
(``restore_latest(tenant_id=...)`` — co-located tenant dirs can't
cross-restore).

Start-up: the port compiles no program per lattice point; its kernels
are built once, at first use, into the build directory, which
``compile_cache=`` (:func:`~deap_tpu_torch.support.compilecache.
enable_compile_cache`) and the artifact store make persistent across
processes. :func:`prewarm` runs one generation of a scratch lane per
bucket, which builds and loads the kernels the bucket's segments launch
before its first tenant arrives, and journals one ``prewarm`` event per
bucket and lane count.

Single-device, single-thread by design — the loop is a *cadence*, not
a server; an RPC front end calls :meth:`Scheduler.submit` /
:meth:`Scheduler.step` on its own schedule, **from one thread**. The
scheduler is guarded, not locked: concurrent entry from a second
thread raises :class:`SchedulerBusyError` instead of corrupting bucket
state, and once a front end declares its driver thread
(:meth:`Scheduler.bind_driver` — the
:class:`~deap_tpu_torch.serving.service.EvolutionService` queue-handoff
contract), any mutating call from another thread is rejected outright.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

from deap_tpu_torch import tuning
from deap_tpu_torch.serving.multirun import MultiRunEngine
from deap_tpu_torch.serving.tenant import Job, Tenant, bucket_key, pad_pow2
from deap_tpu_torch.support.compilecache import enable_compile_cache
from deap_tpu_torch.telemetry import tracing
from deap_tpu_torch.telemetry.meter import Meter
from deap_tpu_torch.telemetry.metrics import (MetricsServer,
                                              SERVING_SEGMENT_BUCKETS,
                                              SERVING_WAIT_BUCKETS,
                                              phase_histogram,
                                              resolve_registry,
                                              serve_metrics)
from deap_tpu_torch.telemetry.run import RunTelemetry

__all__ = ["Scheduler", "SchedulerBusyError", "prewarm"]


class SchedulerBusyError(RuntimeError):
    """A mutating :class:`Scheduler` call entered from a second thread
    while another call was in flight (or from a non-driver thread after
    :meth:`Scheduler.bind_driver`). The scheduler's bucket state is a
    single-threaded data structure by contract — raising here is what
    keeps a misbehaving front end from corrupting it. Route the call
    through the owning driver thread (the
    :class:`~deap_tpu_torch.serving.service.EvolutionService` command queue
    is exactly that handoff)."""


class _Bucket:
    """One shape bucket: its engine, admission queue and residency."""

    def __init__(self, key, engine: MultiRunEngine, max_lanes: int):
        self.key = key
        # the bucket's metric/journal label: family + program digest —
        # short, stable, and readable on a Grafana legend
        self.label = f"{key[0]}:{str(key[1])[:10]}"
        self.engine = engine
        self.queue: List[Tenant] = []
        self.residents: List[Tenant] = []
        self.batch: Optional[Dict[str, Any]] = None
        self.horizon = 1
        # the bucket's kernels are built: a prewarm or a segment ran
        self.warm = False
        # per-bucket lane budget — the autoscaler's actuator
        # (pad_pow2'd; starts at the scheduler default)
        self.max_lanes = int(max_lanes)

    @property
    def runnable(self) -> bool:
        return bool(self.queue) or bool(self.residents)


class _ServingInstruments:
    """The scheduler's Prometheus instruments — the per-bucket /
    per-tenant SLO surface ``/metrics`` exports (create-or-get, so
    several schedulers can share one registry)."""

    def __init__(self, registry):
        self.queue_depth = registry.gauge(
            "deap_serving_queue_depth",
            "jobs waiting for a lane, per bucket", labels=("bucket",))
        self.occupancy = registry.gauge(
            "deap_serving_lane_occupancy",
            "fraction of max_lanes holding a resident tenant",
            labels=("bucket",))
        # per-metric bucket overrides: burst queue waits run past 10 s,
        # which DEFAULT_BUCKETS would round up to the 30 s bound
        self.queue_wait_s = registry.histogram(
            "deap_serving_queue_wait_seconds",
            "seconds from submission/eviction to (re)admission",
            labels=("bucket",), buckets=SERVING_WAIT_BUCKETS)
        self.segment_s = registry.histogram(
            "deap_serving_segment_seconds",
            "wall seconds per scheduler segment (advance + drain sync)",
            labels=("bucket",), buckets=SERVING_SEGMENT_BUCKETS)
        self.admissions = registry.counter(
            "deap_serving_admissions_total",
            "fresh tenant admissions", labels=("bucket",))
        self.evictions = registry.counter(
            "deap_serving_evictions_total",
            "tenants evicted past their fairness quantum",
            labels=("bucket",))
        self.resumes = registry.counter(
            "deap_serving_resumes_total",
            "tenants resumed from their checkpoint swap unit",
            labels=("bucket",))
        self.finished = registry.counter(
            "deap_serving_tenants_finished_total",
            "tenants that completed (or early-stopped)",
            labels=("bucket",))
        self.tenant_gens = registry.gauge(
            "deap_serving_tenant_gens_per_sec",
            "per-tenant generations/second over the last segment",
            labels=("tenant_id",))
        # family-labelled residency: GP / island / scan-family lanes
        # are distinguishable on /metrics without touching the label
        # tuples of the instruments above (create-or-get pins them)
        self.family_residents = registry.gauge(
            "deap_serving_family_residents",
            "resident tenants per bucket, labelled by engine family",
            labels=("bucket", "family"))


class Scheduler:
    """Admit → pack → advance → drain/evict, one segment per step.

    :param root: serving root directory — the shared journal
        (``<root>/journal.jsonl``) plus one run dir per tenant
        (``<root>/tenants/<id>/``: checkpoints, isolated from every
        other tenant).
    :param max_lanes: tenants packed per device batch (padded up to the
        pow-2 lattice with inactive dummy lanes).
    :param segment_len: generations per segment — the
        eviction/telemetry/checkpoint granularity, exactly
        ``ResilientRun``'s ``segment_len``.
    :param fair_quantum: segments a resident tenant may hold a lane
        while others queue; beyond it the tenant is evicted at the next
        boundary (checkpoint as swap unit). ``None`` disables eviction.
    :param checkpoint_every: write each resident tenant's checkpoint
        every n-th boundary (1 = every boundary; ``None``/0 = only when
        evicting — cheaper, but a crash then loses since-admission
        progress).
    :param telemetry: thread a per-bucket Meter (+ each job's probes)
        through the batched scan and journal per-generation rows under
        each ``tenant_id``. Costs the stacked meter output; off → only
        lifecycle events are journaled.
    :param compile_cache: path → :func:`enable_compile_cache` (the
        kernel build directory) before the first build, and the artifact
        store beside it (persistent across processes).
    :param metrics: the SLO metrics surface — ``True`` (default)
        records per-bucket queue depth / occupancy / queue-wait /
        segment latency and per-tenant gens/s into the process
        :class:`~deap_tpu_torch.telemetry.metrics.MetricsRegistry`
        (``deap_serving_*`` instruments; expose them with
        :meth:`serve_metrics` or the module-level
        :func:`deap_tpu_torch.telemetry.serve_metrics`). Pass a registry to
        isolate, ``None``/``False`` to disable. Host-side counters
        only — nothing rides the batched pass.
    :param trace_sample: distributed-tracing knob. ``None`` (default)
        → tracing off, the zero-overhead path. A float in [0, 1] →
        a :class:`~deap_tpu_torch.telemetry.tracing.Tracer` bound to the
        scheduler journal: per-segment detail spans (queue wait →
        admission → segment[i] → checkpoint) emit as ``trace_span``
        rows for the sampled fraction of traces; the terminal
        ``finished`` span is always on. With metrics on, every span
        with a phase observes ``deap_service_phase_seconds{phase=...}``
        regardless of the sampling decision. ``1.0`` is the
        full-fidelity latency-investigation mode: it additionally
        activates a :class:`~deap_tpu_torch.telemetry.costs.
        ProgramObservatory`, which profiles each bucket's first segment
        (``program_profile``).
    """

    def __init__(self, root: str, *, max_lanes: int = 8,
                 segment_len: int = 10,
                 fair_quantum: Optional[int] = 1,
                 checkpoint_every: Optional[int] = 1,
                 telemetry: bool = True,
                 compile_cache: Optional[str] = None,
                 journal_fsync_every: Optional[int] = None,
                 metrics=True,
                 resume_tenants: bool = False,
                 boundary_cb: Optional[Callable] = None,
                 fault_hook: Optional[Callable] = None,
                 trace_sample: Optional[float] = None):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._artifact_store = None
        if compile_cache:
            enable_compile_cache(compile_cache)
            # sibling artifact store: a restarted process loads the built
            # kernels instead of building them; best-effort — a store
            # that cannot be created leaves the build path untouched
            try:
                from deap_tpu_torch.support.artifacts import \
                    enable_artifact_store
                self._artifact_store = enable_artifact_store()
            except Exception:
                self._artifact_store = None
        self.max_lanes = int(max_lanes)
        if segment_len == "auto":
            # env DEAP_TPU_TORCH_TUNE_SEGMENT_LEN → tuning-cache winner
            # → the static 10
            segment_len = tuning.resolve_int("segment_len", default=10,
                                             program="scheduler")
        self.segment_len = int(segment_len)
        self.fair_quantum = fair_quantum
        self.checkpoint_every = checkpoint_every
        self.telemetry = bool(telemetry)
        #: re-admit a tenant id whose run dir already holds a
        #: checkpoint by RESUMING it (the restart half of a service
        #: drain) instead of starting from generation 0
        self.resume_tenants = bool(resume_tenants)
        #: optional host hook called at every segment boundary with
        #: ``(bucket_label, updates)`` where updates is a list of
        #: per-tenant dicts (tenant, gen_before, gen, chunk, finished)
        #: — the service's streaming fan-out point
        self.boundary_cb = boundary_cb
        #: optional ``hook(event, **ctx)`` fired at the scheduler's
        #: deterministic fault seams — today one seam: ``"segment"``,
        #: fired between a segment's device dispatch and its drain
        #: barrier, i.e. INSIDE the segment-latency measurement
        #: window. The service wires this to its fault plan so a
        #: :class:`~deap_tpu_torch.resilience.faultinject.DelaySegment`
        #: with ``event="segment"`` shows up in the segment phase's
        #: spans/histogram
        self.fault_hook = fault_hook
        from deap_tpu_torch.telemetry.journal import RunJournal
        self.journal = RunJournal(
            os.path.join(self.root, "journal.jsonl"),
            fsync_every=journal_fsync_every)
        self.metrics = resolve_registry(metrics)
        self._minst = (_ServingInstruments(self.metrics)
                       if self.metrics is not None else None)
        #: distributed-tracing plane: ``trace_sample=None`` (default)
        #: keeps tracing fully off — today's zero-overhead path; a
        #: float in [0,1] enables the Tracer (lifecycle spans always
        #: on, detail spans sampled per trace at that rate). Spans
        #: land in this journal as ``trace_span`` rows and — when
        #: metrics are on — observe the per-phase latency histogram.
        self.trace_sample = trace_sample
        self._observatory = None
        if trace_sample is None:
            self.tracer = None
        else:
            phase_obs = None
            if self.metrics is not None:
                hist = phase_histogram(self.metrics)
                phase_obs = lambda phase, s: hist.observe(s, phase=phase)
            self.tracer = tracing.Tracer(journal=self.journal,
                                         sample=float(trace_sample),
                                         phase_observe=phase_obs)
            # FULL-FIDELITY tracing (sample >= 1.0, the latency-
            # investigation mode) also activates the program
            # observatory, which profiles each bucket's first segment
            # (`program_profile`). Sampled production tracing does not:
            # a profiled segment runs under torch.profiler.
            if float(trace_sample) >= 1.0:
                from deap_tpu_torch.telemetry.costs import ProgramObservatory
                self._observatory = ProgramObservatory(
                    journal=self.journal)
                self._observatory.__enter__()
        self._metrics_server: Optional[MetricsServer] = None
        self.buckets: Dict[Any, _Bucket] = {}
        self.tenants: Dict[str, Tenant] = {}
        self._boundaries = 0
        self._rr: List[Any] = []  # round-robin bucket order
        self._spill: set = set()  # tenant ids to swap out at the
        #                           next boundary (autoscaler pressure)
        # load counters: arrivals per bucket label plus
        # global sheds / deadline misses. Their OWN lock, not the
        # _exclusive guard — the service's request threads increment
        # sheds/misses while the driver owns the scheduler, and the
        # per-boundary `slo` journal row folds the cumulative values
        # in so windowed rates compute from the journal alone
        self._load_lock = threading.Lock()
        self._arrivals: Dict[str, int] = {}
        self._sheds = 0
        self._deadline_misses = 0
        # single-threaded-contract guard: RLock so the owner re-enters
        # (run → step), non-blocking so a second thread gets a loud
        # SchedulerBusyError instead of silently corrupted buckets
        self._guard = threading.RLock()
        self._driver_thread: Optional[threading.Thread] = None

    # ------------------------------------------------ thread contract ----

    def bind_driver(self,
                    thread: Optional[threading.Thread] = None) -> None:
        """Declare ``thread`` (default: the calling thread) the owner:
        from now on every mutating call from any OTHER thread raises
        :class:`SchedulerBusyError` immediately — the lock-owner
        assertion behind the service's queue-handoff contract."""
        self._driver_thread = thread or threading.current_thread()

    @contextlib.contextmanager
    def _exclusive(self, op: str):
        cur = threading.current_thread()
        if self._driver_thread is not None and \
                cur is not self._driver_thread:
            raise SchedulerBusyError(
                f"Scheduler.{op} called from thread {cur.name!r} but "
                f"the scheduler is bound to driver thread "
                f"{self._driver_thread.name!r}; enqueue the request to "
                "the driver instead (see serving/service.py)")
        if not self._guard.acquire(blocking=False):
            raise SchedulerBusyError(
                f"Scheduler.{op} called concurrently from thread "
                f"{cur.name!r} while another scheduler call is in "
                "flight; the scheduler is single-threaded by contract "
                "— serialise calls through one driver thread")
        try:
            yield
        finally:
            self._guard.release()

    # -------------------------------------------------------- admission ----

    def submit(self, job: Job) -> str:
        """Queue a job; returns its tenant id. Jobs with equal bucket
        keys share one engine (see :func:`bucket_key`).
        Single-threaded by contract: a concurrent call from a second
        thread raises :class:`SchedulerBusyError` (see
        :meth:`bind_driver`)."""
        with self._exclusive("submit"):
            return self._submit(job)

    def _submit(self, job: Job) -> str:
        if job.tenant_id in self.tenants:
            raise ValueError(f"tenant id {job.tenant_id!r} already "
                             "submitted")
        if job.family in ("ea_mu_plus_lambda", "ea_mu_comma_lambda") \
                and (job.mu is None or job.lambda_ is None):
            raise ValueError(f"{job.family} job needs mu/lambda_")
        if job.family == "gp" and job.spec is None:
            raise ValueError("gp job needs spec= (a GpJobSpec)")
        if job.family == "island" and job.spec is None:
            raise ValueError("island job needs spec= (an IslandJobSpec)")
        bkey = bucket_key(job)
        bucket = self.buckets.get(bkey)
        if bucket is None:
            bucket = _Bucket(bkey, self._make_engine(job),
                             self.max_lanes)
            self.buckets[bkey] = bucket
            self._rr.append(bkey)
            if job.family == "gp":
                self._tune_gp_admission(bucket, job)
        tenant = Tenant(job, self.root)
        if self.resume_tenants and tenant.probe_checkpoint():
            # the restart half of a service drain: this tenant id left
            # a tenant-stamped checkpoint behind — admission resumes it
            self.journal.event("tenant_checkpoint_found",
                               tenant_id=tenant.id)
        self.tenants[tenant.id] = tenant
        bucket.queue.append(tenant)
        bucket.horizon = max(bucket.horizon, pad_pow2(int(job.ngen)))
        self.journal.event("job_submitted", tenant_id=tenant.id,
                           family=job.family, ngen=int(job.ngen),
                           bucket=repr(bkey[:2]),
                           **self._rid(tenant))
        with self._load_lock:
            self._arrivals[bucket.label] = \
                self._arrivals.get(bucket.label, 0) + 1
        if self._minst is not None:
            self._minst.queue_depth.set(len(bucket.queue),
                                        bucket=bucket.label)
        return tenant.id

    def _tune_gp_admission(self, bucket: _Bucket, job: Job) -> None:
        """The dispatch tuner's ``gp_batch`` knob: batched vs solo GP
        admission, decided at first bucket creation.

        The batched engine is the static choice. With a tuner active (or
        ``DEAP_TPU_TORCH_TUNE_GP_BATCH`` set), this probes one
        ``segment_len``-generation segment with the bucket's actual spec
        at full lane width against a single lane (fresh ``lane_init``
        from the job: the job's generator is read, not advanced),
        normalises to per-lane-segment cost, bit-checks lane 0 across
        both (the engine's batched == solo identity), and — when solo
        wins — routes the bucket through ``max_lanes=1``, the
        autoscaler's own actuator. Journaled as ``tuning_decision`` (the
        winner persists, so the next process routes without probing)."""
        lanes = pad_pow2(self.max_lanes)
        if lanes <= 1:
            return
        if (tuning.active_tuner() is None
                and tuning.env_override("gp_batch") is None):
            return
        eng = bucket.engine
        horizon = max(bucket.horizon, pad_pow2(int(job.ngen)))
        candidates = {"batched": None, "solo": None}
        if tuning.active_tuner() is not None:
            lane = eng.lane_init(job.generator, job.init, job.ngen,
                                 job.hyper)

            def probe(n_lanes):
                def fn():
                    batch = eng.pack([lane] * n_lanes,
                                     n_lanes=n_lanes, horizon=horizon)
                    out, _ = eng.advance(batch, self.segment_len)
                    res = eng.unpack(out, 0)["carry"]
                    return (res["genomes"], res["fit"])
                return fn

            candidates = {"batched": (probe(lanes), float(lanes)),
                          "solo": (probe(1), 1.0)}
        choice = tuning.resolve(
            "gp_batch",
            bucket=(str(bucket.key[0]), str(bucket.key[1])[:16],
                    lanes, self.segment_len),
            default="batched", candidates=candidates, check="bitwise",
            program=bucket.label, device=eng.device)
        if choice == "solo":
            bucket.max_lanes = 1
            self.journal.event("tuned_admission", bucket=bucket.label,
                               choice=choice, max_lanes=1)

    def _make_engine(self, job: Job) -> MultiRunEngine:
        device = job.generator.device
        tel = None
        if self.telemetry:
            tel = RunTelemetry(self.journal, meter=Meter(),
                               spans=False, init_backend=False)
        if job.family == "gp":
            from deap_tpu_torch.serving.gp_multirun import GpMultiRunEngine
            return GpMultiRunEngine(
                job.spec, telemetry=tel, probes=job.probes,
                stats=job.stats,
                halloffame_size=job.halloffame_size, device=device)
        if job.family == "island":
            from deap_tpu_torch.serving.gp_multirun import \
                IslandMultiRunEngine
            return IslandMultiRunEngine(
                job.toolbox, job.spec, telemetry=tel,
                probes=job.probes, device=device)
        kwargs: Dict[str, Any] = {}
        if job.family == "ea_generate_update":
            kwargs.update(spec=job.spec, state_template=job.init)
        return MultiRunEngine(
            job.family, job.toolbox, mu=job.mu, lambda_=job.lambda_,
            stats=job.stats, telemetry=tel, probes=job.probes,
            halloffame_size=job.halloffame_size, device=device, **kwargs)

    # ---------------------------------------------------------- prewarm ----

    def prewarm(self, jobs: Iterable[Job],
                lane_counts: Optional[Sequence[int]] = None) -> int:
        """Warm each template job's bucket before serving: for every
        distinct bucket among ``jobs``, build its engine and, unless the
        bucket already ran, one generation of a scratch lane made from
        the job (its generator is read, never advanced; the lane is
        dropped), which builds and loads the kernels the bucket
        launches. No kernel is built per lane count, so the lane counts
        only label the journal: one ``prewarm`` event per (bucket,
        lane-count), the first carrying the build's seconds as
        ``compile_s``. Returns the number warmed."""
        with self._exclusive("prewarm"):
            return self._prewarm(jobs, lane_counts)

    def _prewarm(self, jobs: Iterable[Job],
                 lane_counts: Optional[Sequence[int]] = None) -> int:
        counts = (tuple(int(c) for c in lane_counts) if lane_counts
                  else (pad_pow2(self.max_lanes),))
        warmed = 0
        seen = set()
        for job in jobs:
            bkey = bucket_key(job)
            if bkey in seen:
                continue
            seen.add(bkey)
            bucket = self.buckets.get(bkey)
            if bucket is None:
                bucket = _Bucket(bkey, self._make_engine(job),
                                 self.max_lanes)
                self.buckets[bkey] = bucket
                self._rr.append(bkey)
            horizon = pad_pow2(int(job.ngen))
            bucket.horizon = max(bucket.horizon, horizon)
            eng = bucket.engine
            t0 = time.perf_counter()
            if not bucket.warm:
                lane = eng.lane_init(job.generator, job.init, 1, job.hyper)
                eng.advance(eng.pack([lane]), 1)
                bucket.warm = True
            built_s = time.perf_counter() - t0
            for n_lanes in counts:
                warmed += 1
                self.journal.event(
                    "prewarm", bucket=repr(bkey[:2]),
                    family=eng.family, lanes=pad_pow2(n_lanes),
                    horizon=bucket.horizon,
                    segment_len=self.segment_len,
                    compile_s=round(built_s, 4))
                built_s = 0.0
        return warmed

    # ------------------------------------------------------- the cadence ----

    def step(self) -> bool:
        """One scheduling round: pick the next runnable bucket
        (round-robin), ensure its batch is packed (admitting /
        resuming / evicting at this boundary), advance one segment,
        drain the boundary. Returns False when nothing is runnable."""
        with self._exclusive("step"):
            bucket = self._next_bucket()
            if bucket is None:
                return False
            self._repack(bucket)
            if not bucket.residents:
                return True  # everything spilled; next round readmits
            # ambient trace context for the segment: the batch is
            # shared, so builds/span-bridge rows inside advance()
            # are attributed to a representative tenant (the first
            # resident with a request id) — per-tenant device time is
            # emitted exactly in _drain_boundary
            rep_ctx = next((c for c in map(self._tctx,
                                           bucket.residents)
                            if c is not None), None)
            t0 = time.perf_counter()
            with tracing.use(rep_ctx):
                batch, seg = bucket.engine.advance(bucket.batch,
                                                   self.segment_len)
            bucket.batch = batch
            bucket.warm = True
            if self.fault_hook is not None:
                # in-segment fault seam: between device dispatch and
                # the drain barrier — a DelaySegment here lands inside
                # seg_s, the segment spans and the segment histogram
                self.fault_hook("segment", bucket=bucket.label)
            self._drain_boundary(bucket, seg, t_start=t0)
            return True

    @property
    def runnable(self) -> bool:
        """Any bucket has queued or resident tenants left."""
        return any(b.runnable for b in self.buckets.values())

    def run(self, max_steps: Optional[int] = None) -> Dict[str, tuple]:
        """Drive :meth:`step` until every submitted job finished (or
        ``max_steps``); returns ``{tenant_id: solo-format result}``."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return {t.id: t.result for t in self.tenants.values()
                if t.result is not None}

    def serve_metrics(self, host: str = "127.0.0.1", port: int = 0):
        """Expose this scheduler's registry at ``/metrics`` on a
        daemon thread (stdlib ``http.server``); returns the
        :class:`~deap_tpu_torch.telemetry.metrics.MetricsServer` (``.url``
        is the scrape target). Closed with the scheduler."""
        if self.metrics is None:
            raise ValueError("Scheduler was built with metrics "
                             "disabled; nothing to serve")
        if self._metrics_server is None:
            self._metrics_server = serve_metrics(self.metrics,
                                                 host=host, port=port)
        return self._metrics_server

    def close(self) -> None:
        if self._observatory is not None:
            self._observatory.__exit__(None, None, None)
            self._observatory = None
        self.journal.summary(
            tenants=len(self.tenants),
            finished=sum(t.done for t in self.tenants.values()))
        self.journal.close()
        if self._metrics_server is not None:
            self._metrics_server.close()
            self._metrics_server = None
        if self._artifact_store is not None:
            self._artifact_store.deactivate()
            self._artifact_store = None

    def __enter__(self) -> "Scheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------- internals ----

    @staticmethod
    def _rid(tenant: Tenant) -> Dict[str, str]:
        """The tenant's submitting request id as journal-row kwargs —
        empty for in-process submits, so rows stay clean."""
        rid = getattr(tenant.job, "request_id", None)
        return {"request_id": rid} if rid else {}

    def _tctx(self, tenant: Tenant):
        """The tenant's trace context (derived from its submitting
        request id — the same derivation a restarted process makes, so
        traces stitch across kill -9), or ``None`` when tracing is off
        or the tenant was submitted in-process without a request id."""
        if self.tracer is None:
            return None
        rid = getattr(tenant.job, "request_id", None)
        if not rid:
            return None
        return self.tracer.context_for(rid)

    def _tspan(self, tenant: Tenant, name: str, dur_s: float,
               phase: Optional[str] = None, always: bool = False,
               **attrs: Any) -> None:
        """Emit one tenant span parented on the request's
        deterministic root span. Per-segment detail respects the
        sampling knob (the phase histogram still observes every one);
        only terminal lifecycle events pass ``always=True`` — at 1k
        tenants the detail spans are ~10 journal rows per tenant, and
        journalling all of them regardless of ``trace_sample`` is
        exactly the overhead the sampled tripwire exists to catch."""
        ctx = self._tctx(tenant)
        if ctx is None:
            return
        self.tracer.emit(name, dur_s, ctx=ctx, phase=phase,
                         always=always, tenant_id=tenant.id, **attrs)

    def _checkpoint_traced(self, engine, tenant: Tenant,
                           name: str) -> str:
        """Checkpoint a tenant and account the write to its trace."""
        t0 = time.perf_counter()
        path = tenant.checkpoint(engine)
        self._tspan(tenant, name, time.perf_counter() - t0,
                    phase="checkpoint", gen=tenant.gen)
        return path

    def _next_bucket(self) -> Optional[_Bucket]:
        for _ in range(len(self._rr)):
            bkey = self._rr.pop(0)
            self._rr.append(bkey)
            if self.buckets[bkey].runnable:
                return self.buckets[bkey]
        return None

    def _evict(self, bucket: _Bucket, t: Tenant, reason: str) -> None:
        path = self._checkpoint_traced(bucket.engine, t,
                                       "checkpoint.evict")
        self.journal.event("tenant_evicted", tenant_id=t.id, gen=t.gen,
                           path=path, reason=reason, **self._rid(t))
        t.evict()
        bucket.residents.remove(t)
        bucket.queue.append(t)
        if self._minst is not None:
            self._minst.evictions.inc(bucket=bucket.label)

    def _repack(self, bucket: _Bucket) -> None:
        """Boundary admission control: spill requested/surplus
        residents, evict over-quantum residents when jobs queue, fill
        free lanes from the queue, and (re)pack the batch only when
        residency changed."""
        eng = bucket.engine
        changed = bucket.batch is None
        repack_t0 = time.perf_counter()
        newly_resident: List[Tenant] = []

        # requested spills (autoscaler pressure relief) — checkpoint
        # and park regardless of the fairness quantum
        if self._spill:
            for t in [t for t in bucket.residents
                      if t.id in self._spill]:
                self._evict(bucket, t, reason="spill")
                self._spill.discard(t.id)
                changed = True

        # lane-budget shrink (autoscaler scale-down): surplus
        # residents swap out, longest-resident first
        over = len(bucket.residents) - bucket.max_lanes
        if over > 0:
            for t in sorted(bucket.residents,
                            key=lambda t: -t.segments_resident)[:over]:
                self._evict(bucket, t, reason="scale_down")
                changed = True

        # eviction — only under contention, only past the quantum
        if bucket.queue and self.fair_quantum is not None:
            free = bucket.max_lanes - len(bucket.residents)
            want = len(bucket.queue) - free
            if want > 0:
                victims = sorted(
                    (t for t in bucket.residents
                     if t.segments_resident >= self.fair_quantum),
                    key=lambda t: -t.segments_resident)[:want]
                for t in victims:
                    self._evict(bucket, t, reason="fair_quantum")
                    changed = True

        # admission — resume from checkpoint or fresh-init
        while bucket.queue and len(bucket.residents) < bucket.max_lanes:
            t = bucket.queue.pop(0)
            # the queue-wait SLO sample: exact seconds in the journal
            # row (bucket-resolution in the Prometheus histogram)
            wait_s = max(0.0, time.monotonic() - t.enqueued_at)
            if self._minst is not None:
                self._minst.queue_wait_s.observe(wait_s,
                                                 bucket=bucket.label)
            # detail span (sampled): time queued before this admission
            # (re-queued evictees get one span per wait)
            self._tspan(t, "queue.wait", wait_s, phase="queue_wait",
                        resumed=bool(t.has_checkpoint))
            newly_resident.append(t)
            if t.has_checkpoint:
                t.restore(eng)
                self.journal.event("tenant_resumed", tenant_id=t.id,
                                   gen=t.gen,
                                   wait_s=round(wait_s, 4),
                                   **self._rid(t))
                if self._minst is not None:
                    self._minst.resumes.inc(bucket=bucket.label)
            else:
                t.lane = eng.lane_init(t.job.generator, t.job.init,
                                       t.job.ngen, t.job.hyper)
                self.journal.event("tenant_admitted", tenant_id=t.id,
                                   ngen=int(t.job.ngen),
                                   wait_s=round(wait_s, 4),
                                   **self._rid(t))
                if self._minst is not None:
                    self._minst.admissions.inc(bucket=bucket.label)
                for row in eng.lane_meter_rows((), 0, lane=t.lane):
                    self._journal_row(t, row)
            t.status = Tenant.RUNNING
            t.segments_resident = 0
            bucket.residents.append(t)
            changed = True
        if self._minst is not None:
            self._minst.queue_depth.set(len(bucket.queue),
                                        bucket=bucket.label)
            self._minst.occupancy.set(
                len(bucket.residents) / bucket.max_lanes,
                bucket=bucket.label)
            self._minst.family_residents.set(
                len(bucket.residents), bucket=bucket.label,
                family=eng.family)

        if changed and bucket.residents:
            lanes = []
            for slot, t in enumerate(bucket.residents):
                t.slot = slot
                lanes.append(t.lane)
            bucket.batch = eng.pack(
                lanes, n_lanes=pad_pow2(len(lanes), bucket.max_lanes),
                horizon=bucket.horizon)
        if newly_resident:
            # admission/pack cost, attributed to every tenant admitted
            # at this boundary (the repack is one shared host step, so
            # each span carries the whole elapsed time — an upper
            # bound per tenant, exact for the boundary)
            pack_s = time.perf_counter() - repack_t0
            for t in newly_resident:
                self._tspan(t, "admit.pack", pack_s, phase="admission",
                            bucket=bucket.label)

    def _journal_row(self, tenant: Tenant, row: dict) -> None:
        self.journal.event("meter", tenant_id=tenant.id, **row)
        health = tenant.job.health
        if health is not None:
            for alarm in health.check_row(row, gen=row.get("gen")):
                self.journal.event("alarm", tenant_id=tenant.id,
                                   **alarm)
                if self.metrics is not None:
                    from deap_tpu_torch.telemetry.metrics import alarms_total
                    alarms_total(self.metrics).inc(
                        kind=alarm.get("alarm", "unknown"))

    def _drain_boundary(self, bucket: _Bucket, seg: Dict[str, Any],
                        t_start: Optional[float] = None) -> None:
        """The per-segment host sync: rows → tenants/journal/health,
        completion, checkpoints — plus the segment's SLO sample
        (latency, per-tenant gens/s, queue/occupancy) into the metrics
        registry and one ``slo`` journal event."""
        eng = bucket.engine
        self._boundaries += 1
        gens = eng.gens(bucket.batch)
        # materialising `gens` is the segment's completion barrier —
        # wall time from advance() dispatch to here is the segment SLO
        seg_s = (time.perf_counter() - t_start
                 if t_start is not None else None)
        gens_advanced = 0
        finished: List[Tenant] = []
        updates: List[Dict[str, Any]] = []
        for t in list(bucket.residents):
            i = t.slot
            gen_before = t.gen
            chunk = eng.lane_records((seg,), i)
            if chunk is not None:
                t.record_chunks.append(chunk)
            for row in eng.lane_meter_rows((seg,), i,
                                           gen_start=gen_before):
                self._journal_row(t, row)
            t.gen = gens[i]
            gens_advanced += t.gen - gen_before
            if self._minst is not None and seg_s:
                self._minst.tenant_gens.set(
                    round((t.gen - gen_before) / seg_s, 3),
                    tenant_id=t.id)
            if seg_s is not None:
                # detail span (sampled): this tenant's segment share
                # (device time is batched — the wall seconds are the
                # segment's; gen_before/gen delimit the lane's work)
                self._tspan(t, "segment", seg_s, phase="device",
                            gen_before=gen_before, gen=t.gen,
                            bucket=bucket.label)
            t.segments_resident += 1
            t.lane = eng.unpack(bucket.batch, i)
            health = t.job.health
            stop = health is not None and health.stop_requested
            if t.gen >= int(t.job.ngen) or stop:
                t.result = eng.lane_result(
                    t.lane, eng.concat_records(t.record_chunks))
                if stop and t.gen < int(t.job.ngen):
                    t.status = Tenant.STOPPED
                    t.stopped_at = t.gen
                else:
                    t.status = Tenant.FINISHED
                self.journal.event(
                    "tenant_finished", tenant_id=t.id, gen=t.gen,
                    status=t.status, **self._rid(t))
                # instant lifecycle span marking the terminal state
                self._tspan(t, "finished", 0.0, gen=t.gen,
                            status=t.status, always=True)
                if self._minst is not None:
                    self._minst.finished.inc(bucket=bucket.label)
                finished.append(t)
            elif self.checkpoint_every and \
                    self._boundaries % self.checkpoint_every == 0:
                self._checkpoint_traced(eng, t, "checkpoint")
            updates.append({"tenant": t, "gen_before": gen_before,
                            "gen": t.gen, "chunk": chunk,
                            "finished": t in finished})
        if finished:
            for t in finished:
                bucket.residents.remove(t)
                t.slot = None
            bucket.batch = None  # repack next round

        self.journal.event(
            "segment", bucket=repr(bucket.key[:2]),
            family=eng.family, lanes=int(len(gens)),
            residents=len(bucket.residents) + len(finished),
            finished=[t.id for t in finished])
        # the boundary's SLO sample: one journal row (the report's
        # scheduler-SLO timeline) and the Prometheus instruments
        occupancy = len(bucket.residents) / bucket.max_lanes
        slo: Dict[str, Any] = {
            "bucket": bucket.label, "lanes": int(len(gens)),
            "residents": len(bucket.residents),
            "queue_depth": len(bucket.queue),
            "occupancy": round(occupancy, 4),
            "gens_advanced": int(gens_advanced),
        }
        if seg_s is not None:
            slo["segment_s"] = round(seg_s, 6)
            if seg_s > 0:
                slo["gens_per_sec"] = round(gens_advanced / seg_s, 3)
        # cumulative load counters: journal-only consumers difference
        # consecutive rows for windowed arrival/shed/deadline-miss
        # rates — no /metrics scrape needed
        with self._load_lock:
            slo["arrivals"] = self._arrivals.get(bucket.label, 0)
            slo["sheds"] = self._sheds
            slo["deadline_misses"] = self._deadline_misses
        self.journal.event("slo", **slo)
        if self._minst is not None:
            if seg_s is not None:
                self._minst.segment_s.observe(seg_s,
                                              bucket=bucket.label)
            self._minst.queue_depth.set(len(bucket.queue),
                                        bucket=bucket.label)
            self._minst.occupancy.set(occupancy, bucket=bucket.label)
            self._minst.family_residents.set(
                len(bucket.residents), bucket=bucket.label,
                family=eng.family)
        if self.boundary_cb is not None:
            self.boundary_cb(bucket.label, updates)

    # ----------------------------------------- control-plane surface ----
    # (the autoscaler's sensors and actuators, and the drain hook —
    # all single-threaded: call from the driver thread only)

    def _bucket_by(self, which) -> _Bucket:
        if which in self.buckets:
            return self.buckets[which]
        for b in self.buckets.values():
            if b.label == which:
                return b
        raise KeyError(f"no bucket {which!r}")

    def set_bucket_lanes(self, which, n_lanes: int) -> int:
        """Set one bucket's lane budget (pad_pow2'd, >= 1) — the
        autoscaler's actuator. Growing takes effect at the next
        boundary's admission; shrinking below current residency swaps
        the surplus out (checkpoint as swap unit, ``scale_down``
        eviction reason). Returns the applied (padded) count."""
        with self._exclusive("set_bucket_lanes"):
            bucket = self._bucket_by(which)
            bucket.max_lanes = pad_pow2(max(1, int(n_lanes)))
            return bucket.max_lanes

    def request_spill(self, tenant_id: str) -> None:
        """Mark a resident tenant for swap-out at the next boundary of
        its bucket (checkpoint → queue tail), regardless of the
        fairness quantum — the autoscaler's pressure-relief actuator."""
        with self._exclusive("request_spill"):
            if tenant_id not in self.tenants:
                raise KeyError(f"unknown tenant {tenant_id!r}")
            self._spill.add(tenant_id)

    def note_shed(self, n: int = 1) -> None:
        """Count ``n`` load-shed submissions (429s). Callable from ANY
        thread — the service's request handlers shed while the driver
        owns the scheduler, so this deliberately bypasses the
        ``_exclusive`` contract (its own lock, touches nothing the
        driver mutates). Folded into every per-boundary ``slo``
        journal row and :meth:`slo_snapshot`."""
        with self._load_lock:
            self._sheds += int(n)

    def note_deadline_miss(self, n: int = 1) -> None:
        """Count ``n`` admission-deadline misses (504s) — same
        any-thread contract as :meth:`note_shed`."""
        with self._load_lock:
            self._deadline_misses += int(n)

    def load_counts(self) -> Dict[str, Any]:
        """Cumulative load counters: ``{"arrivals": {label: n},
        "sheds": n, "deadline_misses": n}`` — any-thread safe."""
        with self._load_lock:
            return {"arrivals": dict(self._arrivals),
                    "sheds": self._sheds,
                    "deadline_misses": self._deadline_misses}

    def slo_snapshot(self) -> Dict[str, Dict[str, Any]]:
        """Per-bucket control-plane sensor read: queue depth, lane
        budget/residency/occupancy, queue-wait p99 (bucket-resolution,
        from the metrics histogram when enabled) and the resident
        tenants' ``(id, segments_resident, gens_since_interaction)``
        idle candidates — exactly the inputs
        :class:`deap_tpu_torch.serving.autoscale.AutoscalePolicy` decides
        on. The third element is the true idleness signal: how many
        generations a tenant has advanced since a client last touched
        it — the spill actuator prefers genuinely parked ask-tell
        tenants over mid-job residents whose clients are long-polling."""
        with self._exclusive("slo_snapshot"):
            with self._load_lock:
                arrivals = dict(self._arrivals)
                sheds = self._sheds
                misses = self._deadline_misses
            snap: Dict[str, Dict[str, Any]] = {}
            for b in self.buckets.values():
                wait_p99 = None
                if self._minst is not None:
                    wait_p99 = self._minst.queue_wait_s.quantile(
                        0.99, bucket=b.label)
                snap[b.label] = {
                    "family": b.engine.family,
                    "queue_depth": len(b.queue),
                    "residents": len(b.residents),
                    "lanes": b.max_lanes,
                    "occupancy": len(b.residents) / b.max_lanes,
                    "queue_wait_p99": wait_p99,
                    "arrivals": arrivals.get(b.label, 0),
                    "sheds": sheds,
                    "deadline_misses": misses,
                    "idle": tuple((t.id, t.segments_resident,
                                   t.gens_since_interaction)
                                  for t in b.residents),
                }
            return snap

    def extract(self, tenant_id: str) -> Dict[str, Any]:
        """Checkpoint (when resident) and **remove** one tenant — the
        live-migration primitive. Unlike :meth:`_evict` the
        tenant is not re-queued: it leaves this scheduler entirely,
        because ownership is moving to another driver process. Returns
        a handoff descriptor (``tenant_id`` / ``gen`` / ``ngen`` /
        ``has_checkpoint`` / ``ckpt_dir``) the migration protocol
        offers to the target. Driver thread only; raises ``KeyError``
        for unknown tenants and ``ValueError`` for terminal ones (a
        finished tenant's result lives in its view — nothing to
        move)."""
        with self._exclusive("extract"):
            t = self.tenants.get(tenant_id)
            if t is None:
                raise KeyError(f"unknown tenant {tenant_id!r}")
            if t.done:
                raise ValueError(f"tenant {tenant_id!r} is terminal "
                                 f"({t.status}); nothing to migrate")
            for b in self.buckets.values():
                if t in b.residents:
                    self._checkpoint_traced(b.engine, t,
                                            "checkpoint.migrate")
                    t.evict()
                    b.residents.remove(t)
                    # residency changed mid-lattice: slots are stale,
                    # repack at the next boundary (the finished-tenant
                    # path's rule)
                    b.batch = None
                    if self._minst is not None:
                        self._minst.occupancy.set(
                            len(b.residents) / b.max_lanes,
                            bucket=b.label)
                    break
                if t in b.queue:
                    b.queue.remove(t)
                    if self._minst is not None:
                        self._minst.queue_depth.set(len(b.queue),
                                                    bucket=b.label)
                    break
            del self.tenants[tenant_id]
            self._spill.discard(tenant_id)
            return {"tenant_id": t.id, "gen": int(t.gen),
                    "ngen": int(t.job.ngen),
                    "has_checkpoint": bool(t.has_checkpoint),
                    "ckpt_dir": os.path.join(t.run_dir, "ckpt")}

    def checkpoint_all(self) -> List[str]:
        """Checkpoint every resident tenant (tenant-stamped v2/v3
        meta) — the graceful-drain hook: after the in-flight segment
        finished, this persists every running tenant so a restarted
        scheduler (``resume_tenants=True``) resumes them bit-exactly.
        Queued-never-started tenants need no checkpoint (a fresh
        admission is deterministic). Returns the checkpointed tenant
        ids."""
        with self._exclusive("checkpoint_all"):
            saved = []
            for b in self.buckets.values():
                for t in b.residents:
                    self._checkpoint_traced(b.engine, t,
                                            "checkpoint.drain")
                    saved.append(t.id)
            return saved


def prewarm(scheduler: Scheduler, jobs: Iterable[Job],
            lane_counts: Optional[Sequence[int]] = None) -> int:
    """Module-level alias for :meth:`Scheduler.prewarm` — warm the
    shape buckets at scheduler startup (one journaled
    ``prewarm`` event per bucket/lane-count)."""
    return scheduler.prewarm(jobs, lane_counts=lane_counts)
