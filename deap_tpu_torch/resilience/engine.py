"""ResilientRun — preemption-safe segmented execution of the port's loops.

Port of :mod:`deap_tpu.resilience.engine`. The port's loops
(:mod:`deap_tpu_torch.algorithms`, :func:`deap_tpu_torch.gp.make_gp_loop`)
run every generation in one call; a SIGTERM, an out-of-memory error or a
killed process loses all of it. This engine runs a loop in **segments**
of k generations through the very step the loop itself calls, and
checkpoints the whole state between segments: the population or
strategy state, the hall of fame, the records so far and the caller's
``torch.Generator``. A resumed run restores all of it (the generator by
``set_state`` on the caller's own generator) and continues where the
checkpoint stopped, so it draws exactly what an uninterrupted run draws:
its results, and the caller's generator after it, equal the
uninterrupted run's bit for bit. Nothing is drawn to learn λ or the hall
of fame's shape: the ask-tell loop learns them from its first
generation, as the port's loop does.

- **Segments.** SIGTERM/SIGINT set a flag; the in-flight segment
  finishes, its checkpoint lands, a ``preempted`` event is journaled and
  :class:`Preempted` raised — the next invocation of the same call
  resumes there.
- **Checkpoints.** Every boundary goes through
  :meth:`~deap_tpu_torch.support.checkpoint.Checkpointer.save`
  (fsync-before-rename, a CRC32 a leaf); a resume goes through
  ``restore_latest`` (corrupt files skipped and journaled, the newest
  valid one restored onto the run's device). Saves are double-buffered
  by default (:class:`~deap_tpu_torch.support.checkpoint.
  AsyncCheckpointWriter`: an ordered copy of the state at the boundary,
  written by a thread while the next segment runs) and synchronous under
  a ``fault_plan``.
- **Failures.** A segment's error is classified (:func:`classify_error`);
  out-of-memory and transient errors are retried with backoff
  (:class:`RetryPolicy`), each retry journaled as ``degraded``, from the
  segment's in-memory starting state with the generator put back where
  the segment began. Anything else propagates at once.

- **Telemetry.** ``telemetry=`` (a :class:`~deap_tpu_torch.telemetry.
  RunTelemetry`) meters each segment through the loop's own telemetered
  step; the meter states ride in the checkpoint, so a resumed run
  journals every generation's row. ``metrics=`` records segment and
  checkpoint seconds, retries and preemptions as Prometheus instruments
  (:mod:`deap_tpu_torch.telemetry.metrics`); ``trace_every=k`` is the
  flight recorder: every k-th segment under ``torch.profiler``
  (``flight_trace``) and a ``device_memory`` sample at every boundary.
  An active :class:`~deap_tpu_torch.telemetry.ProgramObservatory`
  profiles the first segment of each shape (``program_profile``).

``segment_len="auto"`` asks the dispatch tuner (env
``DEAP_TPU_TORCH_TUNE_SEGMENT_LEN`` → a cached winner → 10).

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: ``plan=`` and :meth:`ResilientRun.island_run` (A12);
:meth:`ResilientRun.multirun` (A13). Journal events go to the
telemetry's journal, or to every open
:class:`~deap_tpu_torch.telemetry.RunJournal`.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Any, Callable, Dict, Optional

import torch

from deap_tpu_torch import algorithms as algos
from deap_tpu_torch import tuning
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device
from deap_tpu_torch.resilience.retry import RetryPolicy
from deap_tpu_torch.support import profiling
from deap_tpu_torch.support.checkpoint import (AsyncCheckpointWriter,
                                               Checkpointer)
from deap_tpu_torch.telemetry import costs, tracing
from deap_tpu_torch.telemetry.journal import broadcast, listening

__all__ = ["Preempted", "RetryPolicy", "ResilientRun", "classify_error",
           "quarantine_non_finite", "QUARANTINE_PENALTY"]


class Preempted(RuntimeError):
    """Raised after a SIGTERM/SIGINT was honoured: the in-flight segment
    finished, its checkpoint is on disk, the journal holds a
    ``preempted`` event. ``step`` is the checkpointed generation;
    re-invoking the same :class:`ResilientRun` call resumes there."""

    def __init__(self, step: int, path: str, signum: int):
        super().__init__(
            f"run preempted by signal {signum}; state for generation "
            f"{step} checkpointed at {path} — re-invoke to resume")
        self.step = step
        self.path = path
        self.signum = signum


#: errors after which the CUDA context is dead: a retry in this process
#: cannot succeed, so they stay fatal whatever else their message says
_FATAL_MARKERS = ("illegal memory access", "illegal instruction",
                  "misaligned address", "unspecified launch failure",
                  "device-side assert", "uncorrectable ECC",
                  "hardware stack error")
#: substrings of error messages classified as retry-worthy transients
#: (the JAX package's runtime and RPC vocabulary)
_TRANSIENT_MARKERS = ("DEADLINE_EXCEEDED", "UNAVAILABLE", "ABORTED",
                      "CANCELLED", "connection reset", "socket closed",
                      "failed to connect")
#: resource exhaustion; ``torch.cuda.OutOfMemoryError`` says "CUDA out
#: of memory"
_RESOURCE_MARKERS = ("RESOURCE_EXHAUSTED", "out of memory", "OOM")


def classify_error(exc: BaseException) -> Optional[str]:
    """``"resource_exhausted"`` / ``"transient"`` for errors a retry
    (possibly after shedding load) can plausibly clear; ``None`` for
    deterministic failures and for the sticky CUDA errors that leave the
    context dead, which must propagate."""
    msg = f"{type(exc).__name__}: {exc}".lower()
    if any(m.lower() in msg for m in _FATAL_MARKERS):
        return None
    if isinstance(exc, torch.cuda.OutOfMemoryError) or any(
            m.lower() in msg for m in _RESOURCE_MARKERS):
        return "resource_exhausted"
    if any(m.lower() in msg for m in _TRANSIENT_MARKERS):
        return "transient"
    return None


# --------------------------------------------------- non-finite guard ----

#: the value a quarantined evaluation receives: worst-case but finite,
#: so max/argmax selection and running means stay well-defined while the
#: row can never win a tournament
QUARANTINE_PENALTY = -3.0e38


def quarantine_non_finite(evaluate: Callable,
                          penalty: float = QUARANTINE_PENALTY,
                          journal: bool = True) -> Callable:
    """Wrap a batched ``evaluate`` so NaN/inf fitness values are replaced
    by ``penalty`` (rounded to the values' dtype) instead of poisoning
    max/argmax selection. With ``journal=True`` a ``quarantine`` event
    (the count of replaced values) goes to the open run journals; the
    count costs a host synchronise, so it is taken only while a journal
    is open."""

    def wrapped(genomes):
        values = evaluate(genomes)
        if not values.is_floating_point():
            return values
        bad = ~torch.isfinite(values)
        fill = float(torch.tensor(penalty, dtype=torch.float64).to(
            values.dtype))
        out = values.masked_fill(bad, fill)
        if journal and listening():
            n = int(bad.sum())
            if n:
                broadcast("quarantine", n=n)
        return out

    wrapped.penalty = penalty
    wrapped.__wrapped__ = evaluate
    return wrapped


# ----------------------------------------------------- serving metrics ----

def _resolve_metrics(metrics):
    from deap_tpu_torch.telemetry.metrics import resolve_registry
    return resolve_registry(metrics)


class _ResilienceInstruments:
    """The engine's Prometheus instruments, declared once per registry
    (create-or-get, so declaring again is safe)."""

    def __init__(self, registry):
        self.segment_s = registry.histogram(
            "deap_resilience_segment_seconds",
            "wall seconds per executed segment", labels=("algorithm",))
        self.checkpoint_s = registry.histogram(
            "deap_resilience_checkpoint_seconds",
            "wall seconds submitting/writing a boundary checkpoint",
            labels=("algorithm",))
        self.retries = registry.counter(
            "deap_resilience_retries_total",
            "transient segment retries", labels=("algorithm", "kind"))
        self.preemptions = registry.counter(
            "deap_resilience_preemptions_total",
            "honoured SIGTERM/SIGINT preemptions",
            labels=("algorithm",))


# ---------------------------------------------------------- loop specs ----

def _segment_signature(state, lo, hi):
    """A segment program's input signature: the shapes of what it carries
    and its length (the JAX engine's scan signature)."""
    return (hi - lo, costs.signature_of((state["carry"],
                                         state.get("mstate"))))

class _LoopSpec:
    """What a loop gives the engine: build the gen-0 state, run
    generations [lo, hi) on it, produce the final result. The state is
    one checkpointable tree which, with the generator it holds, fixes
    the rest of the run."""

    algorithm = "?"

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.run_segment = self.segment

    def _instrument(self) -> None:
        """Route segments through the program observatory's seam (the
        JAX engine instruments its segment scan the same way)."""
        self.run_segment = costs.instrument(
            self.segment, label=f"resilient_{self.algorithm}",
            signature=_segment_signature)

    def init(self) -> Dict[str, Any]:
        raise NotImplementedError

    def on_resume(self, state: Dict[str, Any]) -> None:
        """Put the restored generator state into the caller's own
        generator, which the rest of the run draws from."""
        self.generator.set_state(state["generator"].get_state())
        state["generator"] = self.generator

    def segment(self, state: Dict[str, Any], lo: int, hi: int
                ) -> Dict[str, Any]:
        raise NotImplementedError

    def finalize(self, state: Dict[str, Any]):
        raise NotImplementedError

    def stop_requested(self, state: Dict[str, Any]) -> bool:
        return False


class _PopLoopSpec(_LoopSpec):
    """``ea_simple`` and the (μ + λ) / (μ, λ) loops: gen 0 as
    ``algorithms._pop_loop_init``, then the loop's own step once a
    generation."""

    def __init__(self, algorithm: str, step, generator, pop, toolbox,
                 stats, halloffame_size: int, device: torch.device,
                 tel=None, ngen: int = 0):
        self.algorithm = algorithm
        super().__init__(generator)
        self.step = step
        self.pop = pop
        self.toolbox = toolbox
        self.stats = stats
        self.halloffame_size = halloffame_size
        self.device = device
        self.tel = tel
        self.ngen = int(ngen)
        self._instrument()

    def init(self):
        pop, hof, record0 = algos._pop_loop_init(
            self.pop.to(self.device), self.toolbox, self.halloffame_size,
            self.stats)
        state = {"gen": 0, "generator": self.generator, "carry": (pop, hof),
                 "records": [], "record0": record0}
        if self.tel is not None:
            mstate0 = algos._tel_measure(
                self.tel, self.tel.meter.init(device=self.device),
                record0["nevals"], pop, 0)
            state.update(mstate=mstate0, mstate0=mstate0, mrows=[])
        return state

    def on_resume(self, state):
        """The caller's generator, as :class:`_LoopSpec`; then the meter
        states adapted to this run: a checkpoint written with telemetry
        resumed without it drops them, one written without it resumed
        with it starts a fresh meter state (the metric history starts at
        the resume; the evolutionary state is untouched either way)."""
        super().on_resume(state)
        if self.tel is None:
            for k in ("mstate", "mstate0", "mrows"):
                state.pop(k, None)
        elif state.get("mstate") is None:
            fresh = self.tel.meter.init(device=self.device)
            state.update(mstate=fresh, mstate0=fresh, mrows=[])

    def segment(self, state, lo, hi):
        pop, hof = state["carry"]
        records, mstates = [], []
        mstate = state.get("mstate")
        for gen in range(lo + 1, hi + 1):
            if self.tel is None:
                pop, hof, rec = self.step(self.generator, pop, hof)
            else:
                pop, hof, rec, mstate = self.step(self.generator, pop, hof,
                                                  mstate, gen)
                mstates.append(mstate)
            records.append(rec)
        state.update(carry=(pop, hof), records=state["records"] + records,
                     gen=hi)
        if self.tel is not None:
            # one stacked state a segment keeps the checkpoint's leaves few
            state.update(mstate=mstate, mrows=state["mrows"] + [
                self.tel.meter.stack(mstates)])
        return state

    def finalize(self, state):
        if self.tel is not None:
            self.tel.end_run(self.algorithm,
                             stacked_meter=_concat_stacked(state["mrows"]),
                             initial=state["mstate0"], gen0=1,
                             ngen=self.ngen, segmented=True)
        logbook = algos._build_logbook(state["record0"], state["records"],
                                       self.stats)
        pop, hof = state["carry"]
        return pop, logbook, hof


def _concat_stacked(parts):
    """Concatenate per-segment stacked meter states along the generation
    axis (``{}`` for none)."""
    parts = [p for p in parts if p]
    if not parts:
        return {}
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


class _AskTellSpec(_LoopSpec):
    """The ask-tell loop. λ and the hall of fame come from the first
    generation's genomes, inside the first segment, as
    ``algorithms.ea_generate_update`` learns them: nothing is drawn to
    learn them, and a resumed run reads λ from its checkpoint."""

    algorithm = "ea_generate_update"

    def __init__(self, generator, state, toolbox, spec, stats,
                 halloffame_size: int, device: torch.device, tel=None,
                 probes=(), ngen: int = 0):
        super().__init__(generator)
        self.state0 = state
        self.toolbox = toolbox
        self.spec = spec
        self.stats = stats
        self.halloffame_size = halloffame_size
        self.device = device
        self.tel = tel
        self.probes = probes
        self.ngen = int(ngen)
        self._made: Optional[Callable] = None
        self._begun = False
        self._instrument()

    def _step(self, lam: int):
        if self._made is None:  # λ is the run's, fixed at gen 0
            self._made = algos.make_ea_generate_update_step(
                self.toolbox, self.spec, lam, self.stats, self.tel)
        return self._made

    def _begin(self, lam) -> None:
        """``run_start`` and the meter's declarations, once λ is known
        (the first generation, or the checkpoint of a resumed run)."""
        if self.tel is not None and not self._begun:
            self._begun = True
            self.tel.begin_run(self.algorithm, self.toolbox,
                               declare=algos._tel_declare,
                               probes=self.probes, ngen=self.ngen,
                               lambda_=lam, resilient=True)

    def init(self):
        return {"gen": 0, "generator": self.generator,
                "carry": (self.state0, None), "records": [], "lam": None,
                "mstate": None, "mrows": []}

    def on_resume(self, state):
        super().on_resume(state)
        if self.tel is None:
            state.update(mstate=None, mrows=[])
            return
        self._begin(state["lam"])
        if state.get("mstate") is None and state["lam"] is not None:
            state.update(mstate=self.tel.meter.init(device=self.device),
                         mrows=[])

    def segment(self, state, lo, hi):
        st, hof = state["carry"]
        lam, mstate = state["lam"], state.get("mstate")
        records, mstates = [], []
        tel = self.tel
        for gen in range(lo, hi):
            if lam is None:
                genomes = self.toolbox.generate(self.generator, st)
                values = algos._as2d(self.toolbox.evaluate(genomes))
                lam, hof = algos._generate_update_init(
                    genomes, values, self.spec, self.halloffame_size)
                tell = self._step(lam).tell
                if tel is None:
                    st, hof, rec = tell(st, hof, genomes, values)
                else:
                    self._begin(lam)
                    st, hof, rec, mstate = tell(
                        st, hof, genomes, values,
                        tel.meter.init(device=self.device), gen)
            elif tel is None:
                st, hof, rec = self._step(lam)(self.generator, st, hof)
            else:
                st, hof, rec, mstate = self._step(lam)(
                    self.generator, st, hof, mstate, gen)
            records.append(rec)
            if tel is not None:
                mstates.append(mstate)
        state.update(carry=(st, hof), lam=lam,
                     records=state["records"] + records, gen=hi)
        if tel is not None:
            state.update(mstate=mstate, mrows=state["mrows"] + [
                tel.meter.stack(mstates)])
        return state

    def finalize(self, state):
        if self.tel is not None:
            self._begin(state["lam"])
            self.tel.end_run(self.algorithm,
                             stacked_meter=_concat_stacked(state["mrows"]),
                             gen0=0, ngen=self.ngen, segmented=True)
        logbook = algos._build_gu_logbook(state["records"], self.stats)
        st, hof = state["carry"]
        return st, logbook, hof


class _GPLoopSpec(_LoopSpec):
    """The host-dispatch GP engine, driven through ``run.advance`` a
    generation at a time with checkpoints at segment boundaries."""

    algorithm = "gp_loop"

    def __init__(self, loop_run, generator, genomes, ngen: int):
        if getattr(loop_run, "init_state", None) is None:
            raise TypeError("gp_loop needs a run built by make_gp_loop")
        super().__init__(generator)
        self.run = loop_run
        self.genomes = genomes
        self.ngen = int(ngen)

    def init(self):
        gp = self.run.init_state(self.genomes, self.ngen)
        return {"gen": gp["gen"], "generator": self.generator, "gp": gp}

    def on_resume(self, state):
        super().on_resume(state)
        if self.run.begin_telemetry is not None:
            self.run.begin_telemetry(self.ngen,
                                     int(state["gp"]["fit"].shape[0]))
            if state["gp"].get("mstate") is None:
                # a checkpoint written without telemetry: the metric
                # history starts here
                state["gp"]["mstate"] = self.run.telemetry.meter.init(
                    device=state["gp"]["fit"].device)

    def segment(self, state, lo, hi):
        # advance updates its dict in place; a retried segment must start
        # from the untouched one (its tensors are never written in place)
        gp = dict(state["gp"], nevals=list(state["gp"]["nevals"]))
        for _ in range(lo, hi):
            if gp["stopped_at"] is not None:
                break
            self.run.advance(self.generator, gp)
        state.update(gp=gp, gen=hi)
        return state

    def finalize(self, state):
        return self.run.finalize(state["gp"], self.ngen)

    def stop_requested(self, state):
        return state["gp"]["stopped_at"] is not None


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class ResilientRun:
    """Segmented, checkpointed, signal-aware engine for the port's loops.
    One instance drives one logical run; constructing it again over the
    same checkpoint directory resumes that run::

        res = ResilientRun("ckpts/run7", segment_len=50)
        pop, logbook, hof = res.ea_simple(generator, pop, tb, 0.5, 0.2,
                                          ngen=1000)
        # SIGTERM mid-run → Preempted after the in-flight segment's
        # checkpoint lands; the same call in the next process, with a
        # generator made from the same seed, continues at that segment
        # bit for bit and leaves the generator where an uninterrupted
        # run would.

    Each method takes the caller's ``torch.Generator`` where the JAX
    package's takes a key, and ``device=`` as the port's loops do (the
    card unless ``device="cpu"``); a restored checkpoint lands there.

    :param checkpoints: a directory path or a pre-built
        :class:`~deap_tpu_torch.support.checkpoint.Checkpointer`.
    :param segment_len: generations per segment — the preemption and
        checkpoint granularity; ``"auto"`` is the dispatch tuner's (10
        with no tuner, no override and no cached winner).
    :param retry: a :class:`RetryPolicy` (default: 2 retries, 50 ms
        doubling backoff) for transient segment failures.
    :param degrade_cb: ``degrade_cb(kind, exc) -> description`` called
        before each retry; its return value is journaled in the
        ``degraded`` event.
    :param handle_signals: install SIGTERM/SIGINT handlers for the
        drive (main thread only; elsewhere skipped).
    :param double_buffer: write each boundary's checkpoint on a thread
        while the next segment runs, from an ordered copy of the state
        taken at the boundary; the write is drained before the next
        boundary's, before a ``Preempted`` raise and before the drive
        returns. Forced off when a ``fault_plan`` is present: its events
        (corrupt-after-save etc.) assume the file exists the moment
        ``saved`` fires.
    :param fault_plan: a deterministic
        :class:`~deap_tpu_torch.resilience.faultinject.FaultPlan` — test
        harness hook, inert in production.
    :param tenant_id: written into every checkpoint's ``meta`` and
        required of any checkpoint this run resumes from.
    :param telemetry: a :class:`~deap_tpu_torch.telemetry.RunTelemetry`:
        the segment, resume and degraded events go to its journal, and
        the population and ask-tell loops are metered (one ``meter`` row
        a generation, journaled when the run ends; the GP loop meters
        itself, built with ``telemetry=``). Its journal's ``run_id``
        becomes the run's.
    :param trace_every: the flight recorder: every k-th segment this
        drive runs goes under ``torch.profiler`` (a chrome trace in
        ``trace_dir/seg_<lo>/``, journaled as ``flight_trace``; the
        segment is synchronised before the trace closes, which changes
        no value), and every boundary journals a ``device_memory``
        sample, with the allocator's statistics written beside the
        traced ones.
    :param trace_dir: the flight recorder's directory (default
        ``<checkpoint dir>/flight``).
    :param metrics: a :class:`~deap_tpu_torch.telemetry.metrics.
        MetricsRegistry` (or ``True`` for the process registry): segment
        and checkpoint seconds, retries and preemptions are recorded as
        ``deap_resilience_*`` instruments.
    """

    def __init__(self, checkpoints, *, segment_len: int = 10,
                 keep: int = 3, telemetry=None,
                 retry: Optional[RetryPolicy] = None,
                 degrade_cb: Optional[Callable] = None,
                 handle_signals: bool = True,
                 double_buffer: bool = True, fault_plan=None,
                 run_id: Optional[str] = None,
                 tenant_id: Optional[str] = None,
                 plan=None, trace_every: Optional[int] = None,
                 trace_dir: Optional[str] = None, metrics=None):
        if segment_len == "auto":
            # the dispatch tuner's ladder (env → cached winner → 10); the
            # winner is probed and recorded out of band, since an inline
            # probe would need a whole segmented run in hand
            segment_len = tuning.resolve_int("segment_len", default=10,
                                             program="resilient_scan")
        if plan is not None:
            raise _not_ported("plan= (sharding)", "A12")
        if isinstance(checkpoints, Checkpointer):
            self.ckpt = checkpoints
        else:
            self.ckpt = Checkpointer(str(checkpoints), keep=keep)
        if segment_len < 1:
            raise ValueError("segment_len must be >= 1")
        self.segment_len = int(segment_len)
        self.telemetry = telemetry
        self.retry = retry if retry is not None else RetryPolicy()
        self.degrade_cb = degrade_cb
        self.handle_signals = bool(handle_signals)
        self.fault_plan = fault_plan
        self.double_buffer = bool(double_buffer) and fault_plan is None
        if run_id is None and telemetry is not None:
            run_id = telemetry.journal.run_id
        self.run_id = run_id or hex(int(time.time() * 1e6))[2:]
        self.tenant_id = tenant_id
        if trace_every is not None and int(trace_every) < 1:
            raise ValueError("trace_every must be >= 1")
        self.trace_every = int(trace_every) if trace_every else None
        self.trace_dir = (str(trace_dir) if trace_dir is not None
                          else os.path.join(self.ckpt.directory, "flight"))
        self._last_trace_dir: Optional[str] = None
        self._metrics = _resolve_metrics(metrics)
        self._minst = (_ResilienceInstruments(self._metrics)
                       if self._metrics is not None else None)
        self.preempt_requested = False
        self._preempt_signum: Optional[int] = None
        self.resumed_from: Optional[str] = None
        self.last_step: Optional[int] = None

    # ------------------------------------------------------ loop entries ----

    def ea_simple(self, generator, pop, toolbox, cxpb, mutpb, ngen, *,
                  stats=None, halloffame_size=0, probes=(), fused="auto",
                  device: DeviceLike = None):
        """:func:`deap_tpu_torch.algorithms.ea_simple` in segments."""
        tel = self._begin_pop("ea_simple", probes, ngen=ngen, n=pop.size,
                              cxpb=cxpb, mutpb=mutpb)
        step = algos.make_ea_simple_step(toolbox, cxpb, mutpb, stats, tel,
                                         fused=fused)
        return self._drive_pop("ea_simple", step, generator, pop, toolbox,
                               ngen, stats, halloffame_size, device, tel)

    def ea_mu_plus_lambda(self, generator, pop, toolbox, mu, lambda_, cxpb,
                          mutpb, ngen, *, stats=None, halloffame_size=0,
                          probes=(), fused="auto",
                          device: DeviceLike = None):
        """:func:`deap_tpu_torch.algorithms.ea_mu_plus_lambda` in
        segments."""
        algos._check_cx_mut(cxpb, mutpb)
        tel = self._begin_pop("ea_mu_plus_lambda", probes, ngen=ngen, mu=mu,
                              lambda_=lambda_, cxpb=cxpb, mutpb=mutpb)
        step = algos.make_ea_mu_plus_lambda_step(
            toolbox, mu, lambda_, cxpb, mutpb, stats, tel, fused=fused)
        return self._drive_pop("ea_mu_plus_lambda", step, generator, pop,
                               toolbox, ngen, stats, halloffame_size, device,
                               tel)

    def ea_mu_comma_lambda(self, generator, pop, toolbox, mu, lambda_, cxpb,
                           mutpb, ngen, *, stats=None, halloffame_size=0,
                           probes=(), fused="auto",
                           device: DeviceLike = None):
        """:func:`deap_tpu_torch.algorithms.ea_mu_comma_lambda` in
        segments."""
        if lambda_ < mu:
            raise ValueError("lambda must be greater or equal to mu.")
        algos._check_cx_mut(cxpb, mutpb)
        tel = self._begin_pop("ea_mu_comma_lambda", probes, ngen=ngen,
                              mu=mu, lambda_=lambda_, cxpb=cxpb, mutpb=mutpb)
        step = algos.make_ea_mu_comma_lambda_step(
            toolbox, mu, lambda_, cxpb, mutpb, stats, tel, fused=fused)
        return self._drive_pop("ea_mu_comma_lambda", step, generator, pop,
                               toolbox, ngen, stats, halloffame_size, device,
                               tel)

    def ea_generate_update(self, generator, state, toolbox, ngen, spec, *,
                           stats=None, halloffame_size=0, probes=(),
                           device: DeviceLike = None):
        """:func:`deap_tpu_torch.algorithms.ea_generate_update` in
        segments (``run_start``, with λ, is journaled once the first
        generation, or the checkpoint, has told λ)."""
        algos._check_probes(probes, self.telemetry)
        dev = resolve_device(device)
        check_generator(generator, dev)
        return self._drive(_AskTellSpec(generator, state, toolbox, spec,
                                        stats, halloffame_size, dev,
                                        self.telemetry, probes, ngen),
                           ngen, dev)

    def gp_loop(self, loop_run, generator, genomes, ngen, *,
                device: DeviceLike = None):
        """Drive a :func:`deap_tpu_torch.gp.make_gp_loop` engine (built
        on ``device``) in segments; returns its usual result dict."""
        dev = resolve_device(device)
        check_generator(generator, dev)
        return self._drive(_GPLoopSpec(loop_run, generator, genomes, ngen),
                           ngen, dev)

    def island_run(self, *args, **kwargs):
        raise _not_ported("island_run", "A12")

    def multirun(self, *args, **kwargs):
        raise _not_ported("multirun", "A13")

    # -------------------------------------------------------- plumbing ----

    def _begin_pop(self, algorithm, probes, **params):
        tel = self.telemetry
        algos._check_probes(probes, tel)
        if tel is not None:
            tel.begin_run(algorithm, None, declare=algos._tel_declare,
                          probes=probes, resilient=True, **params)
        return tel

    def _drive_pop(self, algorithm, step, generator, pop, toolbox, ngen,
                   stats, halloffame_size, device, tel):
        dev = resolve_device(device)
        check_generator(generator, dev)
        spec = _PopLoopSpec(algorithm, step, generator, pop, toolbox, stats,
                            halloffame_size, dev, tel, ngen)
        return self._drive(spec, ngen, dev)

    def _journal_event(self, kind: str, **payload) -> None:
        payload.setdefault("run_id", self.run_id)
        if self.telemetry is not None:
            self.telemetry.journal.event(kind, **payload)
        else:
            broadcast(kind, **payload)

    def _fault(self, event: str, **ctx) -> None:
        if self.fault_plan is not None:
            self.fault_plan.fire(event, ckpt=self.ckpt, run=self, **ctx)

    # --------------------------------------------------------- the drive ----

    def _drive(self, spec: _LoopSpec, total: int, device: torch.device):
        total = int(total)
        resumed = self.ckpt.restore_latest(tenant_id=self.tenant_id,
                                           device=device)
        if resumed is not None:
            step0, state = resumed
            meta = state.get("_resilience", {})
            if meta.get("algorithm") not in (None, spec.algorithm):
                raise ValueError(
                    f"checkpoint dir {self.ckpt.directory} holds a "
                    f"{meta.get('algorithm')!r} run; refusing to resume "
                    f"it as {spec.algorithm!r}")
            self.resumed_from = meta.get("run_id")
            spec.on_resume(state)
            self._journal_event("resumed", algorithm=spec.algorithm,
                                step=step0, resumed_from=self.resumed_from)
        else:
            state = spec.init()
            state["_resilience"] = {"algorithm": spec.algorithm,
                                    "run_id": self.run_id, "ngen": total}
            self._journal_event("segments_begin", algorithm=spec.algorithm,
                                ngen=total, segment_len=self.segment_len)
        state["_resilience"]["run_id"] = self.run_id

        writer = AsyncCheckpointWriter() if self.double_buffer else None
        try:
            with self._signals():
                gen = int(state["gen"])
                seg_i = 0  # segments run by this drive: the flight
                #            recorder's cadence
                while gen < total and not spec.stop_requested(state):
                    hi = min(gen + self.segment_len, total)
                    self._fault("segment_start", lo=gen, hi=hi)
                    t_seg = time.perf_counter()
                    self._last_trace_dir = None
                    state = self._flight_segment(spec, state, gen, hi, seg_i)
                    seg_s = time.perf_counter() - t_seg
                    if self._minst is not None:
                        self._minst.segment_s.observe(
                            seg_s, algorithm=spec.algorithm)
                    # the trace plane's segment span (a no-op outside a
                    # traced request), linked to a flight trace
                    tracing.emit_current(
                        "segment.run", seg_s, phase="device", lo=gen, hi=hi,
                        algorithm=spec.algorithm,
                        links=([{"trace_dir": self._last_trace_dir}]
                               if self._last_trace_dir else None))
                    self._fault("segment_end", lo=gen, hi=hi)
                    meta = dict(state["_resilience"], step=hi)
                    if self.tenant_id is not None:
                        meta["tenant_id"] = self.tenant_id
                    t_ck = time.perf_counter()
                    if writer is not None:
                        # submit() first drains the previous boundary's
                        # write, which ran beside this segment
                        path = writer.submit(self.ckpt, hi, state, meta=meta)
                    else:
                        path = self.ckpt.save(hi, state, meta=meta)
                    ck_s = time.perf_counter() - t_ck
                    if self._minst is not None:
                        self._minst.checkpoint_s.observe(
                            ck_s, algorithm=spec.algorithm)
                    tracing.emit_current("checkpoint", ck_s,
                                         phase="checkpoint", step=hi,
                                         async_save=writer is not None)
                    self.last_step = hi
                    self._journal_event("segment", algorithm=spec.algorithm,
                                        lo=gen, hi=hi, path=path,
                                        async_save=writer is not None)
                    self._record_memory(hi, seg_i)
                    self._fault("saved", lo=gen, hi=hi, path=path)
                    gen = hi
                    seg_i += 1
                    if self.preempt_requested:
                        if writer is not None:
                            writer.wait()  # durable before we claim so
                        if self._minst is not None:
                            self._minst.preemptions.inc(
                                algorithm=spec.algorithm)
                        self._journal_event(
                            "preempted", algorithm=spec.algorithm,
                            step=gen, signum=self._preempt_signum)
                        raise Preempted(gen, path, self._preempt_signum or 0)
            if writer is not None:
                writer.wait()  # surface any background write error
        except BaseException:
            if writer is not None:
                try:  # the last good write should still land
                    writer.wait()
                except Exception as e:
                    self._journal_event("checkpoint_write_failed",
                                        error=repr(e)[:300])
            raise
        return spec.finalize(state)

    # ---------------------------------------------------- flight recorder ----

    def _flight_segment(self, spec: _LoopSpec, state, lo: int, hi: int,
                        seg_i: int):
        """Run one segment, under ``torch.profiler`` when the flight
        recorder's cadence says so. The traced segment is synchronised
        before the trace closes (the card runs behind the host, and an
        unsynchronised exit would cut its timeline short); that waits
        for the card and changes no value."""
        if self.trace_every is None or seg_i % self.trace_every:
            return self._run_segment(spec, state, lo, hi)
        tdir = os.path.join(self.trace_dir, f"seg_{lo:06d}")
        with profiling.trace(tdir):
            state = self._run_segment(spec, state, lo, hi)
            profiling.sync(state)
        self._journal_event("flight_trace", algorithm=spec.algorithm,
                            lo=lo, hi=hi, dir=tdir)
        self._last_trace_dir = tdir
        return state

    def _record_memory(self, step: int, seg_i: int) -> None:
        """The flight recorder's boundary sample: the allocator's live
        bytes every boundary, its whole statistics written beside the
        traced boundaries."""
        if self.trace_every is None:
            return
        path = None
        if seg_i % self.trace_every == 0:
            os.makedirs(self.trace_dir, exist_ok=True)
            path = os.path.join(self.trace_dir, f"mem_{step:06d}.json")
        snap = profiling.device_memory_snapshot(path)
        self._journal_event("device_memory", step=step, **snap)

    def _run_segment(self, spec: _LoopSpec, state, lo: int, hi: int):
        attempt = 0
        at_start = spec.generator.get_state()
        while True:
            try:
                self._fault("segment_attempt", lo=lo, hi=hi, attempt=attempt)
                return spec.run_segment(state, lo, hi)
            except Exception as exc:
                kind = classify_error(exc)
                if kind is None or attempt >= self.retry.max_retries:
                    self._journal_event(
                        "segment_failed", algorithm=spec.algorithm, lo=lo,
                        hi=hi, attempt=attempt, error=repr(exc)[:300],
                        error_kind=kind or "fatal")
                    raise
                action = None
                if self.degrade_cb is not None:
                    action = self.degrade_cb(kind, exc)
                if self._minst is not None:
                    self._minst.retries.inc(algorithm=spec.algorithm,
                                            kind=kind)
                delay = self.retry.delay(attempt)
                self._journal_event(
                    "degraded", algorithm=spec.algorithm, lo=lo, hi=hi,
                    error_kind=kind, attempt=attempt,
                    backoff_s=round(delay, 4), error=repr(exc)[:300],
                    **({"action": action} if action else {}))
                self.retry.sleep(delay)
                # the retry draws what the failed attempt drew
                spec.generator.set_state(at_start)
                attempt += 1

    # ----------------------------------------------------------- signals ----

    def _signals(self):
        run = self

        class _Guard:
            def __enter__(self):
                self.prev = {}
                if (not run.handle_signals
                        or threading.current_thread()
                        is not threading.main_thread()):
                    return self

                def handler(signum, frame):
                    run.preempt_requested = True
                    run._preempt_signum = signum

                for sig in (signal.SIGTERM, signal.SIGINT):
                    self.prev[sig] = signal.signal(sig, handler)
                return self

            def __exit__(self, *exc):
                for sig, h in self.prev.items():
                    signal.signal(sig, h)

        return _Guard()
