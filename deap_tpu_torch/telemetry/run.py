"""RunTelemetry — the façade the loops accept.

Port of :mod:`deap_tpu.telemetry.run`. Bundles behind one opt-in
object:

- a :class:`~deap_tpu_torch.telemetry.meter.Meter` whose state the
  loops keep on the device, one state a generation, decoded in one host
  transfer when the run ends;
- a :class:`~deap_tpu_torch.telemetry.journal.RunJournal` receiving host
  events (header, run_start/run_end, compile/retrace, meter rows, span
  aggregates, summary);
- a :class:`~deap_tpu_torch.support.profiling.SpanRecorder` installed
  for the duration of the context, so named spans aggregate host wall
  time.

Usage::

    from deap_tpu_torch.telemetry import RunTelemetry

    with RunTelemetry("run.jsonl") as tel:
        pop, logbook, hof = algorithms.ea_simple(
            generator, pop, toolbox, 0.5, 0.2, ngen=100, telemetry=tel)

Enabling telemetry does not change computed results: the meter reads the
population and feeds nothing back, and draws nothing from the run's
generator.

A ``probe`` extends the built-in instrumentation with caller metrics:
a callable ``probe(meter, mstate, **ctx) -> mstate`` (ctx carries
``pop=``, ``gen=``, the loop's ``sel_idx=`` / ``sel_pool=`` /
``parent_idx=``, ``journal=`` and, for ask-tell loops, ``state=``),
optionally with a ``declare(meter)`` method run before ``meter.init()``
— see :func:`strategy_probe` and :mod:`deap_tpu_torch.telemetry.probes`.
A :class:`~deap_tpu_torch.telemetry.probes.HealthMonitor` passed as
``health=`` turns decoded meter rows into journaled ``alarm`` events.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Optional

from deap_tpu_torch.support.profiling import SpanRecorder, set_span_recorder
from deap_tpu_torch.telemetry.journal import RunJournal
from deap_tpu_torch.telemetry.meter import Meter

__all__ = ["RunTelemetry", "strategy_probe"]


class RunTelemetry:
    """One run's telemetry configuration and lifecycle.

    :param journal: path to a JSONL file, or an existing
        :class:`RunJournal` (several runs may share one journal, which is
        also how builds across runs show up as retraces).
    :param meter: a pre-declared :class:`Meter`; default a fresh one.
    :param probe: extra instrumentation (see module docstring).
    :param stream: emit a live row every generation (stderr tail and
        ``meter_live`` journal events): a host copy each generation,
        which waits for the card, so off by default.
    :param spans: install a :class:`SpanRecorder` while the context is
        active (default True).
    :param fsync_every: when this object opens the journal, fsync every
        n rows (see :class:`RunJournal`).
    :param health: a :class:`~deap_tpu_torch.telemetry.probes.
        HealthMonitor`; every decoded meter row runs through its
        tripwires and each alarm lands in the journal as an ``alarm``
        event. Host-driven loops also poll ``health.stop_requested``.
    """

    def __init__(self, journal, meter: Optional[Meter] = None,
                 probe: Optional[Callable] = None, stream: bool = False,
                 spans: bool = True, init_backend: bool = True,
                 health=None, fsync_every: Optional[int] = None):
        if isinstance(journal, RunJournal):
            self.journal = journal
            self._owns_journal = False
        else:
            self.journal = RunJournal(journal, fsync_every=fsync_every)
            self._owns_journal = True
        self.meter = meter if meter is not None else Meter()
        self.probe = probe
        self.health = health
        self._run_probes: tuple = ()
        self.stream = bool(stream)
        self.recorder: Optional[SpanRecorder] = (
            SpanRecorder() if spans else None)
        self._init_backend = init_backend
        self._prev_recorder: Optional[SpanRecorder] = None
        self._header_written = False

    # --------------------------------------------------------- lifecycle ----

    def __enter__(self) -> "RunTelemetry":
        if self.recorder is not None:
            self._prev_recorder = set_span_recorder(self.recorder)
        return self

    def __exit__(self, *exc) -> None:
        if self.recorder is not None:
            set_span_recorder(self._prev_recorder)
            self.journal.spans(self.recorder)
        self.journal.summary()
        if self._owns_journal:
            self.journal.close()

    # ------------------------------------------------- algorithm helpers ----

    def begin_run(self, algorithm: str, toolbox: Any = None,
                  declare: Optional[Callable] = None, probes=(),
                  **params: Any) -> None:
        """Called by a loop before ``meter.init()``: writes the header
        (once) and a ``run_start`` event, and runs the declaration hooks
        (the loop's built-ins through ``declare``, each probe's
        ``declare``). ``probes`` — the loop's ``probes=`` argument."""
        if not self._header_written:
            self.journal.header(toolbox=toolbox,
                                init_backend=self._init_backend)
            self._header_written = True
        if declare is not None:
            declare(self.meter)
        self.add_probes(probes)
        if self.probe is not None and hasattr(self.probe, "declare"):
            self.probe.declare(self.meter)
        self.journal.event("run_start", algorithm=algorithm, **params)

    def add_probes(self, probes) -> None:
        """Register (and declare) extra probes for later runs —
        ``begin_run`` calls this with the loop's ``probes=`` argument;
        ``make_island_step`` calls it directly (no begin_run there).
        Idempotent per probe instance; must precede ``meter.init()``."""
        for p in tuple(probes or ()):
            if any(p is q for q in self._run_probes):
                continue
            if hasattr(p, "declare"):
                p.declare(self.meter)
            self._run_probes = self._run_probes + (p,)

    def apply_probe(self, mstate, **ctx):
        """Run the user probe and this run's probes, in registration
        order, after the loop's built-ins."""
        for p in ((self.probe,) if self.probe is not None else ()) \
                + self._run_probes:
            mstate = p(self.meter, mstate, journal=self.journal, **ctx)
        return mstate

    def live(self, mstate, gen) -> None:
        """The opt-in streaming emitter (no-op unless ``stream``)."""
        if not self.stream:
            return
        self.meter.stream(mstate, gen, self._emit_live)

    def _emit_live(self, gen: int, row: dict) -> None:
        self.journal.event("meter_live", gen=gen, **row)
        self._check_health(row, gen)
        print(f"[deap_tpu_torch] gen {gen}: " + " ".join(
            f"{k}={v}" for k, v in row.items()
            if not isinstance(v, list)), file=sys.stderr)

    def _check_health(self, row: dict, gen) -> None:
        """Run the HealthMonitor tripwires on one decoded row; every
        alarm becomes a journal ``alarm`` event."""
        if self.health is None:
            return
        for alarm in self.health.check_row(row, gen=gen):
            self.journal.event("alarm", **alarm)

    def record_row(self, mstate, gen) -> None:
        """Host-driven loops (the GP loop, island epoch drivers): journal
        one decoded ``meter`` row now and run the health tripwires on
        it."""
        row = self.meter.row(mstate)
        self.journal.event("meter", gen=gen, **row)
        self._check_health(row, gen)

    def end_run(self, algorithm: str, stacked_meter=None, initial=None,
                gen0: int = 1, **summary: Any) -> None:
        """Called by a loop when it ends: decode the stacked meter states
        (one host transfer) and journal a ``meter`` row per generation,
        then run the health tripwires on each, write ``run_end``, and
        mark the journal steady so later builds surface as retraces."""
        if stacked_meter is not None:
            rows = self.meter.rows(stacked_meter, initial=initial)
            first = gen0 - 1 if initial is not None else gen0
            for i, row in enumerate(rows):
                self.journal.event("meter", gen=first + i, **row)
            for i, row in enumerate(rows):
                self._check_health(row, first + i)
        self.journal.event("run_end", algorithm=algorithm, **summary)
        self.journal.mark_steady(algorithm)


def strategy_probe(strategy: Any, prefix: str = "") -> Callable:
    """A probe publishing an ask-tell strategy's internal state as gauges
    — CMA-ES σ / condition number, (1+λ) success rate, … — for any
    strategy exposing ``metric_names`` and ``metrics(state)`` (the
    three of :mod:`deap_tpu_torch.strategies.cma`)::

        strat = cma.Strategy(centroid=[0.0] * 10, sigma=0.5)
        with RunTelemetry("cma.jsonl", probe=strategy_probe(strat)) as tel:
            state, logbook, _ = algorithms.ea_generate_update(
                generator, strat.initial_state(), toolbox, 50,
                spec=strat.spec, telemetry=tel)
    """
    names = tuple(getattr(strategy, "metric_names", ()))
    if not names:
        raise TypeError(
            f"{type(strategy).__name__} exposes no metric_names; "
            "strategy_probe needs a telemetry-aware strategy")

    class _Probe:
        def declare(self, meter: Meter) -> None:
            for n in names:
                meter.gauge(prefix + n)

        def __call__(self, meter: Meter, mstate, state=None, **_ctx):
            if state is None:
                return mstate
            for k, v in strategy.metrics(state).items():
                mstate = meter.set(mstate, prefix + k, v)
            return mstate

    return _Probe()
