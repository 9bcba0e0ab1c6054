"""Run telemetry — the observability subsystem of the port.

Port of :mod:`deap_tpu.telemetry`, its observability half:

1. **Metrics** (:mod:`.meter`): a :class:`Meter` of counters, gauges and
   histograms whose state the loops keep on the device, one state a
   generation, decoded in one host transfer when the loop ends.
2. **Host events** (:mod:`.journal`): a JSONL :class:`RunJournal` with
   the run header, ``compile``/``retrace`` rows for every ``nvcc``
   build, subsystem events and a final summary.
3. **Spans** (:mod:`deap_tpu_torch.support.profiling`): while a
   :class:`RunTelemetry` is active, ``span`` blocks aggregate host wall
   time per name into the journal, and every span is a
   ``torch.profiler`` range.

On top: :mod:`.probes` (population probes for every loop's ``probes=``
argument and the :class:`HealthMonitor`), :mod:`.costs` (the
:class:`ProgramObservatory`: the kernels each instrumented program
launched and their device time), and the standard-library modules
copied from the JAX package: :mod:`.metrics` (a Prometheus registry),
:mod:`.slo`, :mod:`.alerts`, :mod:`.federation`, :mod:`.tracing` and
:mod:`.report` (a terminal renderer for any journal).

Telemetry is opt-in everywhere and changes no computed result when
enabled. The tuning half of the JAX package's telemetry and support
(``tuning``, ``compilecache``, ``artifacts``) is not ported yet
(ROADMAP A11b); no name of this package's ``__all__`` belongs to it.
"""

from deap_tpu_torch.telemetry.alerts import (
    AlertEngine,
    AlertRule,
    default_rules,
    service_rules,
)
from deap_tpu_torch.telemetry.costs import (
    ProgramObservatory,
    observatory,
    profile_compiled,
)
from deap_tpu_torch.telemetry.federation import (
    federate,
    fleet_summary,
    fleet_trace,
    register_process,
)
from deap_tpu_torch.telemetry.journal import (
    JournalRows,
    RunJournal,
    broadcast,
    environment_fingerprint,
    journal_generations,
    read_journal,
    toolbox_fingerprint,
)
from deap_tpu_torch.telemetry.meter import Meter, MeterState
from deap_tpu_torch.telemetry.metrics import (
    HistogramSnapshot,
    MetricsRegistry,
    get_registry,
    metrics_text,
    serve_metrics,
)
from deap_tpu_torch.telemetry.probes import (
    PROBE_REGISTRY,
    DiversityProbe,
    FitnessProbe,
    FrontProbe,
    HealthMonitor,
    Probe,
    QuarantineProbe,
    SelectionProbe,
    TreeDiversityProbe,
    compose_probes,
    exact_hypervolume,
    register_probe,
)
from deap_tpu_torch.telemetry.run import RunTelemetry, strategy_probe
from deap_tpu_torch.telemetry.slo import (
    DEFAULT_SLOS,
    SLO_JOURNAL_KINDS,
    SloSpec,
    attribute_regression,
    evaluate_gates,
    windowed_curve,
)

__all__ = [
    "AlertEngine",
    "AlertRule",
    "DEFAULT_SLOS",
    "HistogramSnapshot",
    "Meter",
    "MeterState",
    "MetricsRegistry",
    "SLO_JOURNAL_KINDS",
    "SloSpec",
    "PROBE_REGISTRY",
    "Probe",
    "ProgramObservatory",
    "DiversityProbe",
    "TreeDiversityProbe",
    "FitnessProbe",
    "SelectionProbe",
    "FrontProbe",
    "HealthMonitor",
    "QuarantineProbe",
    "RunJournal",
    "RunTelemetry",
    "attribute_regression",
    "broadcast",
    "compose_probes",
    "default_rules",
    "evaluate_gates",
    "federate",
    "fleet_summary",
    "fleet_trace",
    "windowed_curve",
    "environment_fingerprint",
    "exact_hypervolume",
    "get_registry",
    "metrics_text",
    "observatory",
    "profile_compiled",
    "read_journal",
    "register_probe",
    "register_process",
    "serve_metrics",
    "service_rules",
    "strategy_probe",
    "toolbox_fingerprint",
]
