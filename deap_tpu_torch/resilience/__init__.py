"""Resilience layer — preemption-safe segmented runs, crash-consistent
checkpoints, transient-failure handling, and the fault-injection
harness that proves the recovery paths. Port of
:mod:`deap_tpu.resilience`, with the same public names.

Quick start::

    from deap_tpu_torch.device import make_generator
    from deap_tpu_torch.resilience import ResilientRun

    res = ResilientRun("ckpts/exp42", segment_len=100)
    pop, logbook, hof = res.ea_simple(make_generator(7), pop, toolbox,
                                      0.5, 0.2, ngen=10_000)

The run checkpoints every 100 generations; SIGTERM/SIGINT finish the
in-flight segment, save and raise :class:`Preempted`; re-invoking the
same call (with a generator made from the same seed) resumes from the
newest valid checkpoint with results bit-identical to an uninterrupted
run, and leaves the generator where that run would.
"""

from deap_tpu_torch.resilience.drain import DrainSignal
from deap_tpu_torch.resilience.engine import (
    QUARANTINE_PENALTY,
    Preempted,
    ResilientRun,
    RetryPolicy,
    classify_error,
    quarantine_non_finite,
)
from deap_tpu_torch.resilience.faultinject import (
    CorruptCheckpoint,
    DelaySegment,
    DropResponse,
    FailSegments,
    Fault,
    FaultPlan,
    InjectedCrash,
    InjectedDrop,
    InjectedTransient,
    KillAt,
    KillServiceAt,
    PreemptAt,
    TornWAL,
    corrupt_file,
    nan_inject_evaluate,
)

__all__ = [
    "DrainSignal",
    "QUARANTINE_PENALTY",
    "Preempted",
    "ResilientRun",
    "RetryPolicy",
    "classify_error",
    "quarantine_non_finite",
    "CorruptCheckpoint",
    "DelaySegment",
    "DropResponse",
    "FailSegments",
    "Fault",
    "FaultPlan",
    "InjectedCrash",
    "InjectedDrop",
    "InjectedTransient",
    "KillAt",
    "KillServiceAt",
    "PreemptAt",
    "TornWAL",
    "corrupt_file",
    "nan_inject_evaluate",
]
