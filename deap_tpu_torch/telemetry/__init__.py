"""Telemetry — for now only the run journal (:mod:`.journal`).

The rest of :mod:`deap_tpu.telemetry` (meters, probes, run telemetry,
costs, metrics, tracing) is ROADMAP A11.
"""

from deap_tpu_torch.telemetry.journal import (
    JournalRows,
    RunJournal,
    broadcast,
    environment_fingerprint,
    journal_generations,
    read_journal,
    toolbox_fingerprint,
)

__all__ = ["JournalRows", "RunJournal", "broadcast",
           "environment_fingerprint", "journal_generations",
           "read_journal", "toolbox_fingerprint"]
