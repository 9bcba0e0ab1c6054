from deap_tpu_torch.support.checkpoint import (
    AsyncCheckpointWriter,
    CheckpointCorruptError,
    CheckpointFormatError,
    Checkpointer,
    allow_compat_restore,
    checkpoint_meta,
    restore_state,
    save_state,
    set_compat_restore,
    verify_checkpoint,
)
from deap_tpu_torch.support import compilecache
from deap_tpu_torch.support.history import (
    History,
    Lineage,
    lineage_init,
    lineage_step,
    pair_parents,
)
from deap_tpu_torch.support.hof import HallOfFame, hof_best, hof_init, hof_update
from deap_tpu_torch.support.logbook import Logbook, logbook_from_records
from deap_tpu_torch.support.pareto import (
    ParetoArchive,
    nondominated_mask,
    pareto_init,
    pareto_update,
)
from deap_tpu_torch.support.profiling import (
    SpanRecorder,
    annotate,
    get_span_recorder,
    set_span_recorder,
    span,
    sync,
    timed_generations,
    timed_phases,
    trace,
)
from deap_tpu_torch.support.stats import (MultiStatistics, Statistics,
                                          fitness_stats)

__all__ = ["HallOfFame", "hof_best", "hof_init", "hof_update", "Logbook",
           "logbook_from_records", "MultiStatistics",
           "ParetoArchive", "nondominated_mask", "pareto_init",
           "pareto_update", "Statistics", "fitness_stats",
           "History", "Lineage", "lineage_init", "lineage_step",
           "pair_parents", "trace", "annotate", "span", "sync",
           "SpanRecorder", "set_span_recorder", "get_span_recorder",
           "timed_generations", "timed_phases", "AsyncCheckpointWriter", "CheckpointCorruptError",
           "CheckpointFormatError", "Checkpointer", "allow_compat_restore",
           "checkpoint_meta", "compilecache", "restore_state", "save_state",
           "set_compat_restore", "verify_checkpoint"]
