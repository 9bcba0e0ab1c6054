"""Multi-objective selection and non-dominated sorting (port of
:mod:`deap_tpu.mo`: NSGA-II, streaming SPEA2, the five nd-sort engines,
crowding, Pareto archives' dominance mask)."""

from deap_tpu_torch.mo.emo import (
    ND_PREFIX_THRESHOLD,
    ND_SWEEP_THRESHOLD,
    ND_TILED_THRESHOLD,
    crowding_distances,
    dcd_draws,
    dominance_matrix,
    nd_rank,
    nd_rank_staircase,
    sel_nsga2,
    sel_spea2_stream,
    sel_tournament_dcd,
    selNSGA2,
    selTournamentDCD,
    sort_nondominated,
    sortLogNondominated,
    sortNondominated,
    spea2_fitness_stream,
    uniform_reference_points,
)
from deap_tpu_torch.mo.ndsort import nd_rank_prefix, nd_rank_sweep3
from deap_tpu_torch.support.pareto import nondominated_mask

__all__ = [
    "nd_rank",
    "nd_rank_staircase",
    "nd_rank_sweep3",
    "nd_rank_prefix",
    "ND_PREFIX_THRESHOLD",
    "ND_SWEEP_THRESHOLD",
    "ND_TILED_THRESHOLD",
    "nondominated_mask",
    "dominance_matrix",
    "sort_nondominated",
    "crowding_distances",
    "sel_nsga2",
    "sel_tournament_dcd",
    "dcd_draws",
    "sel_spea2_stream",
    "spea2_fitness_stream",
    "uniform_reference_points",
    "selNSGA2",
    "selTournamentDCD",
    "sortNondominated",
    "sortLogNondominated",
]
