from deap_tpu_torch.core.fitness import (
    FitnessSpec,
    dominates,
    lex_ge,
    lex_gt,
    lex_sort_desc,
    wvalues,
)
from deap_tpu_torch.core.population import (
    Population,
    concat,
    gather,
    init_population,
)
from deap_tpu_torch.core.toolbox import Toolbox

__all__ = [
    "FitnessSpec",
    "Population",
    "Toolbox",
    "dominates",
    "lex_gt",
    "lex_ge",
    "lex_sort_desc",
    "wvalues",
    "gather",
    "concat",
    "init_population",
]
