"""Strategy engines — ask-tell optimisers over a state of tensors.

Port of :mod:`deap_tpu.strategies`, so far the CMA-ES family: Hansen
CMA-ES (:class:`Strategy`, :class:`CMAState`; ``eigh_impl='lapack'`` or
``'jacobi'``), the (1+λ)-CMA-ES (:class:`StrategyOnePlusLambda`,
:class:`OnePlusLambdaState`), MO-CMA-ES (:class:`StrategyMultiObjective`,
:class:`MOState`, :func:`hypervolume_contributions_2d`), driven by
:func:`deap_tpu_torch.algorithms.ea_generate_update`, and BIPOP-CMA-ES
(:func:`bipop_cmaes`). PSO, DE, EDA (PBIL, EMNA) and the multi-swarm
strategies are still to port (ROADMAP.md A6).
"""

from deap_tpu_torch.strategies.bipop import bipop_cmaes
from deap_tpu_torch.strategies.cma import (
    CMAState,
    MOState,
    OnePlusLambdaState,
    Strategy,
    StrategyMultiObjective,
    StrategyOnePlusLambda,
    hypervolume_contributions_2d,
)

__all__ = ["bipop_cmaes", "CMAState", "MOState", "OnePlusLambdaState",
           "Strategy", "StrategyMultiObjective", "StrategyOnePlusLambda",
           "hypervolume_contributions_2d"]
