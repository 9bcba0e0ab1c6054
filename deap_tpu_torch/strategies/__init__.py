"""Strategy engines — ask-tell optimisers over a state of tensors.

Port of :mod:`deap_tpu.strategies`: the CMA-ES family (Hansen CMA-ES,
:class:`Strategy`, with ``eigh_impl='lapack'`` or ``'jacobi'``; the
(1+λ)-CMA-ES; MO-CMA-ES; BIPOP-CMA-ES), differential evolution
(:class:`DifferentialEvolution`), particle swarms (:class:`PSO`), the
estimation-of-distribution strategies :class:`PBIL` and :class:`EMNA`,
and the dynamic-landscape swarms :class:`MultiSwarmPSO` and
:class:`SpeciationPSO`. The ask-tell ones run under
:func:`deap_tpu_torch.algorithms.ea_generate_update`.
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
from deap_tpu_torch.strategies.de import DifferentialEvolution
from deap_tpu_torch.strategies.eda import EMNA, EMNAState, PBIL, PBILState
from deap_tpu_torch.strategies.multiswarm import (
    MultiSwarmPSO,
    MultiSwarmState,
    SpeciationPSO,
    SpeciationState,
    species_seeds,
)
from deap_tpu_torch.strategies.pso import PSO, SwarmState

__all__ = [
    "bipop_cmaes",
    "MultiSwarmPSO",
    "MultiSwarmState",
    "SpeciationPSO",
    "SpeciationState",
    "species_seeds",
    "CMAState",
    "MOState",
    "OnePlusLambdaState",
    "Strategy",
    "StrategyMultiObjective",
    "StrategyOnePlusLambda",
    "hypervolume_contributions_2d",
    "DifferentialEvolution",
    "EMNA",
    "EMNAState",
    "PBIL",
    "PBILState",
    "PSO",
    "SwarmState",
]
