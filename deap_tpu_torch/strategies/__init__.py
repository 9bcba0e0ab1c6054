"""Strategy engines — ask-tell optimisers over a state of tensors.

Port of :mod:`deap_tpu.strategies`, so far Hansen CMA-ES
(:class:`Strategy`, :class:`CMAState`), driven by
:func:`deap_tpu_torch.algorithms.ea_generate_update`. The (1+λ) and
multi-objective CMA-ES, BIPOP, PSO, DE, EDA and the multi-swarm
strategies are still to port (ROADMAP.md A6).
"""

from deap_tpu_torch.strategies.cma import CMAState, Strategy

__all__ = ["CMAState", "Strategy"]
