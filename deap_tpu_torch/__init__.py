"""deap_tpu_torch — the PyTorch/CUDA port of deap_tpu.

The same evolutionary-computation framework for one NVIDIA H100: tensor
populations, batched operators and the generational loops in PyTorch,
and every kernel that the JAX package wrote in Pallas for the TPU
rewritten by hand in CUDA C++ for Hopper (``csrc/``, built at first use
by :mod:`deap_tpu_torch._build`). The layout and names mirror
``deap_tpu`` module for module; randomness is an explicit
``torch.Generator`` where ``deap_tpu`` takes a ``jax.random`` key.

Entry points run on the card unless the caller passes ``device="cpu"``.
This package never imports ``jax`` or ``deap_tpu``.
"""

__version__ = "0.1.0"

from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import Population
from deap_tpu_torch.core.toolbox import Toolbox

__all__ = ["FitnessSpec", "Population", "Toolbox", "__version__"]
