"""Parallelism — the port's part of :mod:`deap_tpu.parallel`.

Only what ``bench_suite.py``'s cart-pole configuration calls is ported:
:func:`population_mesh` and :func:`shard_population`, on one device (a
mesh of more than one raises). Islands, migration, sharding plans,
genome sharding and multi-host runs are still to port.
"""

from deap_tpu_torch.parallel.mesh import Mesh, population_mesh, shard_population

__all__ = ["Mesh", "population_mesh", "shard_population"]
