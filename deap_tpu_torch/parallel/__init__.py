"""Parallelism — meshes, sharding plans, islands and multi-process runs.

Port of :mod:`deap_tpu.parallel`. A mesh of W devices is W ranks of a
``torch.distributed`` process group, one process a device
(:func:`initialize`, or ``torchrun``); a one-device mesh needs no group.
A :class:`ShardingPlan` given to a loop (``plan=``) splits its per-row
work over the ranks and computes the same bits on any rank count, which
is what lets a checkpoint written on W ranks resume on another count.
The island model (:func:`make_island_step`) migrates over stacked demes
(:func:`mig_ring`) or a ring of ranks (:func:`mig_ring_collective`);
:func:`make_sharded_evaluator` splits the genome axis.
"""

from deap_tpu_torch.parallel.mesh import (
    Mesh,
    population_mesh,
    shard_population,
    sharding_fallback,
    sharding_mode,
)
from deap_tpu_torch.parallel.plan import ShardingPlan
from deap_tpu_torch.parallel.migration import (mig_ring, mig_ring_collective,
                                               migRing)
from deap_tpu_torch.parallel.island import (IslandState, island_init,
                                            make_island_step)
from deap_tpu_torch.parallel.multihost import (
    global_population_mesh,
    initialize,
    is_distributed,
    process_count,
    process_index,
)
from deap_tpu_torch.parallel.genome_shard import (
    genome_mesh,
    make_sharded_evaluator,
    shard_genomes,
)

__all__ = [
    "ShardingPlan",
    "sharding_mode",
    "sharding_fallback",
    "initialize",
    "is_distributed",
    "global_population_mesh",
    "process_count",
    "process_index",
    "population_mesh",
    "shard_population",
    "mig_ring",
    "mig_ring_collective",
    "migRing",
    "IslandState",
    "island_init",
    "genome_mesh",
    "make_sharded_evaluator",
    "shard_genomes",
    "make_island_step",
]
