"""Operator library of the port: batched tensor functions that take a
``torch.Generator``, plus the CUDA kernels of the main path."""

from deap_tpu_torch.ops.crossover import cx_one_point, cx_two_point
from deap_tpu_torch.ops.init import (
    bernoulli_genome,
    constant_genome,
    init_cycle,
    init_iterate,
    init_repeat,
    normal_genome,
    permutation_genome,
    randint_genome,
    uniform_genome,
)
from deap_tpu_torch.ops.kernels import fused_variation
from deap_tpu_torch.ops.mutation import mut_flip_bit
from deap_tpu_torch.ops.packed import (
    fused_variation_eval_packed,
    pack_genomes,
    packed_fitness,
    popcount,
    sel_tournament_gather_packed,
    unpack_genomes,
)
from deap_tpu_torch.ops.selection import (
    sel_tournament,
    sel_tournament_sorted,
    tournament_aspirants,
)
