"""Operator library of the port: batched tensor functions that take a
``torch.Generator``, plus the CUDA kernels of the main path."""

from deap_tpu_torch.ops.crossover import (
    cx_one_point,
    cx_simulated_binary_bounded,
    cx_two_point,
)
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
from deap_tpu_torch.ops.kernels import (
    dominated_counts,
    dominated_weight_maxes,
    dominated_weight_sums,
    fused_variation,
    nd_rank_tiled,
    strengths_tiled,
)
from deap_tpu_torch.ops.mutation import mut_flip_bit, mut_polynomial_bounded
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
