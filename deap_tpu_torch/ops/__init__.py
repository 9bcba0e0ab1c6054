"""Operator library of the port: batched tensor functions that take a
``torch.Generator``, plus the CUDA kernels of the main path."""

from deap_tpu_torch.ops.crossover import (
    cx_blend,
    cx_es_blend,
    cx_es_two_point,
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
    fused_bits,
    fused_variation,
    fused_variation_eval,
    nd_rank_tiled,
    philox_key,
    strengths_tiled,
)
from deap_tpu_torch.ops.kernels_real import (
    eval_rastrigin,
    eval_sphere,
    fused_variation_eval_real,
    real_bits,
)
from deap_tpu_torch.ops.linalg import eigh_jacobi
from deap_tpu_torch.ops.mutation import (
    mut_es_log_normal,
    mut_flip_bit,
    mut_gaussian,
    mut_polynomial_bounded,
    strategy_floor,
)
from deap_tpu_torch.ops.packed import (
    cx_two_point_packed,
    evolve_bits,
    evolve_packed,
    flip_words,
    fused_variation_eval_packed,
    mut_flip_bit_packed,
    pack_genomes,
    packed_fitness,
    popcount,
    sel_tournament_gather_packed,
    unpack_genomes,
)
from deap_tpu_torch.ops.selection import (
    counting_order_desc,
    sel_best,
    sel_random,
    sel_tournament,
    sel_tournament_binned,
    sel_tournament_sorted,
    sel_worst,
    tournament_aspirants,
)
