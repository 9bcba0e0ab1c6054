"""Operator library of the port: batched tensor functions that take a
``torch.Generator``, plus the CUDA kernels of the main path."""

from deap_tpu_torch.ops.constraint import (
    ClosestValidPenality,
    ClosestValidPenalty,
    DeltaPenality,
    DeltaPenalty,
    closest_valid_penalty,
    delta_penalty,
)
from deap_tpu_torch.ops.crossover import (
    cx_blend,
    cx_es_blend,
    cx_es_two_point,
    cx_messy_one_point,
    cx_one_point,
    cx_ordered,
    cx_partialy_matched,
    cx_simulated_binary,
    cx_simulated_binary_bounded,
    cx_two_point,
    cx_uniform,
    cx_uniform_partialy_matched,
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
    mut_shuffle_indexes,
    mut_two_opt,
    mut_uniform_int,
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
from deap_tpu_torch.ops.variation import (
    VariationPlan,
    apply_variation,
    resolve_plan,
)
from deap_tpu_torch.ops.selection import (
    counting_order_desc,
    sel_automatic_epsilon_lexicase,
    sel_best,
    sel_double_tournament,
    sel_epsilon_lexicase,
    sel_lexicase,
    sel_random,
    sel_roulette,
    sel_stochastic_universal_sampling,
    sel_tournament,
    sel_tournament_binned,
    sel_tournament_sorted,
    sel_worst,
    tournament_aspirants,
)

# DEAP-style camelCase aliases, as the JAX package exports them
cxOnePoint = cx_one_point
cxTwoPoint = cx_two_point
cxUniform = cx_uniform
cxPartialyMatched = cx_partialy_matched
cxUniformPartialyMatched = cx_uniform_partialy_matched
cxOrdered = cx_ordered
cxBlend = cx_blend
cxSimulatedBinary = cx_simulated_binary
cxSimulatedBinaryBounded = cx_simulated_binary_bounded
cxMessyOnePoint = cx_messy_one_point
cxESBlend = cx_es_blend
cxESTwoPoint = cx_es_two_point

mutGaussian = mut_gaussian
mutPolynomialBounded = mut_polynomial_bounded
mutShuffleIndexes = mut_shuffle_indexes
mutFlipBit = mut_flip_bit
mutUniformInt = mut_uniform_int
mutESLogNormal = mut_es_log_normal

selRandom = sel_random
selBest = sel_best
selWorst = sel_worst
selTournament = sel_tournament
selTournamentSorted = sel_tournament_sorted
selRoulette = sel_roulette
selDoubleTournament = sel_double_tournament
selStochasticUniversalSampling = sel_stochastic_universal_sampling
selLexicase = sel_lexicase
selEpsilonLexicase = sel_epsilon_lexicase
selAutomaticEpsilonLexicase = sel_automatic_epsilon_lexicase

initRepeat = init_repeat
initIterate = init_iterate
initCycle = init_cycle
