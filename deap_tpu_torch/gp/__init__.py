"""Genetic programming over tensor prefix trees.

Port of :mod:`deap_tpu.gp`: primitive sets, batched tree generation and
variation, the batch interpreter (scan, sweep and the grouped evaluator,
whose kernel is K9 on the card) and the host-dispatch GP loop. Not
ported yet (ROADMAP A9): strongly typed sets, ADFs, the semantic and
HARM operators, the artificial ant, and the other tree operators
(leaf-biased crossover, node replacement, ephemeral, insert, shrink).
"""

from deap_tpu_torch.gp.interpreter import (
    make_batch_interpreter,
    make_interpreter,
    make_population_evaluator,
)
from deap_tpu_torch.gp.loop import make_gp_loop, make_symbreg_loop
from deap_tpu_torch.gp.pset import (
    DEVICE_OPS,
    PrimitiveSet,
    bool_set,
    math_set,
    protected_div,
)
from deap_tpu_torch.gp.string import from_string, to_string
from deap_tpu_torch.gp.tree import (
    Genome,
    gen_full,
    gen_grow,
    gen_half_and_half,
    make_cx_one_point,
    make_generator,
    make_mut_uniform,
    prefix_depths,
    static_limit,
    subtree_end,
    subtree_ends_all,
    tree_height,
)

__all__ = [
    "DEVICE_OPS",
    "Genome",
    "PrimitiveSet",
    "bool_set",
    "math_set",
    "protected_div",
    "make_batch_interpreter",
    "make_interpreter",
    "make_population_evaluator",
    "make_gp_loop",
    "make_symbreg_loop",
    "make_generator",
    "gen_full",
    "gen_grow",
    "gen_half_and_half",
    "make_cx_one_point",
    "make_mut_uniform",
    "prefix_depths",
    "static_limit",
    "subtree_end",
    "subtree_ends_all",
    "tree_height",
    "to_string",
    "from_string",
]

# DEAP-style aliases
genFull = gen_full
genGrow = gen_grow
genHalfAndHalf = gen_half_and_half
staticLimit = static_limit
