"""Genetic programming over tensor prefix trees.

Port of :mod:`deap_tpu.gp`: primitive sets (untyped and strongly typed,
ADF calls), batched tree generation and variation (every tree operator,
typed ones and the semantic ones), the batch interpreter (scan, sweep
and the grouped evaluator, whose kernel is K9 on the card), ADF
interpreters, HARM-GP, the host-dispatch GP loop and the artificial ant
(its rollout J2 on the card). ``__all__`` holds every name of the JAX
package's, plus the port's own extras.
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
from deap_tpu_torch.gp.string import from_string, to_graph, to_string
from deap_tpu_torch.gp.tree import (
    Genome,
    gen_full,
    gen_grow,
    gen_half_and_half,
    make_cx_one_point,
    make_cx_one_point_leaf_biased,
    make_generator,
    make_mut_ephemeral,
    make_mut_insert,
    make_mut_node_replacement,
    make_mut_shrink,
    make_mut_uniform,
    prefix_depths,
    static_limit,
    subtree_end,
    subtree_ends_all,
    tree_height,
)
from deap_tpu_torch.gp.typed import (
    PrimitiveSetTyped,
    make_cx_one_point_typed,
    make_generator_typed,
    make_mut_ephemeral_typed,
    make_mut_insert_typed,
    make_mut_node_replacement_typed,
    make_mut_shrink_typed,
    make_mut_uniform_typed,
    spam_set,
)
from deap_tpu_torch.gp.adf import (
    branch_wise_cx,
    branch_wise_mut,
    make_adf_batch_interpreter,
    make_adf_generator,
    make_adf_interpreter,
)
from deap_tpu_torch.gp.semantic import (
    add_semantic_primitives,
    logistic,
    make_cx_semantic,
    make_mut_semantic,
)
from deap_tpu_torch.gp.harm import harm
from deap_tpu_torch.gp import ant, loop

__all__ = [
    "PrimitiveSetTyped",
    "make_generator_typed",
    "make_cx_one_point_typed",
    "make_mut_uniform_typed",
    "make_mut_node_replacement_typed",
    "make_mut_ephemeral_typed",
    "make_mut_insert_typed",
    "make_mut_shrink_typed",
    "spam_set",
    "make_adf_batch_interpreter",
    "make_adf_interpreter",
    "make_adf_generator",
    "branch_wise_cx",
    "branch_wise_mut",
    "add_semantic_primitives",
    "logistic",
    "make_mut_semantic",
    "make_cx_semantic",
    "harm",
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
    "make_cx_one_point_leaf_biased",
    "make_mut_uniform",
    "make_mut_node_replacement",
    "make_mut_ephemeral",
    "make_mut_insert",
    "make_mut_shrink",
    "static_limit",
    "subtree_end",
    "tree_height",
    "to_string",
    "to_graph",
    "from_string",
    # the port's own
    "DEVICE_OPS",
    "prefix_depths",
    "subtree_ends_all",
]

# DEAP-style aliases
genFull = gen_full
genGrow = gen_grow
genHalfAndHalf = gen_half_and_half
staticLimit = static_limit
