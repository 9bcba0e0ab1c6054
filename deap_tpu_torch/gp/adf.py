"""Automatically Defined Functions: multi-branch tree programs.

Port of :mod:`deap_tpu.gp.adf`. An individual is a tuple of genomes, one
a branch, MAIN first; a population is a tuple of branch populations
(dicts of ``[n, L]`` tensors). An ADF call node in branch *i*
(:meth:`~deap_tpu_torch.gp.pset.PrimitiveSet.add_adf`) evaluates branch
*j > i* of the same individual on the operand rows at the call site: a
nested scan-mode pass (:func:`deap_tpu_torch.gp.interpreter.
run_data_pass`) whose points are that individual's operand rows.

As in the JAX package, every primitive of a branch's live vocabulary is
evaluated at every slot and the node id selects the row, except the ADF
calls: a call runs the callee's pass only for the trees that make it
there. The passes are bounded to each branch's population-wide live
prefix.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from deap_tpu_torch.gp.interpreter import _used_ops, run_data_pass
from deap_tpu_torch.gp.pset import PrimitiveSet
from deap_tpu_torch.gp.tree import make_generator
from deap_tpu_torch.telemetry.journal import broadcast

Branches = Sequence[Tuple[PrimitiveSet, int]]   # [(pset, max_len), ...]


def _build_branch(pset: PrimitiveSet, max_len: int, branch_idx: int,
                  interps: dict, max_actives=None, masks=None) -> Callable:
    """``interp(genomes, X)`` for one branch; ADF nodes call into
    ``interps`` (built already for every later branch). ``max_actives[i]``
    bounds branch *i*'s passes to its live prefix; ``masks[i]`` restricts
    its select chain to those opcode ids. A call is evaluated only for
    the trees whose node at the slot is that call (the other trees never
    select its row, and each tree's values depend on its own rows only),
    and not at all where no tree makes it."""
    ids = (range(pset.n_ops) if masks is None or masks[branch_idx] is None
           else masks[branch_idx])
    prims = [(i, pset.primitives[i]) for i in ids]
    ma = None if max_actives is None else max_actives[branch_idx]

    def interpret(genomes, X):
        def prim_rows(ops_in, node):
            rows = []
            for i, p in prims:
                if p.adf is None:
                    rows.append((i, p.fn(*ops_in[:p.arity])))
                    continue
                callers = (node == i).nonzero()[:, 0]
                if callers.numel() == 0:
                    continue
                sub = tuple({k: v[callers] for k, v in g.items()}
                            for g in genomes)
                # each caller's operand rows are its own points [m, P, ar]
                sub_X = torch.stack([a[callers] for a in ops_in[:p.arity]],
                                    -1)
                row = ops_in[0].new_zeros(ops_in[0].shape)
                row[callers] = interps[p.adf](sub, sub_X)
                rows.append((i, row))
            return rows

        return run_data_pass(pset, max_len, genomes[branch_idx], X,
                             prim_rows, max_active=ma)

    return interpret


def _validate_branches(branches: Branches) -> None:
    for i, (pset, _) in enumerate(branches):
        for p in pset.primitives:
            if p.adf is None:
                continue
            if p.adf <= i:
                raise ValueError(
                    f"branch {i} calls branch {p.adf}; ADF calls must "
                    "target later branches (no recursion, matching the "
                    "reference's progressive compile order)")
            if p.adf >= len(branches):
                raise ValueError(
                    f"branch {i} calls branch {p.adf}, but only "
                    f"{len(branches)} branches were given")
            callee = branches[p.adf][0]
            if p.arity != callee.n_args:
                raise ValueError(
                    f"ADF call {p.name!r} passes {p.arity} operands but "
                    f"branch {p.adf} ({callee.name!r}) takes "
                    f"{callee.n_args} arguments")


def _spans(branches: Branches, genomes) -> tuple:
    """Each branch's pass length: its population's longest live prefix
    (at least 1, at most the branch's width)."""
    out = []
    for g, (_, ml) in zip(genomes, branches):
        cap = min(g["nodes"].shape[1], ml)
        top = int(g["length"].amax()) if g["length"].numel() else 1
        out.append(min(max(top, 1), cap))
    return tuple(out)


def _link_branches(branches: Branches, max_actives=None,
                   masks=None) -> Callable:
    interps: dict = {}
    for i in reversed(range(len(branches))):
        pset, max_len = branches[i]
        interps[i] = _build_branch(pset, max_len, i, interps, max_actives,
                                   masks)
    return interps[0]


def make_adf_interpreter(branches: Branches) -> Callable:
    """``evaluate(genomes, X) -> f32[points]`` for one multi-branch
    individual (a tuple of one-tree genomes: ``nodes [L]``, ``consts
    [L]``, ``length``); ``X`` is ``f32[points, n_args]`` of MAIN.
    ``branches[0]`` is MAIN; branch *i* may call branch *j* only for
    ``j > i``."""
    _validate_branches(branches)

    def evaluate(genomes, X):
        batch = []
        for g in genomes:
            one = {k: torch.as_tensor(v).reshape(1, -1)
                   for k, v in g.items()}
            one["length"] = one["length"].reshape(1)
            batch.append(one)
        main = _link_branches(branches, _spans(branches, batch))
        return main(tuple(batch), X.to(torch.float32))[0]

    return evaluate


def make_adf_batch_interpreter(branches: Branches,
                               specialize: str = "auto") -> Callable:
    """``interpret(genomes, X) -> f32[n, points]`` over a population of
    multi-branch individuals (a tuple of branch populations). Every
    branch's passes are bounded to its population's longest live prefix.

    ``specialize='auto'`` restricts each branch's select chain to the
    opcodes its population uses (ADF calls included, so a call no live
    tree makes skips the whole callee), a monotone union over calls, read
    from the host; ``'none'`` keeps every branch's whole vocabulary.
    Both give bitwise the same values. ``'auto'`` journals a
    ``gp_dispatch`` event (``mode='adf'``, each branch's live opcode
    names) to the open journals whenever the masks grow, as the JAX
    package does."""
    _validate_branches(branches)
    if specialize not in ("auto", "none"):
        raise ValueError(f"unknown specialize policy {specialize!r}")
    state = {"masks": tuple(() for _ in branches), "seen": set()}

    def interpret(genomes, X):
        X = X.to(torch.float32)
        masks = None
        if specialize == "auto":
            masks = []
            for prev, g, (ps, ml) in zip(state["masks"], genomes, branches):
                used = _used_ops(ps.n_ops, g["nodes"][:, :ml].cpu().numpy(),
                                 g["length"].cpu().numpy())
                masks.append(tuple(sorted(set(prev) | set(used))))
            state["masks"] = masks = tuple(masks)
            if masks not in state["seen"]:
                state["seen"].add(masks)
                broadcast("gp_dispatch", mode="adf", mask=[
                    [branches[i][0].primitives[j].name for j in m]
                    for i, m in enumerate(masks)])
        return _link_branches(branches, _spans(branches, genomes),
                              masks)(genomes, X)

    return interpret


def make_adf_generator(branches: Branches, min_depth: int, max_depth: int,
                       mode: str = "half_and_half") -> Callable:
    """``gen(generator, n) -> tuple of genomes``, every branch generated
    with its own vocabulary and width. ``gen.draw(generator, n)`` returns
    each branch's draws and ``gen.from_draws(draws)`` applies each
    branch's generator core to them."""
    gens = [make_generator(pset, max_len, min_depth, max_depth, mode)
            for pset, max_len in branches]

    def draw(generator: torch.Generator, n: int):
        return tuple(g.draw(generator, n) for g in gens)

    def from_draws(draws):
        return tuple(g.from_draws(d) for g, d in zip(gens, draws))

    def gen(generator: torch.Generator, n: int):
        return from_draws(draw(generator, n))

    gen.draw = draw
    gen.from_draws = from_draws
    return gen


def branch_wise_cx(cx_ops: List[Callable]) -> Callable:
    """Apply a crossover per branch pair (the reference's ``for tree1,
    tree2 in zip(ind1, ind2): toolbox.mate(tree1, tree2)``)."""

    def cx(generator: torch.Generator, g1, g2):
        outs = [op(generator, a, b) for op, a, b in zip(cx_ops, g1, g2)]
        return tuple(o[0] for o in outs), tuple(o[1] for o in outs)

    return cx


def branch_wise_mut(mut_ops: List[Callable]) -> Callable:
    """Apply a mutation per branch."""

    def mut(generator: torch.Generator, g):
        return tuple(op(generator, b) for op, b in zip(mut_ops, g))

    return mut
