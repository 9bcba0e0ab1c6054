"""Strongly typed GP: type constraints as static tables and masked draws.

Port of :mod:`deap_tpu.gp.typed`, batched over trees. Types are interned
to dense int ids; the set compiles to three tables — ``arity_table``
(inherited), :meth:`PrimitiveSetTyped.ret_type_table` (``int64[vocab]``)
and :meth:`PrimitiveSetTyped.arg_type_table` (``int64[n_ops, max_ar]``)
— and every draw among the eligible ids of a type is the argmax of
uniform scores over them (:func:`deap_tpu_torch.gp.tree.masked_argmax`).

The data still flows through one float32 row a slot (booleans are
0.0/1.0), so typed trees go through the untyped interpreters unchanged,
the grouped kernel K9 included: types constrain structure only.

As in :mod:`deap_tpu_torch.gp.tree`, each random operator has a
draw-taking core: a typed terminal draw is a row of scores over the
terminal choices plus one value of each ERC pool, an operator draw a row
of scores over the operators. The tests hand the cores the JAX package's
own draws.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from deap_tpu_torch.gp.pset import PrimitiveSet
from deap_tpu_torch.gp.tree import (Genome, _at, _f32, _splice,
                                    generator_scan_len, insert_core,
                                    masked_argmax, mut_ephemeral_core,
                                    mut_uniform_core, randint_below,
                                    set_node, shrink_core, shrinkable_slots,
                                    subtree_end, tree_where)
from deap_tpu_torch.ops.kernels import gp_eq, gp_lt


class PrimitiveSetTyped(PrimitiveSet):
    """A primitive set whose nodes carry return and argument types.

    :param in_types: type names of the tree's input arguments.
    :param ret_type: type name the whole tree returns.

    A typed set may hold one ERC pool a type: the pools' node ids follow
    the fixed terminals, ``erc_id + j`` for pool ``j``.
    """

    def __init__(self, name: str, in_types: Sequence[str], ret_type: str,
                 prefix: str = "ARG"):
        super().__init__(name, len(in_types), prefix)
        self._types: dict = {}
        self.ret = self.type_id(ret_type)
        self.in_type_ids = [self.type_id(t) for t in in_types]
        self.prim_rets: list = []
        self.prim_args: list = []
        self.const_types: list = []
        self.erc_entries: list = []     # (name, sampler, type_id)

    # ------------------------------------------------------------- builder ----

    def type_id(self, name: str) -> int:
        if name not in self._types:
            self._types[name] = len(self._types)
        return self._types[name]

    @property
    def n_types(self) -> int:
        return len(self._types)

    def add_primitive(self, fn: Callable, in_types: Sequence[str],
                      ret_type: str, name: Optional[str] = None,
                      fmt: Optional[str] = None,
                      device_op: Optional[str] = None) -> None:
        """Register a typed operator; ``device_op`` as in
        :meth:`PrimitiveSet.add_primitive`."""
        if len(in_types) < 1:
            raise ValueError("arity should be >= 1")
        super().add_primitive(fn, len(in_types), name, fmt, device_op)
        self.prim_rets.append(self.type_id(ret_type))
        self.prim_args.append([self.type_id(t) for t in in_types])

    def add_terminal(self, value: float, ret_type: str,
                     name: Optional[str] = None) -> None:
        """Register a typed constant terminal."""
        super().add_terminal(value, name)
        self.const_types.append(self.type_id(ret_type))

    def add_ephemeral_constant(self, name: str, sampler: Callable,
                               ret_type: str) -> None:
        """Register a typed ERC pool, ``sampler(generator, shape) -> f32``;
        unlike the untyped set, one pool a type."""
        self.erc_entries.append((name, sampler, self.type_id(ret_type)))

    def add_adf(self, name: str, in_types: Sequence[str], ret_type: str,
                branch: Optional[int] = None) -> None:
        """Typed ADF call: the call node carries the callee's argument
        and return types."""
        if branch is None:
            raise TypeError(
                "PrimitiveSetTyped.add_adf(name, in_types, ret_type, "
                "branch) — the branch index is required")
        super().add_adf(name, len(in_types), branch)
        self.prim_rets.append(self.type_id(ret_type))
        self.prim_args.append([self.type_id(t) for t in in_types])

    # -------------------------------------------------------------- layout ----

    @property
    def has_erc(self) -> bool:
        return bool(self.erc_entries)

    @property
    def n_ercs(self) -> int:
        return len(self.erc_entries)

    @property
    def vocab(self) -> int:
        return self.n_ops + self.n_args + self.n_consts + self.n_ercs

    @property
    def n_terminal_choices(self) -> int:
        return self.n_args + self.n_consts + self.n_ercs

    def node_name(self, node_id: int, const: float = 0.0) -> str:
        if node_id >= self.erc_id:
            return repr(round(float(const), 6))
        return super().node_name(node_id, const)

    # -------------------------------------------------------- static tables ----

    def _layout(self) -> tuple:
        return super()._layout() + (
            tuple(self.prim_rets), tuple(map(tuple, self.prim_args)),
            tuple(self.in_type_ids), tuple(self.const_types),
            tuple(t for (_, _, t) in self.erc_entries))

    def ret_type_table(self, device="cpu") -> torch.Tensor:
        """``int64[vocab]``: the return type of every node id."""
        rets = (list(self.prim_rets) + list(self.in_type_ids)
                + list(self.const_types)
                + [t for (_, _, t) in self.erc_entries])
        return self.table("ret", device, lambda: torch.tensor(
            rets, dtype=torch.int64))

    def arg_type_table(self, device="cpu") -> torch.Tensor:
        """``int64[max(n_ops, 1), max_ar]``: the argument types of every
        operator (0 past its arity)."""
        m = max(self.max_arity, 1)
        rows = [args + [0] * (m - len(args)) for args in self.prim_args]
        return self.table("args", device, lambda: torch.tensor(
            rows or [[0] * m], dtype=torch.int64))

    def term_masks(self, device="cpu") -> torch.Tensor:
        """``bool[n_types, n_terminal_choices]``: the terminals of each
        type."""
        def build():
            mask = torch.zeros((max(self.n_types, 1),
                                max(self.n_terminal_choices, 1)),
                               dtype=torch.bool)
            types = (list(self.in_type_ids) + list(self.const_types)
                     + [t for (_, _, t) in self.erc_entries])
            for j, t in enumerate(types):
                mask[t, j] = True
            return mask

        return self.table("term_masks", device, build)

    def op_masks(self, device="cpu") -> torch.Tensor:
        """``bool[n_types, max(n_ops, 1)]``: the operators returning each
        type."""
        def build():
            mask = torch.zeros((max(self.n_types, 1), max(self.n_ops, 1)),
                               dtype=torch.bool)
            for j, t in enumerate(self.prim_rets):
                mask[t, j] = True
            return mask

        return self.table("op_masks", device, build)

    def validate(self) -> None:
        """Every type demanded anywhere (root, operator argument) must
        have a terminal, or generation could not close a branch of it."""
        term = self.term_masks().any(1)
        demanded = {self.ret}
        for args in self.prim_args:
            demanded.update(args)
        names = {v: k for k, v in self._types.items()}
        for t in demanded:
            if not bool(term[t]):
                raise ValueError(
                    f"type {names.get(t, t)!r} has no terminal; generation "
                    "would be unable to close a branch of this type")

    # --------------------------------------------------------- typed draws ----

    def terminal_of_scores(self, type_: torch.Tensor, scores: torch.Tensor,
                           erc: torch.Tensor):
        """A terminal of type ``type_`` (any shape ``S``) from its draws:
        ``scores f32[S + (n_terminal_choices,)]`` and one value a pool,
        ``erc f32[S + (n_ercs,)]`` → ``(node int32[S], value f32[S])``."""
        dev = scores.device
        choice = masked_argmax(self.term_masks(dev)[type_], scores)
        vals = torch.zeros(scores.shape, dtype=torch.float32, device=dev)
        if self.n_consts:
            vals[..., self.n_args:self.n_args + self.n_consts] = self.table(
                "consts", dev, lambda: torch.tensor(self.const_values,
                                                    dtype=torch.float32))
        if self.n_ercs:
            vals[..., self.n_args + self.n_consts:] = erc.to(torch.float32)
        value = vals.gather(-1, choice[..., None])[..., 0]
        return (self.n_ops + choice).to(torch.int32), value

    def op_of_scores(self, type_: torch.Tensor, scores: torch.Tensor,
                     room: Optional[torch.Tensor] = None):
        """An operator returning ``type_`` (and of arity at most ``room``)
        from its scores ``f32[S + (max(n_ops, 1),)]`` → ``(op int64[S],
        found bool[S])``."""
        dev = scores.device
        mask = self.op_masks(dev)[type_]
        if room is not None:
            n_o = max(self.n_ops, 1)
            mask = mask & (self.arity_table(dev)[:n_o]
                           <= room[..., None])
        return masked_argmax(mask, scores), mask.any(-1)

    def draw_terminals(self, generator: torch.Generator, shape):
        """Typed terminal draws of ``shape``: ``(scores, erc)`` for
        :meth:`terminal_of_scores`."""
        dev = generator.device
        scores = torch.rand(tuple(shape) + (max(self.n_terminal_choices, 1),),
                            generator=generator, device=dev)
        erc = torch.stack([sampler(generator, tuple(shape)).to(torch.float32)
                           for (_, sampler, _) in self.erc_entries], -1) \
            if self.n_ercs else torch.zeros(tuple(shape) + (0,), device=dev)
        return scores, erc


# ---------------------------------------------------------------- generator ----

def generate_typed(pset: PrimitiveSetTyped, max_len: int, min_depth: int,
                   height: torch.Tensor, grow: torch.Tensor,
                   root_type, u_term: torch.Tensor,
                   term_scores: torch.Tensor, erc: torch.Tensor,
                   op_scores: torch.Tensor) -> Genome:
    """The typed generator's draw-taking core: grow ``n`` trees slot by
    slot with a LIFO stack of pending (depth, required type), children
    pushed rightmost first so the pops walk the prefix with each slot's
    argument type.

    :param root_type: the type each tree returns, an int or ``int[n]``.
    :param u_term: ``f32[n, S]`` grow-mode terminal tests.
    :param term_scores: ``f32[n, S, n_terminal_choices]`` terminal scores.
    :param erc: ``f32[n, S, n_ercs]`` a value of each ERC pool a slot.
    :param op_scores: ``f32[n, S, max(n_ops, 1)]`` operator scores.
    """
    n, S = u_term.shape
    dev = u_term.device
    arity = pset.arity_table(dev)
    arg_types = pset.arg_type_table(dev)
    max_ar = max(pset.max_arity, 1)
    t_ratio = _f32(pset.terminal_ratio)
    nodes = torch.full((n, max_len), pset.const_id, dtype=torch.int32,
                       device=dev)
    consts = torch.zeros((n, max_len), dtype=torch.float32, device=dev)
    dstack = torch.zeros((n, max_len + 1), dtype=torch.int64, device=dev)
    tstack = torch.zeros((n, max_len + 1), dtype=torch.int64, device=dev)
    tstack[:, 0] = torch.as_tensor(root_type, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    length = torch.zeros(n, dtype=torch.int32, device=dev)
    height = height.to(device=dev, dtype=torch.int64)
    idx = torch.arange(max_len + 1, device=dev)
    for t in range(S):
        pending = sp > 0
        top = (sp - 1).clamp_min(0)[:, None]
        d = dstack.gather(1, top)[:, 0]
        ty = tstack.gather(1, top)[:, 0]
        sp_pop = sp - 1
        room = max_len - t - sp_pop - 1
        force_term = (d >= height) | (room < 1)
        grow_term = grow & (d >= min_depth) & (u_term[:, t] < t_ratio)
        op_node, has_op = pset.op_of_scores(ty, op_scores[:, t], room)
        is_term = force_term | grow_term | ~has_op
        term_node, term_val = pset.terminal_of_scores(ty, term_scores[:, t],
                                                      erc[:, t])
        node = torch.where(is_term, term_node, op_node.to(torch.int32))
        val = torch.where(is_term, term_val, 0.0)
        nodes[:, t] = torch.where(pending, node, nodes[:, t])
        consts[:, t] = torch.where(pending, val, consts[:, t])
        ar = torch.where(is_term, 0, arity[op_node])
        push = (idx >= sp_pop[:, None]) & (idx < (sp_pop + ar)[:, None])
        # slot sp_pop + j receives argument ar - 1 - j: leftmost on top
        child_arg = (ar[:, None] - 1 - (idx - sp_pop[:, None])).clamp(
            0, max_ar - 1)
        child_t = arg_types[op_node].gather(1, child_arg)
        upd = pending[:, None] & push
        dstack = torch.where(upd, (d + 1)[:, None], dstack)
        tstack = torch.where(upd, child_t, tstack)
        sp = torch.where(pending, sp_pop + ar, sp)
        length = length + pending.to(torch.int32)
    return {"nodes": nodes, "consts": consts, "length": length}


def make_generator_typed(pset: PrimitiveSetTyped, max_len: int,
                         min_depth: int, max_depth: int,
                         mode: str = "half_and_half") -> Callable:
    """Typed tree generator, ``gen(generator, n, ret_type=None) ->
    genomes`` (``ret_type``: an int or ``int[n]``, the set's return type
    by default). ``gen.draw(generator, n)`` returns the draws and
    ``gen.from_draws(draws, ret_type=None)`` applies
    :func:`generate_typed` to them."""
    if mode not in ("full", "grow", "half_and_half"):
        raise ValueError(mode)
    pset.validate()
    S = generator_scan_len(pset, max_len, max_depth)

    def draw(generator: torch.Generator, n: int) -> dict:
        dev = generator.device
        height = torch.randint(min_depth, max_depth + 1, (n,),
                               generator=generator, device=dev)
        if mode == "half_and_half":
            grow = torch.rand(n, generator=generator, device=dev) < 0.5
        else:
            grow = torch.full((n,), mode == "grow", device=dev)
        u_term = torch.rand((n, S), generator=generator, device=dev)
        term_scores, erc = pset.draw_terminals(generator, (n, S))
        op_scores = torch.rand((n, S, max(pset.n_ops, 1)),
                               generator=generator, device=dev)
        return {"height": height, "grow": grow, "u_term": u_term,
                "term_scores": term_scores, "erc": erc,
                "op_scores": op_scores}

    def from_draws(draws: dict, ret_type=None) -> Genome:
        root = pset.ret if ret_type is None else ret_type
        return generate_typed(pset, max_len, min_depth, root_type=root,
                              **draws)

    def gen(generator: torch.Generator, n: int, ret_type=None) -> Genome:
        return from_draws(draw(generator, n), ret_type)

    gen.draw = draw
    gen.from_draws = from_draws
    gen.scan_len = S
    return gen


# ---------------------------------------------------------------- crossover ----

def cx_one_point_typed_core(pset: PrimitiveSetTyped, g1: Genome, g2: Genome,
                            s1: torch.Tensor, s2: torch.Tensor
                            ) -> Tuple[Genome, Genome]:
    """Typed one-point crossover on its point scores ``[n, L]``: the
    point of ``g1`` among the non-root nodes whose type ``g2`` also has
    below its root, then the point of ``g2`` among those of that type;
    pairs with no common type pass through."""
    dev = g1["nodes"].device
    arity = pset.arity_table(dev)
    rett = pset.ret_type_table(dev)
    k1 = torch.arange(g1["nodes"].shape[1], device=dev)
    k2 = torch.arange(g2["nodes"].shape[1], device=dev)
    in1 = (k1 >= 1) & (k1 < g1["length"][:, None])
    in2 = (k2 >= 1) & (k2 < g2["length"][:, None])
    t1 = rett[g1["nodes"].to(torch.int64)]
    t2 = rett[g2["nodes"].to(torch.int64)]
    types = torch.arange(max(pset.n_types, 1), device=dev)
    present2 = ((t2[:, :, None] == types) & in2[:, :, None]).any(1)
    elig1 = in1 & present2.gather(1, t1)
    ok = elig1.any(1)
    i1 = masked_argmax(elig1, s1)
    i2 = masked_argmax(in2 & (t2 == _at(t1, i1)[:, None]), s2)
    e1 = subtree_end(g1["nodes"], arity, i1)
    e2 = subtree_end(g2["nodes"], arity, i2)
    c1 = _splice(g1, i1, e1, g2["nodes"], g2["consts"], i2, e2 - i2)
    c2 = _splice(g2, i2, e2, g1["nodes"], g1["consts"], i1, e1 - i1)
    return tree_where(ok, c1, g1), tree_where(ok, c2, g2)


def make_cx_one_point_typed(pset: PrimitiveSetTyped) -> Callable:
    """Type-aware one-point crossover, ``cx(generator, g1, g2) -> (c1,
    c2)``: the swapped subtrees return the same type."""

    def cx(generator: torch.Generator, g1: Genome, g2: Genome):
        dev = generator.device
        s1 = torch.rand(g1["nodes"].shape, generator=generator, device=dev)
        s2 = torch.rand(g2["nodes"].shape, generator=generator, device=dev)
        return cx_one_point_typed_core(pset, g1, g2, s1, s2)

    return cx


# ---------------------------------------------------------------- mutations ----

def make_mut_uniform_typed(pset: PrimitiveSetTyped,
                           expr: Callable) -> Callable:
    """Typed subtree replacement (mutUniform): the fresh expression
    returns the replaced subtree's type. ``expr(generator, n, ret_type)``
    — see :func:`make_generator_typed`. Its core is
    :func:`deap_tpu_torch.gp.tree.mut_uniform_core`."""

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        dev = g["nodes"].device
        i = randint_below(generator, g["length"].to(torch.int64).clamp_min(1))
        ret = pset.ret_type_table(dev)[_at(g["nodes"], i).to(torch.int64)]
        donor = expr(generator, g["length"].shape[0], ret)
        return mut_uniform_core(pset.arity_table(dev), g, i, donor)

    return mut


def _signature_mask(pset: PrimitiveSetTyped, device) -> torch.Tensor:
    """``bool[n_o, n_o]``: operators of the same (return, arguments)
    signature."""
    def build():
        n_o = max(pset.n_ops, 1)
        sig = [(r, tuple(a)) for r, a in zip(pset.prim_rets, pset.prim_args)]
        mask = torch.zeros((n_o, n_o), dtype=torch.bool)
        for a, sa in enumerate(sig):
            for b, sb in enumerate(sig):
                mask[a, b] = sa == sb
        return mask

    return pset.table("signature", device, build)


def mut_node_replacement_typed_core(pset: PrimitiveSetTyped, g: Genome,
                                    i: torch.Tensor,
                                    term_scores: torch.Tensor,
                                    erc: torch.Tensor,
                                    op_scores: torch.Tensor) -> Genome:
    """Typed node replacement on its draws: a terminal becomes a terminal
    of its type (``term_scores [n, n_t]``, ``erc [n, n_ercs]``), an
    operator the best-scored operator of its signature (``op_scores
    [n, n_o]``)."""
    dev = g["nodes"].device
    node = _at(g["nodes"], i).to(torch.int64)
    is_term = pset.arity_table(dev)[node] == 0
    term_node, term_val = pset.terminal_of_scores(
        pset.ret_type_table(dev)[node], term_scores, erc)
    row = _signature_mask(pset, dev)[node.clamp(0, max(pset.n_ops, 1) - 1)]
    op_node = masked_argmax(row, op_scores)
    return set_node(g, i, torch.where(is_term, term_node, op_node),
                    torch.where(is_term, term_val, _at(g["consts"], i)))


def make_mut_node_replacement_typed(pset: PrimitiveSetTyped) -> Callable:
    """Same-signature node replacement (mutNodeReplacement): terminals
    are redrawn among the terminals of their type, operators among the
    operators of the same (return, arguments) signature."""

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        n, dev = g["length"].shape[0], generator.device
        i = randint_below(generator, g["length"].to(torch.int64).clamp_min(1))
        term_scores, erc = pset.draw_terminals(generator, (n,))
        op_scores = torch.rand((n, max(pset.n_ops, 1)), generator=generator,
                               device=dev)
        return mut_node_replacement_typed_core(pset, g, i, term_scores, erc,
                                               op_scores)

    return mut


def ephemeral_values_typed(pset: PrimitiveSetTyped, g: Genome,
                           pool_values: torch.Tensor) -> torch.Tensor:
    """Each slot's fresh value from its own pool: ``pool_values f32[n,
    n_ercs, L]`` (a value a pool a slot) → ``f32[n, L]``, the old
    constant where the slot is no ERC."""
    out = g["consts"]
    for j in range(pset.n_ercs):
        out = torch.where(g["nodes"] == pset.erc_id + j, pool_values[:, j],
                          out)
    return out


def make_mut_ephemeral_typed(pset: PrimitiveSetTyped,
                             mode: str = "one") -> Callable:
    """Typed ERC resampling (mutEphemeral) over every pool; each node
    redraws from its own pool. The core is
    :func:`deap_tpu_torch.gp.tree.mut_ephemeral_core` on
    :func:`ephemeral_values_typed`."""
    if not pset.has_erc:
        raise ValueError("primitive set has no ephemeral constant")
    if mode not in ("one", "all"):
        raise ValueError(mode)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        shape, dev = g["nodes"].shape, generator.device
        pick = torch.rand(shape, generator=generator, device=dev)
        pools = torch.stack([sampler(generator, shape).to(torch.float32)
                             for (_, sampler, _) in pset.erc_entries], 1)
        return mut_ephemeral_core(g, g["nodes"] >= pset.erc_id, mode, pick,
                                  ephemeral_values_typed(pset, g, pools))

    return mut


def _accepts(pset: PrimitiveSetTyped, device) -> torch.Tensor:
    """``bool[n_o, n_types]``: operator ``j`` has an argument of type
    ``t``."""
    def build():
        acc = torch.zeros((max(pset.n_ops, 1), max(pset.n_types, 1)),
                          dtype=torch.bool)
        for j, args in enumerate(pset.prim_args):
            for t in args:
                acc[j, t] = True
        return acc

    return pset.table("accepts", device, build)


def mut_insert_typed_core(pset: PrimitiveSetTyped, g: Genome,
                          i: torch.Tensor, op_scores: torch.Tensor,
                          slot_scores: torch.Tensor,
                          term_scores: torch.Tensor,
                          erc: torch.Tensor) -> Genome:
    """Typed insertion on its draws: the operator (``op_scores [n,
    n_o]``) among those returning the subtree's type and taking it as an
    argument, the argument slot of that type (``slot_scores [n,
    max_ar]``), and a terminal of each argument's type (``term_scores
    [n, max_ar, n_t]``, ``erc [n, max_ar, n_ercs]``); no such operator
    leaves the tree unchanged."""
    dev = g["nodes"].device
    arity = pset.arity_table(dev)
    arg_types = pset.arg_type_table(dev)
    max_ar = max(pset.max_arity, 1)
    t = pset.ret_type_table(dev)[_at(g["nodes"], i).to(torch.int64)]
    op_ret = pset.table("op_ret", dev, lambda: torch.tensor(
        pset.prim_rets or [0], dtype=torch.int64))
    mask = (op_ret == t[:, None]) & _accepts(pset, dev)[:, t].T
    found = mask.any(1)
    op = masked_argmax(mask, op_scores)
    op_args = arg_types[op]
    slot_ok = (op_args == t[:, None]) & (
        torch.arange(max_ar, device=dev) < arity[op][:, None])
    pos = masked_argmax(slot_ok, slot_scores)
    t_nodes, t_vals = pset.terminal_of_scores(op_args, term_scores, erc)
    out = insert_core(arity, g, i, op, pos, t_nodes, t_vals, 0)
    return tree_where(found, out, g)


def make_mut_insert_typed(pset: PrimitiveSetTyped) -> Callable:
    """Typed insertion (mutInsert): the new operator returns the chosen
    subtree's type and takes it as an argument; its other arguments are
    fresh terminals of their declared types. No eligible operator leaves
    the tree unchanged."""
    max_ar = max(pset.max_arity, 1)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        n, dev = g["length"].shape[0], generator.device
        i = randint_below(generator, g["length"].to(torch.int64).clamp_min(1))
        op_scores = torch.rand((n, max(pset.n_ops, 1)), generator=generator,
                               device=dev)
        slot_scores = torch.rand((n, max_ar), generator=generator,
                                 device=dev)
        term_scores, erc = pset.draw_terminals(generator, (n, max_ar))
        return mut_insert_typed_core(pset, g, i, op_scores, slot_scores,
                                     term_scores, erc)

    return mut


def shrink_typed_slots(pset: PrimitiveSetTyped, g: Genome) -> torch.Tensor:
    """Operator slots below the root whose operator returns a type it
    also takes, ``bool[n, L]``."""
    dev = g["nodes"].device
    n_o = max(pset.n_ops, 1)
    shrinkable = pset.table("shrinkable", dev, lambda: torch.tensor(
        [r in args for r, args in zip(pset.prim_rets, pset.prim_args)]
        or [False], dtype=torch.bool))
    return shrinkable_slots(pset.arity_table(dev), g) & shrinkable[
        g["nodes"].to(torch.int64).clamp(0, n_o - 1)]


def mut_shrink_typed_core(pset: PrimitiveSetTyped, g: Genome,
                          scores: torch.Tensor,
                          child_scores: torch.Tensor) -> Genome:
    """Typed shrinking on its draws: the operator slot by ``scores [n,
    L]``, then its argument of the operator's own return type by
    ``child_scores [n, max_ar]``."""
    dev = g["nodes"].device
    arity = pset.arity_table(dev)
    max_ar = max(pset.max_arity, 1)
    node_ok = shrink_typed_slots(pset, g)
    op = _at(g["nodes"], masked_argmax(node_ok, scores)).to(torch.int64)
    t = pset.ret_type_table(dev)[op]
    ok_child = (pset.arg_type_table(dev)[op.clamp(0, max(pset.n_ops, 1) - 1)]
                == t[:, None]) & (torch.arange(max_ar, device=dev)
                                  < arity[op][:, None])
    child = masked_argmax(ok_child, child_scores)
    return shrink_core(arity, max_ar, g, node_ok, scores, child)


def make_mut_shrink_typed(pset: PrimitiveSetTyped) -> Callable:
    """Typed shrinking (mutShrink): collapse an operator onto one of its
    argument subtrees of the same return type."""
    max_ar = max(pset.max_arity, 1)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        dev = generator.device
        scores = torch.rand(g["nodes"].shape, generator=generator, device=dev)
        child_scores = torch.rand((g["nodes"].shape[0], max_ar),
                                  generator=generator, device=dev)
        return mut_shrink_typed_core(pset, g, scores, child_scores)

    return mut


# ------------------------------------------------------------ stock vocab ----

def _uniform_0_100(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=generator,
                      device=generator.device) * 100.0


def spam_set(n_features: int = 2) -> PrimitiveSetTyped:
    """A bool/float typed vocabulary in the mold of the spambase example:
    float comparisons feed boolean logic feeding an if-then-else over
    floats. Every primitive has a device op, so K9 evaluates it: ``and``,
    ``or``, ``not`` as :func:`~deap_tpu_torch.gp.pset.bool_set`'s, ``lt``
    and ``eq`` (:func:`~deap_tpu_torch.ops.kernels.gp_lt`,
    :func:`~deap_tpu_torch.ops.kernels.gp_eq`), ``add``, ``sub``, ``mul``
    and ``if_then_else``."""
    ps = PrimitiveSetTyped("SPAM", ["float"] * n_features, "bool")
    ps.add_primitive(lambda a, b: a * b, ["bool", "bool"], "bool", "and_",
                     "({0} & {1})", "and")
    ps.add_primitive(lambda a, b: (a + b).clamp(max=1.0), ["bool", "bool"],
                     "bool", "or_", "({0} | {1})", "or")
    ps.add_primitive(lambda a: 1.0 - a, ["bool"], "bool", "not_", "(~{0})",
                     "not")
    ps.add_primitive(gp_lt, ["float", "float"], "bool", "lt", "({0} < {1})",
                     "lt")
    ps.add_primitive(gp_eq, ["float", "float"], "bool", "eq",
                     "({0} == {1})", "eq")
    ps.add_primitive(torch.add, ["float", "float"], "float", "add",
                     "({0} + {1})", "add")
    ps.add_primitive(torch.sub, ["float", "float"], "float", "sub",
                     "({0} - {1})", "sub")
    ps.add_primitive(torch.mul, ["float", "float"], "float", "mul",
                     "({0} * {1})", "mul")
    ps.add_primitive(lambda c, a, b: torch.where(c > 0.5, a, b),
                     ["bool", "float", "float"], "float", "if_then_else",
                     device_op="if_then_else")
    ps.add_terminal(0.0, "bool", "False")
    ps.add_terminal(1.0, "bool", "True")
    ps.add_ephemeral_constant("rand100", _uniform_0_100, "float")
    return ps
