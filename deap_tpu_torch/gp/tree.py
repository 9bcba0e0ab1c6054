"""Tensor prefix trees — generation and variation as index arithmetic.

Port of :mod:`deap_tpu.gp.tree`, batched over trees. A population of
trees is a dict of tensors ``{"nodes": int32[n, max_len], "consts":
f32[n, max_len], "length": int32[n]}``; slots past ``length`` are
padding. "Would exceed max_len" returns the parent unchanged, as in the
JAX package.

Each random operator is split into a draw and a **draw-taking core**:
the generator's core takes per-tree heights and grow flags and per-slot
terminal tests, terminal choices, ERC values and op choices; crossover's
its cut points (or, leaf-biased, its leaf flags and point scores);
mutation's its point and donor trees, or the scores and choices of node
replacement, ephemeral resampling, insertion and shrinking. A uniform
pick among the eligible slots of a tree is the argmax of uniform scores
over them (:func:`masked_argmax`), as in the JAX package. The tests hand
the cores the JAX package's own draws; the operators draw with a
``torch.Generator`` and call the same cores.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from deap_tpu_torch.gp.pset import PrimitiveSet

Genome = Dict[str, torch.Tensor]

_NEG = -(2 ** 30)


def _f32(p: float) -> float:
    """A probability as the float32 the JAX package compares against."""
    return torch.tensor(p, dtype=torch.float32).item()


def randint_below(generator: torch.Generator,
                  high: torch.Tensor) -> torch.Tensor:
    """Uniform ints in ``[0, high)`` per element (``high >= 1``), int64."""
    bits = torch.randint(0, 2 ** 62, high.shape, generator=generator,
                         device=generator.device)
    return bits % high.to(torch.int64)


def masked_argmax(mask: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """A uniform pick among the ``mask``ed entries of the last axis: the
    first argmax of ``scores`` there, ``-1`` elsewhere (entry 0 when
    nothing is masked in), the JAX package's ``argmax(where(mask, scores,
    -1.0))``. ``int64``."""
    return torch.where(mask, scores, -1.0).argmax(-1)


# ------------------------------------------------------------- generation ----

def generator_scan_len(pset: PrimitiveSet, max_len: int,
                       max_depth: int) -> int:
    """Slots a depth-bounded generator fills at most: the full a-ary tree
    of ``max_depth``, capped at ``max_len``."""
    a = max(int(pset.max_arity), 1)
    depth_cap = (max_depth + 1 if a == 1
                 else (a ** (max_depth + 1) - 1) // (a - 1))
    return min(max_len, depth_cap)


def generate(pset: PrimitiveSet, max_len: int, min_depth: int,
             height: torch.Tensor, grow: torch.Tensor,
             u_term: torch.Tensor, term_choice: torch.Tensor,
             erc: torch.Tensor, op_choice: torch.Tensor) -> Genome:
    """The generator's draw-taking core: grow ``n`` trees slot by slot
    with a LIFO stack of pending depths, as the JAX package's
    ``make_generator`` scan does for one tree.

    :param height: ``int[n]`` height budget per tree.
    :param grow: ``bool[n]`` grow mode (else full) per tree.
    :param u_term: ``f32[n, S]`` grow-mode terminal tests per slot.
    :param term_choice: ``int[n, S]`` terminal draw per slot, in
        ``[0, n_terminal_choices)``.
    :param erc: ``f32[n, S]`` ERC value per slot (used where the terminal
        draw picks the ERC).
    :param op_choice: ``int[n, S]`` operator draw per slot.
    """
    n, S = u_term.shape
    dev = u_term.device
    arity = pset.arity_table(dev)
    t_ratio = _f32(pset.terminal_ratio)
    nodes = torch.full((n, max_len), pset.const_id, dtype=torch.int32,
                       device=dev)
    consts = torch.zeros((n, max_len), dtype=torch.float32, device=dev)
    stack = torch.zeros((n, max_len + 1), dtype=torch.int64, device=dev)
    sp = torch.ones(n, dtype=torch.int64, device=dev)
    length = torch.zeros(n, dtype=torch.int32, device=dev)
    height = height.to(device=dev, dtype=torch.int64)
    idx = torch.arange(max_len + 1, device=dev)
    for t in range(S):
        pending = sp > 0
        d = stack.gather(1, (sp - 1).clamp_min(0)[:, None])[:, 0]
        sp_pop = sp - 1
        # space guard: after this node the pending subtrees must each
        # still fit one slot
        room = max_len - t - sp_pop - 1
        force_term = (d >= height) | (room < 1)
        grow_term = grow & (d >= min_depth) & (u_term[:, t] < t_ratio)
        term_node, term_val = pset.terminal_of_choice(
            term_choice[:, t].to(torch.int64), erc[:, t])
        op_node = op_choice[:, t].to(torch.int64)
        op_ar = arity[op_node]
        # an operator whose arity overflows the space guard -> terminal
        is_term = force_term | grow_term | (op_ar > room)
        node = torch.where(is_term, term_node, op_node.to(torch.int32))
        val = torch.where(is_term, term_val, 0.0)
        nodes[:, t] = torch.where(pending, node, nodes[:, t])
        consts[:, t] = torch.where(pending, val, consts[:, t])
        # push the children (depth d+1); LIFO order makes the walk prefix
        ar = torch.where(is_term, 0, op_ar)
        push = (idx >= sp_pop[:, None]) & (idx < (sp_pop + ar)[:, None])
        stack = torch.where(push, (d + 1)[:, None], stack)
        sp = torch.where(pending, sp_pop + ar, sp)
        length = length + pending.to(torch.int32)
    return {"nodes": nodes, "consts": consts, "length": length}


def make_generator(pset: PrimitiveSet, max_len: int, min_depth: int,
                   max_depth: int, mode: str = "half_and_half") -> Callable:
    """Build ``gen(generator, n) -> genomes`` (genFull, genGrow,
    genHalfAndHalf). A node is a terminal when its depth reaches the
    tree's height budget, when the array is nearly full, or — in grow
    mode — with probability ``terminal_ratio`` once past ``min_depth``.

    ``gen.draw(generator, n)`` returns the draws as a dict and
    ``gen.from_draws(draws)`` applies :func:`generate` to them.
    """
    if mode not in ("full", "grow", "half_and_half"):
        raise ValueError(mode)
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
        term_choice = torch.randint(0, pset.n_terminal_choices, (n, S),
                                    generator=generator, device=dev)
        erc = (pset.erc_sampler(generator, (n, S)) if pset.has_erc
               else torch.zeros((n, S), device=dev))
        op_choice = (torch.randint(0, pset.n_ops, (n, S),
                                   generator=generator, device=dev)
                     if pset.n_ops else torch.zeros((n, S), dtype=torch.int64,
                                                    device=dev))
        return {"height": height, "grow": grow, "u_term": u_term,
                "term_choice": term_choice, "erc": erc,
                "op_choice": op_choice}

    def from_draws(draws: dict) -> Genome:
        return generate(pset, max_len, min_depth, **draws)

    def gen(generator: torch.Generator, n: int) -> Genome:
        return from_draws(draw(generator, n))

    gen.draw = draw
    gen.from_draws = from_draws
    gen.scan_len = S
    return gen


def gen_full(pset, max_len, min_, max_):
    return make_generator(pset, max_len, min_, max_, "full")


def gen_grow(pset, max_len, min_, max_):
    return make_generator(pset, max_len, min_, max_, "grow")


def gen_half_and_half(pset, max_len, min_, max_):
    return make_generator(pset, max_len, min_, max_, "half_and_half")


# -------------------------------------------------------- tree arithmetic ----

def subtree_end(nodes: torch.Tensor, arity: torch.Tensor,
                begin: torch.Tensor) -> torch.Tensor:
    """Exclusive end of the subtree rooted at ``begin[i]`` of each tree
    ``nodes[i]``: the first ``j >= begin`` where ``1 + Σ(arity−1)`` over
    ``[begin, j]`` hits zero. ``int64[n]``."""
    L = nodes.shape[-1]
    begin = begin.to(torch.int64)
    cs = (arity[nodes.to(torch.int64)] - 1).cumsum(-1)
    prev = torch.where(begin > 0, cs.gather(
        -1, (begin - 1).clamp_min(0)[..., None])[..., 0], 0)
    total = 1 + cs - prev[..., None]
    closed = (total == 0) & (torch.arange(L, device=nodes.device)
                             >= begin[..., None])
    return closed.to(torch.uint8).argmax(-1) + 1


def subtree_ends_all(nodes: torch.Tensor, length: torch.Tensor,
                     arity: torch.Tensor) -> torch.Tensor:
    """Exclusive subtree end of EVERY slot of every tree, ``int64[n, L]``:
    ``end_i`` is the first ``j >= i`` with ``cs[j] <= cs[i-1] - 1``, a
    next-smaller-element query answered by a binary search over a sparse
    range-min table of the arity cumsum (O(L log L) per tree). Slots at
    or past ``length`` hold garbage."""
    n, L = nodes.shape
    dev = nodes.device
    live = torch.arange(L, device=dev) < length[:, None]
    deficit = torch.where(live, arity[nodes.to(torch.int64)] - 1, 0)
    cs = deficit.cumsum(1)
    prev = torch.cat([torch.zeros((n, 1), dtype=cs.dtype, device=dev),
                      cs[:, :-1]], 1)
    # levels[k][p] = min cs over [p, p+2^k), windows truncated at L
    # behaving as _NEG (so the search can never skip past the end)
    levels = [cs]
    k = 1
    while k < L:
        m = levels[-1]
        shifted = torch.cat([m[:, k:], torch.full((n, k), _NEG,
                                                  dtype=cs.dtype,
                                                  device=dev)], 1)
        levels.append(torch.minimum(m, shifted))
        k *= 2
    target = prev - 1
    pos = torch.arange(L, device=dev).expand(n, L)
    for lev in reversed(range(len(levels))):
        block_min = torch.where(
            pos < L, levels[lev].gather(1, pos.clamp_max(L - 1)), _NEG)
        pos = torch.where(block_min > target, pos + (1 << lev), pos)
    return pos.clamp_max(L - 1) + 1


def prefix_depths(nodes: torch.Tensor, length: torch.Tensor,
                  arity: torch.Tensor) -> torch.Tensor:
    """Depth of every slot (root 0; garbage past ``length``), ``int32[n,
    L]``: ``depth[j] = j − #{live i : end_i ≤ j}``."""
    n, L = nodes.shape
    dev = nodes.device
    ends = subtree_ends_all(nodes, length, arity)
    live = torch.arange(L, device=dev) < length[:, None]
    hist = torch.zeros((n, L + 1), dtype=torch.int64, device=dev)
    hist.scatter_add_(1, torch.where(live, ends, L).clamp(0, L),
                      live.to(torch.int64))
    closed_by = hist.cumsum(1)[:, :-1]
    return (torch.arange(L, device=dev) - closed_by).to(torch.int32)


def tree_height(genomes: Genome, pset: PrimitiveSet) -> torch.Tensor:
    """Tree height (root at 0) of every tree, ``int32[n]``."""
    nodes, length = genomes["nodes"], genomes["length"]
    depths = prefix_depths(nodes, length, pset.arity_table(nodes.device))
    live = torch.arange(nodes.shape[1], device=nodes.device) < length[:, None]
    return torch.where(live, depths, 0).amax(1).to(torch.int32)


def _splice(g: Genome, begin, end, donor_nodes, donor_consts, donor_begin,
            donor_len) -> Genome:
    """Replace ``g[i][begin:end]`` with ``donor[i][donor_begin:+donor_len]``
    in every tree ``i``: a gather over output slots; a tree whose result
    would exceed its width keeps the parent."""
    n, L = g["nodes"].shape
    dev = g["nodes"].device
    begin, end = begin.to(torch.int64), end.to(torch.int64)
    donor_begin = donor_begin.to(torch.int64)
    donor_len = donor_len.to(torch.int64)
    seg = end - begin
    new_len = g["length"] - seg + donor_len
    k = torch.arange(L, device=dev)
    in_head = k < begin[:, None]
    in_donor = (k >= begin[:, None]) & (k < (begin + donor_len)[:, None])
    src_tail = (k - donor_len[:, None] + seg[:, None]).clamp(0, L - 1)
    # slots outside the donor segment are masked, so the clamp to the
    # donor's width changes nothing that is kept
    src_donor = (donor_begin[:, None] + k - begin[:, None]).clamp(
        0, min(L, donor_nodes.shape[1]) - 1)

    def mix(own, donor):
        return torch.where(in_head, own, torch.where(
            in_donor, donor.gather(1, src_donor), own.gather(1, src_tail)))

    ok = new_len <= L
    return {"nodes": torch.where(ok[:, None], mix(g["nodes"], donor_nodes),
                                 g["nodes"]),
            "consts": torch.where(ok[:, None],
                                  mix(g["consts"], donor_consts),
                                  g["consts"]),
            "length": torch.where(ok, new_len, g["length"]).to(torch.int32)}


def tree_where(mask: torch.Tensor, a: Genome, b: Genome) -> Genome:
    """Row-wise select between two populations of trees."""
    return {k: torch.where(mask.reshape(mask.shape + (1,) * (a[k].ndim - 1)),
                           a[k], b[k]) for k in a}


# -------------------------------------------------------------- crossover ----

def draw_cut_points(generator: torch.Generator,
                    length: torch.Tensor) -> torch.Tensor:
    """One-point crossover's cut point per tree: uniform in ``[1, len)``,
    0 for trees shorter than 2 nodes."""
    len64 = length.to(torch.int64)
    i = 1 + randint_below(generator, (len64 - 1).clamp_min(1))
    return torch.where(len64 >= 2, i, 0)


def cx_one_point_core(arity: torch.Tensor, g1: Genome, g2: Genome,
                      i1: torch.Tensor, i2: torch.Tensor
                      ) -> Tuple[Genome, Genome]:
    """Swap the subtrees rooted at ``i1`` and ``i2``; pairs where a tree
    is shorter than 2 nodes pass through unchanged."""
    ok = (g1["length"] >= 2) & (g2["length"] >= 2)
    e1 = subtree_end(g1["nodes"], arity, i1)
    e2 = subtree_end(g2["nodes"], arity, i2)
    c1 = _splice(g1, i1, e1, g2["nodes"], g2["consts"], i2, e2 - i2)
    c2 = _splice(g2, i2, e2, g1["nodes"], g1["consts"], i1, e1 - i1)
    return tree_where(ok, c1, g1), tree_where(ok, c2, g2)


def make_cx_one_point(pset: PrimitiveSet) -> Callable:
    """One-point subtree crossover, ``cx(generator, g1, g2) -> (c1, c2)``,
    roots excluded (gp.py:645-682)."""

    def cx(generator: torch.Generator, g1: Genome, g2: Genome):
        i1 = draw_cut_points(generator, g1["length"])
        i2 = draw_cut_points(generator, g2["length"])
        return cx_one_point_core(pset.arity_table(g1["nodes"].device),
                                 g1, g2, i1, i2)

    return cx


def leaf_biased_points(arity: torch.Tensor, g: Genome,
                       want_leaf: torch.Tensor,
                       scores: torch.Tensor) -> torch.Tensor:
    """Each tree's crossover point below the root: a terminal where
    ``want_leaf``, else an operator, uniform by ``scores [n, L]``; any
    non-root node when the tree has none of that class."""
    nodes, length = g["nodes"], g["length"]
    k = torch.arange(nodes.shape[1], device=nodes.device)
    in_tree = (k >= 1) & (k < length[:, None])
    is_leaf = arity[nodes.to(torch.int64)] == 0
    mask = in_tree & torch.where(want_leaf[:, None], is_leaf, ~is_leaf)
    mask = torch.where(mask.any(1, keepdim=True), mask, in_tree)
    return masked_argmax(mask, scores)


def cx_leaf_biased_core(arity: torch.Tensor, g1: Genome, g2: Genome,
                        leaf1: torch.Tensor, leaf2: torch.Tensor,
                        s1: torch.Tensor, s2: torch.Tensor
                        ) -> Tuple[Genome, Genome]:
    """Leaf-biased crossover on its draws: per tree the leaf flag
    (``u < termpb``) and the point scores ``[n, L]``."""
    i1 = leaf_biased_points(arity, g1, leaf1, s1)
    i2 = leaf_biased_points(arity, g2, leaf2, s2)
    return cx_one_point_core(arity, g1, g2, i1, i2)


def make_cx_one_point_leaf_biased(pset: PrimitiveSet,
                                  termpb: float = 0.1) -> Callable:
    """Leaf-biased crossover (cxOnePointLeafBiased): each tree picks a
    terminal point with probability ``termpb``, else an operator (Koza's
    90/10 rule), each tree with its own draw."""
    p = _f32(termpb)

    def cx(generator: torch.Generator, g1: Genome, g2: Genome):
        n, dev = g1["length"].shape[0], generator.device
        leaf1 = torch.rand(n, generator=generator, device=dev) < p
        leaf2 = torch.rand(n, generator=generator, device=dev) < p
        s1 = torch.rand(g1["nodes"].shape, generator=generator, device=dev)
        s2 = torch.rand(g2["nodes"].shape, generator=generator, device=dev)
        return cx_leaf_biased_core(pset.arity_table(g1["nodes"].device),
                                   g1, g2, leaf1, leaf2, s1, s2)

    return cx


# -------------------------------------------------------------- mutation ----

def mut_uniform_core(arity: torch.Tensor, g: Genome, i: torch.Tensor,
                     donor: Genome) -> Genome:
    """Replace the subtree rooted at ``i`` of each tree with the donor
    tree of its row."""
    e = subtree_end(g["nodes"], arity, i)
    return _splice(g, i, e, donor["nodes"], donor["consts"],
                   torch.zeros_like(e), donor["length"])


def make_mut_uniform(pset: PrimitiveSet, expr: Callable) -> Callable:
    """Replace a random subtree with a fresh expression from
    ``expr(generator, n)`` (mutUniform; symbreg uses genFull(0, 2))."""

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        length = g["length"].to(torch.int64)
        i = randint_below(generator, length.clamp_min(1))
        donor = expr(generator, length.shape[0])
        return mut_uniform_core(pset.arity_table(g["nodes"].device), g, i,
                                donor)

    return mut


def _at(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[t, i[t]]`` for every row ``t``."""
    return a.gather(1, i.to(torch.int64)[:, None])[:, 0]


def set_node(g: Genome, i: torch.Tensor, node: torch.Tensor,
             value: torch.Tensor) -> Genome:
    """Each tree with slot ``i`` set to ``node`` and its constant to
    ``value``."""
    i = i.to(torch.int64)[:, None]
    return {"nodes": g["nodes"].scatter(1, i, node.to(torch.int32)[:, None]),
            "consts": g["consts"].scatter(1, i, value[:, None]),
            "length": g["length"]}


def draw_terminals(pset: PrimitiveSet, generator: torch.Generator, shape):
    """Untyped terminal draws of ``shape``: ``(choice, erc)`` for
    :meth:`PrimitiveSet.terminal_of_choice`."""
    dev = generator.device
    choice = torch.randint(0, pset.n_terminal_choices, shape,
                           generator=generator, device=dev)
    erc = (pset.erc_sampler(generator, shape) if pset.has_erc
           else torch.zeros(shape, device=dev))
    return choice, erc


def mut_node_replacement_core(pset: PrimitiveSet, g: Genome,
                              i: torch.Tensor, term_choice: torch.Tensor,
                              erc: torch.Tensor,
                              op_scores: torch.Tensor) -> Genome:
    """Node replacement on its draws: the point ``i``, a terminal draw
    (``term_choice``, ``erc``) and operator scores ``[n, n_ops]``; a
    terminal becomes the drawn terminal, an operator the best-scored
    operator of its arity."""
    dev = g["nodes"].device
    arity = pset.arity_table(dev)
    node = _at(g["nodes"], i).to(torch.int64)
    ar = arity[node]
    def build():
        pools = torch.zeros((pset.max_arity + 1, max(pset.n_ops, 1)),
                            dtype=torch.bool)
        for j, prim in enumerate(pset.primitives):
            pools[prim.arity, j] = True
        return pools

    op_node = masked_argmax(pset.table("arity_pools", dev, build)[ar],
                            op_scores)
    term_node, term_val = pset.terminal_of_choice(term_choice.to(torch.int64),
                                                  erc)
    is_term = ar == 0
    return set_node(g, i, torch.where(is_term, term_node, op_node),
                    torch.where(is_term, term_val, _at(g["consts"], i)))


def make_mut_node_replacement(pset: PrimitiveSet) -> Callable:
    """Swap one node for another of the same arity (mutNodeReplacement):
    terminals get a fresh terminal draw, operators an operator of equal
    arity."""

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        n, dev = g["length"].shape[0], generator.device
        i = randint_below(generator, g["length"].to(torch.int64).clamp_min(1))
        choice, erc = draw_terminals(pset, generator, (n,))
        op_scores = torch.rand((n, max(pset.n_ops, 1)), generator=generator,
                               device=dev)
        return mut_node_replacement_core(pset, g, i, choice, erc, op_scores)

    return mut


def mut_ephemeral_core(g: Genome, is_erc: torch.Tensor, mode: str,
                       pick_scores: torch.Tensor,
                       values: torch.Tensor) -> Genome:
    """Ephemeral resampling on its draws: ``values [n, L]`` replace the
    constants of the live slots where ``is_erc`` (``mode='all'``), or of
    the one such slot best by ``pick_scores`` (``'one'``)."""
    k = torch.arange(g["nodes"].shape[1], device=g["nodes"].device)
    is_erc = is_erc & (k < g["length"][:, None])
    if mode == "one":
        chosen = masked_argmax(is_erc, pick_scores)
        is_erc = is_erc & (k == chosen[:, None])
    return {"nodes": g["nodes"],
            "consts": torch.where(is_erc, values, g["consts"]),
            "length": g["length"]}


def make_mut_ephemeral(pset: PrimitiveSet, mode: str = "one") -> Callable:
    """Resample ephemeral constants (mutEphemeral): ``mode='one'``
    redraws a single random ERC node of each tree, ``'all'`` every one."""
    if not pset.has_erc:
        raise ValueError("primitive set has no ephemeral constant")
    if mode not in ("one", "all"):
        raise ValueError(mode)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        shape, dev = g["nodes"].shape, generator.device
        pick = torch.rand(shape, generator=generator, device=dev)
        values = pset.erc_sampler(generator, shape).to(torch.float32)
        return mut_ephemeral_core(g, g["nodes"] == pset.erc_id, mode, pick,
                                  values)

    return mut


def insert_core(arity: torch.Tensor, g: Genome, i: torch.Tensor,
                op: torch.Tensor, pos: torch.Tensor, t_nodes: torch.Tensor,
                t_vals: torch.Tensor, post_offset: int) -> Genome:
    """Insertion on its draws: operator ``op`` goes above the subtree at
    ``i``, which becomes its argument ``pos``; its other arguments are the
    terminals ``t_nodes``/``t_vals [n, max_ar]``. Argument slot ``pos + 1
    + m`` after the subtree takes terminal ``pos + m + 1 - post_offset``,
    as the JAX package's untyped (``post_offset`` 1) and typed (0)
    operators index them."""
    nodes, consts = g["nodes"], g["consts"]
    n, L = nodes.shape
    max_ar = t_nodes.shape[1]
    dev = nodes.device
    i = i.to(torch.int64)
    e = subtree_end(nodes, arity, i)
    seg = (e - i)[:, None]
    op = op.to(torch.int64)
    ar = arity[op][:, None]
    pos = pos.to(torch.int64)[:, None]
    k = torch.arange(1 + max_ar + L, device=dev)
    in_pre = (k >= 1) & (k < 1 + pos)
    in_sub = (k >= 1 + pos) & (k < 1 + pos + seg)
    in_post = (k >= 1 + pos + seg) & (k < seg + ar)
    pre = (k - 1).clamp(0, max_ar - 1).expand(n, -1)
    sub = (i[:, None] + k - 1 - pos).clamp(0, L - 1)
    post = (k - post_offset - seg).clamp(0, max_ar - 1)

    def donor(own, terms, first):
        out = torch.where(in_pre, terms.gather(1, pre), torch.where(
            in_sub, own.gather(1, sub), torch.where(
                in_post, terms.gather(1, post), 0)))
        out[:, 0] = first
        return out

    donor_nodes = donor(nodes, t_nodes.to(nodes.dtype), op.to(nodes.dtype))
    donor_consts = donor(consts, t_vals.to(consts.dtype), 0.0)
    return _splice(g, i, e, donor_nodes, donor_consts, torch.zeros_like(i),
                   (seg + ar)[:, 0])


def make_mut_insert(pset: PrimitiveSet) -> Callable:
    """Insert a new operator above a random subtree (mutInsert): the old
    subtree becomes one randomly chosen argument of the new node; the
    other arguments are fresh terminals."""
    max_ar = max(pset.max_arity, 1)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        n, dev = g["length"].shape[0], generator.device
        arity = pset.arity_table(g["nodes"].device)
        i = randint_below(generator, g["length"].to(torch.int64).clamp_min(1))
        op = torch.randint(0, pset.n_ops, (n,), generator=generator,
                           device=dev)
        pos = randint_below(generator, arity[op].clamp_min(1))
        t_nodes, t_vals = pset.terminal_of_choice(
            *draw_terminals(pset, generator, (n, max_ar)))
        return insert_core(arity, g, i, op, pos, t_nodes, t_vals, 1)

    return mut


def shrink_core(arity: torch.Tensor, max_ar: int, g: Genome,
                node_ok: torch.Tensor, scores: torch.Tensor,
                child: torch.Tensor) -> Genome:
    """Shrinking on its draws: the operator slot best by ``scores`` among
    ``node_ok`` collapses onto its argument ``child``; trees with no such
    slot, or shorter than 3 nodes, pass through."""
    nodes = g["nodes"]
    has = node_ok.any(1) & (g["length"] >= 3)
    i = masked_argmax(node_ok, scores)
    child = child.to(torch.int64)
    c_begin = i + 1
    for j in range(max_ar):
        c_begin = torch.where(j < child, subtree_end(nodes, arity, c_begin),
                              c_begin)
    c_end = subtree_end(nodes, arity, c_begin)
    e = subtree_end(nodes, arity, i)
    out = _splice(g, i, e, nodes, g["consts"], c_begin, c_end - c_begin)
    return tree_where(has, out, g)


def shrinkable_slots(arity: torch.Tensor, g: Genome) -> torch.Tensor:
    """Operator slots below the root, ``bool[n, L]``."""
    k = torch.arange(g["nodes"].shape[1], device=g["nodes"].device)
    in_tree = (k >= 1) & (k < g["length"][:, None])
    return (arity[g["nodes"].to(torch.int64)] > 0) & in_tree


def make_mut_shrink(pset: PrimitiveSet) -> Callable:
    """Collapse a random operator node below the root onto one of its
    argument subtrees (mutShrink); trees with no operator below the root,
    or shorter than 3 nodes, pass through unchanged."""
    max_ar = max(pset.max_arity, 1)

    def mut(generator: torch.Generator, g: Genome) -> Genome:
        arity = pset.arity_table(g["nodes"].device)
        node_ok = shrinkable_slots(arity, g)
        scores = torch.rand(node_ok.shape, generator=generator,
                            device=generator.device)
        ar = arity[_at(g["nodes"], masked_argmax(node_ok, scores)).to(
            torch.int64)]
        child = randint_below(generator, ar.clamp_min(1))
        return shrink_core(arity, max_ar, g, node_ok, scores, child)

    return mut


# ------------------------------------------------------------ bloat control ----

def static_limit(measure: Callable, max_value: int) -> Callable:
    """Decorator keeping the parent where an offspring exceeds the limit
    (staticLimit; Koza's height-17 rule). ``measure`` maps trees to an
    ``[n]`` tensor (e.g. ``lambda g: tree_height(g, pset)``)."""

    def decorator(op):
        def wrapped(generator, *genomes):
            out = op(generator, *genomes)
            outs = out if isinstance(out, tuple) else (out,)
            kept = tuple(tree_where(measure(child) > max_value, parent, child)
                         for child, parent in zip(outs, genomes))
            return kept if isinstance(out, tuple) else kept[0]

        return wrapped

    return decorator
