"""Tensor prefix trees — generation and variation as index arithmetic.

Port of :mod:`deap_tpu.gp.tree`, batched over trees. A population of
trees is a dict of tensors ``{"nodes": int32[n, max_len], "consts":
f32[n, max_len], "length": int32[n]}``; slots past ``length`` are
padding. "Would exceed max_len" returns the parent unchanged, as in the
JAX package.

Each random operator is split into a draw and a **draw-taking core**:
the generator's core takes per-tree heights and grow flags and per-slot
terminal tests, terminal choices, ERC values and op choices; crossover's
its cut points; mutation's its point and donor trees. The tests hand the
cores the JAX package's own draws; the operators draw with a
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
