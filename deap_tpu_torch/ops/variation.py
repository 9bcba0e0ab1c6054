"""Fused variation plane — one-pass select-gather + crossover + mutation.

Port of :mod:`deap_tpu.ops.variation`. The masks are drawn first, with
the generator, in exactly the order the unfused composition
(:func:`deap_tpu_torch.algorithms._var_and_unfused`) consumes them —
segment draws, pair Bernoullis, per-gene mutation draws, row Bernoullis
for ``var_and``; the row uniforms, the parents, the segment draws and the
mutation draws for ``var_or`` — so the fused plane gives the same
children as the unfused one from the same generator state. The apply (:func:`apply_variation`) is then a pure
function of those masks, and the plain version of the CUDA kernel
:func:`deap_tpu_torch.ops.kernels.fused_variation`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

__all__ = ["VariationPlan", "resolve_plan", "var_and_masks",
           "var_or_parents", "var_or_masks", "apply_variation", "pair_partner_positions", "single_genome_leaf"]


class VariationPlan(NamedTuple):
    """The fused plane's static description of a (mate, mutate) pair.

    ``mate_draw(generator, m, L) -> (lo, hi)`` reproduces the crossover
    operator's cut draw for ``m`` pairs; ``mut_draw(generator, n, L,
    dtype) -> (mask, arg)`` reproduces the mutation operator's per-gene
    draws (``arg`` is ``None`` for ``'flip'``, the additive noise for
    ``'add'``, the replacement values for ``'set'``)."""

    mate_draw: Callable
    mate_name: str
    mut_kind: str  # 'flip' | 'add' | 'set'
    mut_draw: Callable
    mut_name: str


def _partial_parts(op) -> Tuple[Callable, tuple, dict]:
    fn = getattr(op, "func", op)
    args = tuple(getattr(op, "args", ()) or ())
    kwargs = dict(getattr(op, "keywords", {}) or {})
    return fn, args, kwargs


def resolve_plan(toolbox) -> Optional[VariationPlan]:
    """A :class:`VariationPlan` for ``toolbox``'s (mate, mutate) pair, or
    ``None`` when either operator lacks fused support. Bound operator
    parameters must be keywords
    (``tb.register("mutate", mut_flip_bit, indpb=0.05)``)."""
    mate = getattr(toolbox, "mate", None)
    mutate = getattr(toolbox, "mutate", None)
    if mate is None or mutate is None:
        return None
    mate_fn, mate_args, mate_kwargs = _partial_parts(mate)
    mut_fn, mut_args, mut_kwargs = _partial_parts(mutate)
    seg_draw = getattr(mate_fn, "fused_segment_draw", None)
    mut_factory = getattr(mut_fn, "fused_plan", None)
    if seg_draw is None or mut_factory is None:
        return None
    if mate_args or mate_kwargs or mut_args:
        return None
    try:
        mut_kind, mut_draw = mut_factory(**mut_kwargs)
    except TypeError:  # missing/unknown bound params: not this config
        return None
    return VariationPlan(
        mate_draw=seg_draw,
        mate_name=getattr(mate_fn, "__name__", "?"),
        mut_kind=mut_kind,
        mut_draw=mut_draw,
        mut_name=getattr(mut_fn, "__name__", "?"),
    )


def single_genome_leaf(genomes) -> Optional[torch.Tensor]:
    """The ``[n, L]`` tensor of a single-leaf genome structure, or
    ``None`` when the structure is not one the fused plane handles."""
    leaves = pytree.tree_leaves(genomes)
    if len(leaves) != 1 or leaves[0].ndim != 2:
        return None
    return leaves[0]


def pair_partner_positions(n: int, device=None) -> torch.Tensor:
    """Row ``i``'s adjacent-pair mate: ``i ^ 1``, clamped so an odd
    trailing row partners itself (it never mates)."""
    pos = torch.arange(n, dtype=torch.int32, device=device)
    return torch.clamp(pos ^ 1, max=n - 1)


def _bernoulli(generator, p: float, n: int) -> torch.Tensor:
    return torch.rand(n, generator=generator, device=generator.device) < p


def _repeat_pairs(a: torch.Tensor, n: int, fill) -> torch.Tensor:
    """Pair values → row values: rows ``2i`` and ``2i+1`` both take
    ``a[i]``; an odd tail row takes ``fill``."""
    out = torch.full((n,), fill, dtype=a.dtype, device=a.device)
    out[: 2 * a.shape[0]] = a.repeat_interleave(2)
    return out


# ------------------------------------------------------------- var_and ----

def var_and_masks(generator: torch.Generator, n: int, L: int, cxpb: float,
                  mutpb: float, plan: VariationPlan, dtype):
    """The draws of :func:`deap_tpu_torch.algorithms.var_and`, expanded
    to row level, in the unfused composition's order.

    Returns ``(cx_row [n], lo int32[n], hi int32[n], do_mut [n],
    mask [n, L], arg [n, L] | None)``."""
    npairs = n // 2
    dev = generator.device
    if npairs:
        lo_p, hi_p = plan.mate_draw(generator, npairs, L)
        do_cx = _bernoulli(generator, cxpb, npairs)
        cx_row = _repeat_pairs(do_cx, n, False)
        lo = _repeat_pairs(lo_p.to(torch.int32), n, 0)
        hi = _repeat_pairs(hi_p.to(torch.int32), n, 0)
    else:
        cx_row = torch.zeros(n, dtype=torch.bool, device=dev)
        lo = torch.zeros(n, dtype=torch.int32, device=dev)
        hi = torch.zeros(n, dtype=torch.int32, device=dev)
    mask, arg = plan.mut_draw(generator, n, L, dtype)
    do_mut = _bernoulli(generator, mutpb, n)
    return cx_row, lo, hi, do_mut, mask, arg


# -------------------------------------------------------------- var_or ----

def var_or_parents(generator: torch.Generator, n: int, lambda_: int,
                   cxpb: float, mutpb: float):
    """The row draws of :func:`deap_tpu_torch.algorithms.var_or`, in its
    order: a uniform ``u`` per child, then the first parent ``i`` in
    ``[0, n)``, the second ``j`` drawn in ``[0, n-1)`` and shifted past
    ``i`` (two distinct parents, the reference's ``random.sample``), and
    the mutant's parent ``m``.

    A child mates where ``u < cxpb`` and mutates where ``cxpb <= u <
    cxpb + mutpb``, else it is a copy of ``m``. Mating needs two rows, so
    ``n < 2`` with ``cxpb > 0`` raises (the JAX package would read row
    ``n``). Returns ``(choice_cx, choice_mut, i, j, m)``, the indices
    ``int32[λ]``."""
    if n < 1:
        raise ValueError("var_or needs a non-empty population")
    if n < 2 and cxpb > 0:
        raise ValueError(f"var_or mates two distinct parents: a population "
                         f"of {n} cannot mate (cxpb={cxpb})")
    dev = generator.device
    u = torch.rand(lambda_, generator=generator, device=dev)
    choice_cx = u < cxpb
    choice_mut = (u >= cxpb) & (u < cxpb + mutpb)

    def randint(high):
        return torch.randint(0, high, (lambda_,), generator=generator,
                             device=dev, dtype=torch.int32)

    i = randint(n)
    j = randint(max(n - 1, 1))
    # at n == 1 the shift reads past the last row; nothing mates there
    j = torch.where(j >= i, j + 1, j).clamp_(max=n - 1)
    m = randint(n)
    return choice_cx, choice_mut, i, j, m


def var_or_masks(generator: torch.Generator, n: int, lambda_: int, L: int,
                 cxpb: float, mutpb: float, plan: VariationPlan, dtype):
    """The draws of :func:`deap_tpu_torch.algorithms.var_or` in the
    unfused composition's order: :func:`var_or_parents`, then the
    crossover operator's segment draw and the mutation operator's draws,
    each for all λ children (chosen or not).

    Returns ``(base_idx, partner_idx, choice_cx, lo, hi, choice_mut, mask,
    arg)``: ``base_idx = where(choice_cx, i, m)`` and ``partner_idx = j``
    (``int32[λ]``) compose the parent gathers into the apply; ``lo``,
    ``hi`` are ``int32[λ]``."""
    choice_cx, choice_mut, i, j, m = var_or_parents(generator, n, lambda_,
                                                    cxpb, mutpb)
    lo, hi = plan.mate_draw(generator, lambda_, L)
    mask, arg = plan.mut_draw(generator, lambda_, L, dtype)
    return (torch.where(choice_cx, i, m), j, choice_cx, lo.to(torch.int32),
            hi.to(torch.int32), choice_mut, mask, arg)


# --------------------------------------------------------------- apply ----

def _pair_swapped(rows: torch.Tensor) -> torch.Tensor:
    """Rows with each adjacent pair's members exchanged (an odd tail row
    maps to itself) — the var_and partner view, by reshape instead of a
    second gather."""
    n = rows.shape[0]
    npairs = n // 2
    if npairs == 0:
        return rows
    head = rows[: 2 * npairs].reshape(npairs, 2, -1).flip(1)
    head = head.reshape(2 * npairs, rows.shape[-1])
    return torch.cat([head, rows[2 * npairs:]], dim=0)


def apply_variation(genomes: torch.Tensor,
                    src_idx: Optional[torch.Tensor],
                    partner_idx: Optional[torch.Tensor],
                    cx_row: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor, mut_row: torch.Tensor,
                    mut_mask: torch.Tensor,
                    mut_arg: Optional[torch.Tensor], mut_kind: str,
                    ) -> torch.Tensor:
    """``out[r] = mut(cx(genomes[src_idx[r]], genomes[partner_idx[r]]))``:
    crossover swaps columns ``[lo[r], hi[r])`` where ``cx_row[r]``,
    mutation rewrites ``mut_mask[r]`` genes where ``mut_row[r]``.
    ``src_idx=None`` means rows are already in place; ``partner_idx=None``
    means adjacent-pair partners."""
    self_rows = genomes if src_idx is None else genomes[src_idx.long()]
    partner_rows = (_pair_swapped(self_rows) if partner_idx is None
                    else genomes[partner_idx.long()])
    col = torch.arange(genomes.shape[-1], dtype=torch.int32,
                       device=genomes.device)[None, :]
    seg = cx_row[:, None] & (col >= lo[:, None]) & (col < hi[:, None])
    child = torch.where(seg, partner_rows, self_rows)
    if mut_kind == "flip":
        mval = (~child.to(torch.bool)).to(child.dtype)
    elif mut_kind == "add":
        mval = child + mut_arg
    elif mut_kind == "set":
        mval = mut_arg
    else:
        raise ValueError(f"unknown mut_kind {mut_kind!r}")
    m = mut_row[:, None] & mut_mask
    return torch.where(m, mval, child)
