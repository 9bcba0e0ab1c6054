"""Segment crossovers on batches of pairs.

Port of ``cx_one_point`` / ``cx_two_point`` from
:mod:`deap_tpu.ops.crossover`. Operators are batched:
``(generator, g1[m, L], g2[m, L]) -> (c1, c2)``. Each carries a
``fused_segment_draw(generator, m, L) -> (lo, hi)`` tag, the draw that
reproduces its cut points as a half-open swap segment, which the fused
variation plane (:mod:`deap_tpu_torch.ops.variation`) consumes.
"""

from __future__ import annotations

import torch


def _randint(generator, low: int, high: int, m: int) -> torch.Tensor:
    # jax.random.randint clamps an empty range [low, low) to ``low``
    return torch.randint(low, max(high, low + 1), (m,), generator=generator,
                         device=generator.device, dtype=torch.int32)


def _segment_swap(lo, hi, g1, g2):
    col = torch.arange(g1.shape[-1], device=g1.device)
    mask = (col >= lo[:, None]) & (col < hi[:, None])
    return torch.where(mask, g2, g1), torch.where(mask, g1, g2)


def _one_point_segment(generator, m: int, size: int):
    """``cx_one_point``'s cut ``point ~ U{1..L-1}`` as the segment
    ``[point, L)``."""
    point = _randint(generator, 1, size, m)
    return point, torch.full_like(point, size)


def cx_one_point(generator, g1, g2):
    """One-point crossover: swap the tails after a point in [1, L-1]."""
    lo, hi = _one_point_segment(generator, g1.shape[0], g1.shape[-1])
    return _segment_swap(lo, hi, g1, g2)


cx_one_point.fused_segment_draw = _one_point_segment


def _two_points(generator, m: int, size: int):
    """The two-point draw: ``p1 ~ U{1..L}``, ``p2 ~ U{1..L-1}`` bumped
    past ``p1``; the segment is ``[min, max)``."""
    p1 = _randint(generator, 1, size + 1, m)
    p2 = _randint(generator, 1, size, m)
    p2 = torch.where(p2 >= p1, p2 + 1, p2)
    return torch.minimum(p1, p2), torch.maximum(p1, p2)


def cx_two_point(generator, g1, g2):
    """Two-point crossover: swap the middle segment."""
    lo, hi = _two_points(generator, g1.shape[0], g1.shape[-1])
    return _segment_swap(lo, hi, g1, g2)


cx_two_point.fused_segment_draw = _two_points
