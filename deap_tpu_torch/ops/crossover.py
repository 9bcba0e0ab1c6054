"""Crossovers on batches of pairs.

Port of ``cx_one_point``, ``cx_two_point``, ``cx_blend``,
``cx_simulated_binary_bounded``, ``cx_es_blend`` and ``cx_es_two_point``
from :mod:`deap_tpu.ops.crossover`.
Operators are batched:
``(generator, g1[m, L], g2[m, L]) -> (c1, c2)``. Each carries a
``fused_segment_draw(generator, m, L) -> (lo, hi)`` tag, the draw that
reproduces its cut points as a half-open swap segment, which the fused
variation plane (:mod:`deap_tpu_torch.ops.variation`) consumes.
Blend and bounded SBX are real-valued and have no fused form; they
apply their draws in the draw-taking cores :func:`_blend` (one uniform
per gene) and :func:`_sbx_bounded` (draws from :func:`sbx_bounded_draws`).
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


# ------------------------------------------------------------ blend ----

def _blend(g1, g2, alpha, u):
    """Blend crossover on given uniforms (see :func:`cx_blend`)."""
    gamma = (1.0 + 2.0 * alpha) * u - alpha
    return (1.0 - gamma) * g1 + gamma * g2, gamma * g1 + (1.0 - gamma) * g2


def cx_blend(generator, g1, g2, alpha):
    """BLX-alpha blend: per gene ``γ = (1+2α)·u − α`` in ``[−α, 1+α]``,
    children ``(1−γ)·g1 + γ·g2`` and ``γ·g1 + (1−γ)·g2``."""
    u = torch.rand(g1.shape, generator=generator, device=generator.device)
    return _blend(g1, g2, alpha, u)


# ------------------------------------------------------ bounded SBX ----

def sbx_bounded_draws(generator, shape):
    """The draws of :func:`cx_simulated_binary_bounded` per gene: the
    application coin (probability 0.5), the spread uniform and the swap
    coin (probability 0.5), in that order."""
    dev = generator.device
    coin = torch.rand(shape, generator=generator, device=dev) < 0.5
    rand = torch.rand(shape, generator=generator, device=dev)
    swap = torch.rand(shape, generator=generator, device=dev) < 0.5
    return coin, rand, swap


def _sbx_bounded(g1, g2, eta, low, up, coin, rand, swap):
    """Bounded SBX on given draws (see :func:`cx_simulated_binary_bounded`)."""
    low = torch.as_tensor(low, dtype=g1.dtype, device=g1.device)
    up = torch.as_tensor(up, dtype=g1.dtype, device=g1.device)
    gate = coin & ((g1 - g2).abs() > 1e-14)
    x1 = torch.minimum(g1, g2)
    x2 = torch.maximum(g1, g2)
    diff = torch.where(gate, x2 - x1, 1.0)  # no 0-division on idle genes

    def child(bound_term, sign):
        beta = 1.0 + 2.0 * bound_term / diff
        alpha = 2.0 - beta ** -(eta + 1.0)
        beta_q = torch.where(
            rand <= 1.0 / alpha,
            (rand * alpha) ** (1.0 / (eta + 1.0)),
            (1.0 / (2.0 - rand * alpha)) ** (1.0 / (eta + 1.0)))
        return 0.5 * (x1 + x2 + sign * beta_q * diff)

    c1 = torch.minimum(torch.maximum(child(x1 - low, -1.0), low), up)
    c2 = torch.minimum(torch.maximum(child(up - x2, +1.0), low), up)
    o1 = torch.where(swap, c2, c1)
    o2 = torch.where(swap, c1, c2)
    return torch.where(gate, o1, g1), torch.where(gate, o2, g2)


def cx_simulated_binary_bounded(generator, g1, g2, eta, low, up):
    """Bounded simulated binary crossover (Deb's NSGA-II C code): per
    gene, applied with probability 0.5 where the parents differ, spread
    factor from ``eta``, children clipped to ``[low, up]`` and swapped
    with probability 0.5."""
    return _sbx_bounded(g1, g2, eta, low, up,
                        *sbx_bounded_draws(generator, g1.shape))


# --------------------------------------------------------------- ES ----
#
# An evolution strategy's individual is a value vector and its strategy
# (step size) vector; these take and return both, ``(generator, g1, s1, g2,
# s2) -> ((c1, n1), (c2, n2))``, on batches of pairs.

def cx_es_blend(generator, g1, s1, g2, s2, alpha):
    """ES blend: :func:`cx_blend` of the values, then of the strategies,
    each with its own uniforms."""
    dev = generator.device
    ug = torch.rand(g1.shape, generator=generator, device=dev)
    us = torch.rand(s1.shape, generator=generator, device=dev)
    (c1, c2), (n1, n2) = _blend(g1, g2, alpha, ug), _blend(s1, s2, alpha, us)
    return (c1, n1), (c2, n2)


def cx_es_two_point(generator, g1, s1, g2, s2):
    """ES two-point: one :func:`cx_two_point` segment a pair, swapped in
    the values and the strategies alike."""
    lo, hi = _two_points(generator, g1.shape[0], g1.shape[-1])
    (c1, c2), (n1, n2) = (_segment_swap(lo, hi, g1, g2),
                          _segment_swap(lo, hi, s1, s2))
    return (c1, n1), (c2, n2)
