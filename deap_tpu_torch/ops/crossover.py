"""Crossovers on batches of pairs.

Port of :mod:`deap_tpu.ops.crossover`: ``cx_one_point``,
``cx_two_point``, ``cx_uniform``, the permutation crossovers
(``cx_partialy_matched``, ``cx_uniform_partialy_matched``,
``cx_ordered``), ``cx_blend``, ``cx_simulated_binary`` and its bounded
form, ``cx_messy_one_point``, ``cx_es_blend`` and ``cx_es_two_point``.
``pair_vmap`` has no counterpart: the port's operators are batched and
draw from one generator.
Operators are batched:
``(generator, g1[m, L], g2[m, L]) -> (c1, c2)``. Each carries a
``fused_segment_draw(generator, m, L) -> (lo, hi)`` tag, the draw that
reproduces its cut points as a half-open swap segment, which the fused
variation plane (:mod:`deap_tpu_torch.ops.variation`) consumes.
Every other operator has no fused form and applies its draws in a
draw-taking core (``_blend``, ``_sbx``, ``_sbx_bounded``, ``_uniform``,
``_pmx``, ``_ordered``, ``_messy_one_point``), so a test can hand it the
JAX package's draws; the permutation crossovers walk the genes in order,
as the JAX ``fori_loop``s do, a column at a time for the whole batch.
"""

from __future__ import annotations

import torch

from deap_tpu_torch.ops.linalg import div_rn


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


def _uniform(g1, g2, mask):
    """Uniform crossover on a given swap mask (see :func:`cx_uniform`)."""
    return torch.where(mask, g2, g1), torch.where(mask, g1, g2)


def cx_uniform(generator, g1, g2, indpb):
    """Uniform crossover: each gene swaps with probability ``indpb``."""
    mask = torch.rand(g1.shape, generator=generator,
                      device=generator.device) < indpb
    return _uniform(g1, g2, mask)


# ------------------------------------------------------ permutations ----

def _positions(perm: torch.Tensor) -> torch.Tensor:
    """``pos[r, v]`` = the index of value ``v`` in row ``r`` of ``perm``."""
    pos = torch.zeros_like(perm)
    pos.scatter_(1, perm, torch.arange(perm.shape[1], dtype=perm.dtype,
                                       device=perm.device).expand_as(perm))
    return pos


def _pmx(g1, g2, active):
    """The PMX swaps on given slots: for each slot ``i`` in order where
    ``active[:, i]``, swap the values ``g1[i]``, ``g2[i]`` between the
    slots of each child, keeping the value → slot maps (the JAX
    ``fori_loop``'s body, a column at a time for every pair)."""
    a = g1.to(torch.int64).clone()
    b = g2.to(torch.int64).clone()
    p1, p2 = _positions(a), _positions(b)
    rows = torch.arange(a.shape[0], device=a.device)
    for i in range(a.shape[1]):
        on = active[:, i]
        t1, t2 = a[:, i].clone(), b[:, i].clone()
        j1, j2 = p1[rows, t2], p2[rows, t1]
        # each write in the JAX body's order (a later write to the same
        # slot wins), each kept only where the slot is active
        for arr, idx, val in ((a, torch.full_like(t1, i), t2), (a, j1, t1),
                              (b, torch.full_like(t1, i), t1), (b, j2, t2),
                              (p1, t1, j1), (p1, t2, torch.full_like(t1, i)),
                              (p2, t2, j2), (p2, t1, torch.full_like(t1, i))):
            arr[rows, idx] = torch.where(on, val, arr[rows, idx])
    return a.to(g1.dtype), b.to(g2.dtype)


def pmx_points(generator, m: int, size: int):
    """``cx_partialy_matched``'s draw: ``c1 ~ U{0..L}``, ``c2 ~ U{0..L-1}``
    bumped past ``c1``; the segment is ``[min, max)``."""
    c1 = _randint(generator, 0, size + 1, m)
    c2 = _randint(generator, 0, size, m)
    c2 = torch.where(c2 >= c1, c2 + 1, c2)
    return torch.minimum(c1, c2), torch.maximum(c1, c2)


def _segment_slots(lo, hi, size: int, inclusive: bool = False):
    col = torch.arange(size, device=lo.device)
    upper = (col <= hi[:, None]) if inclusive else (col < hi[:, None])
    return (col >= lo[:, None]) & upper


def cx_partialy_matched(generator, g1, g2):
    """Partially matched crossover (PMX, Goldberg and Lingle 1985) of
    permutations of ``0..L-1``: inside a random segment, each slot's pair
    of values is swapped within both children."""
    lo, hi = pmx_points(generator, g1.shape[0], g1.shape[-1])
    return _pmx(g1, g2, _segment_slots(lo, hi, g1.shape[-1]))


def cx_uniform_partialy_matched(generator, g1, g2, indpb):
    """Uniform PMX (Cicirello and Smith 2000): the PMX swap at each slot
    independently with probability ``indpb``."""
    active = torch.rand(g1.shape, generator=generator,
                        device=generator.device) < indpb
    return _pmx(g1, g2, active)


def ordered_points(generator, m: int, size: int):
    """``cx_ordered``'s draw: two distinct slots (``i1 ~ U{0..L-1}``,
    ``i2 ~ U{0..L-2}`` bumped past it) as the inclusive segment
    ``[min, max]``."""
    i1 = _randint(generator, 0, size, m)
    i2 = _randint(generator, 0, size - 1, m)
    i2 = torch.where(i2 >= i1, i2 + 1, i2)
    return torch.minimum(i1, i2), torch.maximum(i1, i2)


def _ordered(g1, g2, lo, hi):
    """Ordered crossover on given inclusive segments (see
    :func:`cx_ordered`)."""
    a = g1.to(torch.int64)
    b = g2.to(torch.int64)
    m, size = a.shape
    rows = torch.arange(m, device=a.device)
    lo, hi = lo.to(torch.int64), hi.to(torch.int64)
    posa, posb = _positions(a), _positions(b)
    # value v is a hole of child 1 where it sits in b's segment
    hole1 = (posb >= lo[:, None]) & (posb <= hi[:, None])
    hole2 = (posa >= lo[:, None]) & (posa <= hi[:, None])
    c1, c2 = a.clone(), b.clone()
    k1, k2 = hi + 1, hi + 1
    for i in range(size):
        j = (i + hi + 1) % size
        v1, v2 = a[rows, j], b[rows, j]
        take1, take2 = ~hole1[rows, v1], ~hole2[rows, v2]
        s1, s2 = k1 % size, k2 % size
        c1[rows, s1] = torch.where(take1, v1, c1[rows, s1])
        c2[rows, s2] = torch.where(take2, v2, c2[rows, s2])
        k1, k2 = k1 + take1, k2 + take2
    seg = _segment_slots(lo, hi, size, inclusive=True)
    c1 = torch.where(seg, b, c1)
    c2 = torch.where(seg, a, c2)
    return c1.to(g1.dtype), c2.to(g2.dtype)


def cx_ordered(generator, g1, g2):
    """Ordered crossover (OX, Goldberg 1989) of permutations: child 1
    keeps parent 2's inclusive segment and fills the other slots, from
    after the segment and wrapping, with parent 1's values that are not in
    it, in parent 1's rotated order; child 2 the other way round."""
    lo, hi = ordered_points(generator, g1.shape[0], g1.shape[-1])
    return _ordered(g1, g2, lo, hi)


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


# --------------------------------------------------------------- SBX ----

def _sbx_beta(rand, eta):
    """SBX's spread factor from its uniform: ``2u`` up to 0.5, else
    ``1 / (2 (1 - u))``, to the power ``1 / (eta + 1)``."""
    beta = torch.where(rand <= 0.5, 2.0 * rand,
                       div_rn(1.0, 2.0 * (1.0 - rand)))
    return beta ** (1.0 / (eta + 1.0))


def _sbx(g1, g2, eta, rand):
    """Simulated binary crossover on given uniforms (see
    :func:`cx_simulated_binary`)."""
    beta = _sbx_beta(rand, eta)
    c1 = 0.5 * ((1 + beta) * g1 + (1 - beta) * g2)
    c2 = 0.5 * ((1 - beta) * g1 + (1 + beta) * g2)
    return c1, c2


#: ``cx_simulated_binary`` against the JAX package's on its own uniforms:
#: torch's ``pow`` is not XLA's, so each child is within ``SBX_ULPS`` ulp
#: of the JAX child plus that many ulp of the larger parent term
#: ``(1 + β)·max(|g1|, |g2|)`` (``tests/test_torch_ops_rest.py``)
SBX_ULPS = 4


def cx_simulated_binary(generator, g1, g2, eta):
    """Simulated binary crossover (Deb and Agrawal 1995), unbounded: per
    gene a spread factor β from one uniform, children ``((1 ± β) g1 + (1
    ∓ β) g2) / 2``."""
    rand = torch.rand(g1.shape, generator=generator, device=generator.device)
    return _sbx(g1, g2, eta, rand)


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


# -------------------------------------------------- length-changing ----

def messy_points(generator, len1: torch.Tensor, len2: torch.Tensor):
    """``cx_messy_one_point``'s draw: a cut ``k ~ U{0..len}`` in each
    parent of each pair."""
    dev = generator.device

    def cut(length):
        u = torch.rand(length.shape, generator=generator, device=dev)
        k = torch.floor(u * (length + 1).to(torch.float32)).to(length.dtype)
        return torch.minimum(k, length)

    return cut(len1), cut(len2)


def _messy_one_point(g1, len1, g2, len2, k1, k2):
    """Messy one-point crossover on given cuts (see
    :func:`cx_messy_one_point`)."""
    cap = g1.shape[-1]
    idx = torch.arange(cap, device=g1.device)[None, :]

    def splice(a, ka, b, kb, lb):
        # child[i] = a[i] for i < ka, else b[i - ka + kb]
        src = torch.clamp(idx - ka[:, None] + kb[:, None], 0, cap - 1)
        child = torch.where(idx < ka[:, None], a, b.gather(1, src))
        newlen = torch.clamp_max(ka + torch.clamp_min(lb - kb, 0), cap)
        return (torch.where(idx < newlen[:, None], child,
                            torch.zeros_like(child)), newlen)

    c1, n1 = splice(g1, k1, g2, k2, len2)
    c2, n2 = splice(g2, k2, g1, k1, len1)
    return (c1, n1), (c2, n2)


def cx_messy_one_point(generator, g1, len1, g2, len2):
    """Messy one-point crossover of padded genomes with lengths: ``c1 =
    g1[:k1] ++ g2[k2:len2]`` and ``c2 = g2[:k2] ++ g1[k1:len1]``, cut at
    the capacity, zero past the new length. Returns ``((c1, n1), (c2,
    n2))``."""
    k1, k2 = messy_points(generator, len1, len2)
    return _messy_one_point(g1, len1, g2, len2, k1, k2)


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
