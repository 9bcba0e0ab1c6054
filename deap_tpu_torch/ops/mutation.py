"""Mutations on a batch of genomes.

Port of ``mut_flip_bit`` and ``mut_polynomial_bounded`` from
:mod:`deap_tpu.ops.mutation`: ``(generator, g[n, L], ...) -> g``. Its ``fused_plan(indpb)`` tag
returns ``("flip", draw)`` where ``draw(generator, n, L, dtype) ->
(mask, None)`` makes exactly the operator's draw, so the fused
variation plane computes the same children. Polynomial bounded
mutation is real-valued and has no fused form; its draws are made by
:func:`polynomial_bounded_draws` and applied by :func:`_polynomial_bounded`.
"""

from __future__ import annotations

import torch


def _flip_mask(generator, n: int, L: int, indpb: float) -> torch.Tensor:
    u = torch.rand((n, L), generator=generator, device=generator.device)
    return u < indpb


def mut_flip_bit(generator, g: torch.Tensor, indpb: float) -> torch.Tensor:
    """Bit flip: logical-not of each gene with probability ``indpb``."""
    mask = _flip_mask(generator, g.shape[0], g.shape[-1], indpb)
    flipped = (~g.to(torch.bool)).to(g.dtype)
    return torch.where(mask, flipped, g)


def _flip_bit_fused(indpb):
    def draw(generator, n, L, dtype):
        del dtype  # flip needs no values, only the operator's mask bits
        return _flip_mask(generator, n, L, indpb), None
    return "flip", draw


mut_flip_bit.fused_plan = _flip_bit_fused


# ----------------------------------------------- polynomial bounded ----

def polynomial_bounded_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_polynomial_bounded` per gene: the
    mutation mask (probability ``indpb``), then the uniform."""
    dev = generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < indpb
    rand = torch.rand(shape, generator=generator, device=dev)
    return mask, rand


def _polynomial_bounded(g, eta, low, up, mask, rand):
    """Polynomial bounded mutation on given draws."""
    low = torch.as_tensor(low, dtype=g.dtype, device=g.device)
    up = torch.as_tensor(up, dtype=g.dtype, device=g.device)
    span = up - low
    delta_1 = (g - low) / span
    delta_2 = (up - g) / span
    mut_pow = 1.0 / (eta + 1.0)
    val_lo = 2.0 * rand + (1.0 - 2.0 * rand) * (1.0 - delta_1) ** (eta + 1.0)
    val_hi = (2.0 * (1.0 - rand)
              + 2.0 * (rand - 0.5) * (1.0 - delta_2) ** (eta + 1.0))
    delta_q = torch.where(rand < 0.5, val_lo ** mut_pow - 1.0,
                          1.0 - val_hi ** mut_pow)
    out = torch.minimum(torch.maximum(g + delta_q * span, low), up)
    return torch.where(mask, out, g)


def mut_polynomial_bounded(generator, g: torch.Tensor, eta, low, up,
                           indpb: float) -> torch.Tensor:
    """Deb's polynomial bounded mutation: each gene with probability
    ``indpb``, distribution index ``eta``, clipped to ``[low, up]``."""
    return _polynomial_bounded(
        g, eta, low, up, *polynomial_bounded_draws(generator, g.shape, indpb))
