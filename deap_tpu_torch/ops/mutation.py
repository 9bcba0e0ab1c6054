"""Mutations on a batch of genomes.

Port of ``mut_flip_bit``, ``mut_gaussian`` and ``mut_polynomial_bounded``
from :mod:`deap_tpu.ops.mutation`: ``(generator, g[n, L], ...) -> g``.
A ``fused_plan(**params)`` tag returns ``(kind, draw)`` where
``draw(generator, n, L, dtype) -> (mask, arg)`` makes exactly the
operator's draws, so the fused variation plane computes the same
children: ``("flip", ...)`` for flip-bit, ``("add", ...)`` with the
Gaussian noise for ``mut_gaussian``. Polynomial bounded mutation has no
fused form. Each real-valued operator's draws are made by a ``*_draws``
function and applied by a draw-taking core.
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


# --------------------------------------------------------- gaussian ----

def gaussian_draws(generator, shape, indpb: float):
    """The draws of :func:`mut_gaussian` per gene: the mutation mask
    (probability ``indpb``), then a standard normal."""
    dev = generator.device
    mask = torch.rand(shape, generator=generator, device=dev) < indpb
    z = torch.randn(shape, generator=generator, device=dev)
    return mask, z


def _gaussian(g, mu, sigma, mask, z):
    """Gaussian mutation on given draws (see :func:`mut_gaussian`)."""
    return torch.where(mask, g + (mu + sigma * z), g)


def mut_gaussian(generator, g: torch.Tensor, mu, sigma,
                 indpb: float) -> torch.Tensor:
    """Gaussian additive mutation: each gene gets ``+ N(mu, sigma)`` with
    probability ``indpb``."""
    return _gaussian(g, mu, sigma, *gaussian_draws(generator, g.shape, indpb))


def _gaussian_fused(mu, sigma, indpb):
    def draw(generator, n, L, dtype):
        del dtype  # the noise is float32, as K1's add kind takes it
        mask, z = gaussian_draws(generator, (n, L), indpb)
        return mask, mu + sigma * z
    return "add", draw


mut_gaussian.fused_plan = _gaussian_fused


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
