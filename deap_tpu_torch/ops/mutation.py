"""Flip-bit mutation on a batch of genomes.

Port of ``mut_flip_bit`` from :mod:`deap_tpu.ops.mutation`:
``(generator, g[n, L], indpb) -> g``. Its ``fused_plan(indpb)`` tag
returns ``("flip", draw)`` where ``draw(generator, n, L, dtype) ->
(mask, None)`` makes exactly the operator's draw, so the fused
variation plane computes the same children.
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
