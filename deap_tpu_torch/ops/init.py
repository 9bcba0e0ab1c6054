"""Genome initialisers and structural combinators.

Port of :mod:`deap_tpu.ops.init`. Where the JAX package builds a per-
genome ``key -> array`` function and vmaps it, the port's initialisers
are batched: ``init(generator, n) -> [n, ...]``, drawn on the
generator's device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch


def bernoulli_genome(length: int, p: float = 0.5, dtype=torch.bool):
    """``attr_bool`` x length: random bitstrings."""
    def init(generator, n):
        u = torch.rand((n, length), generator=generator,
                       device=generator.device)
        return (u < p).to(dtype)
    return init


def uniform_genome(length: int, minval: float = 0.0, maxval: float = 1.0,
                   dtype=torch.float32):
    """``random.uniform`` x length: real-valued genomes."""
    def init(generator, n):
        u = torch.rand((n, length), generator=generator,
                       device=generator.device, dtype=dtype)
        return u * (maxval - minval) + minval
    return init


def normal_genome(length: int, mu: float = 0.0, sigma: float = 1.0,
                  dtype=torch.float32):
    def init(generator, n):
        z = torch.randn((n, length), generator=generator,
                        device=generator.device, dtype=dtype)
        return mu + sigma * z
    return init


def randint_genome(length: int, low: int, high: int, dtype=torch.int32):
    """``random.randint(low, high)`` x length — ``high`` inclusive."""
    def init(generator, n):
        return torch.randint(low, high + 1, (n, length), generator=generator,
                             device=generator.device, dtype=dtype)
    return init


def permutation_genome(length: int, dtype=torch.int32):
    """``random.sample(range(L), L)``: permutation genomes."""
    def init(generator, n):
        u = torch.rand((n, length), generator=generator,
                       device=generator.device)
        return u.argsort(-1).to(dtype)
    return init


def constant_genome(value: torch.Tensor):
    def init(generator, n):
        v = torch.as_tensor(value, device=generator.device)
        return v.expand((n,) + tuple(v.shape)).clone()
    return init


def init_repeat(genome_init: Callable, n: int):
    """``n`` draws of ``genome_init`` stacked on a new axis 1 —
    initRepeat."""
    def init(generator, count):
        return torch.stack([genome_init(generator, count) for _ in range(n)],
                           dim=1)
    return init


def init_iterate(genome_inits: Sequence[Callable]):
    """One draw of each generator, concatenated — initIterate."""
    def init(generator, n):
        parts = [g(generator, n).reshape(n, -1) for g in genome_inits]
        return torch.cat(parts, dim=1)
    return init


def init_cycle(genome_inits: Sequence[Callable], n: int = 1):
    """``n`` cycles through the generators — initCycle."""
    def init(generator, count):
        return torch.cat([init_iterate(genome_inits)(generator, count)
                          for _ in range(n)], dim=1)
    return init
