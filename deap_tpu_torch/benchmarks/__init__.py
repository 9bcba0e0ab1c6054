"""Benchmark objective functions, batched over rows.

Port of the functions of :mod:`deap_tpu.benchmarks` that the port's
paths use: sphere and Rastrigin (the continuous GA), ZDT1, DTLZ2
(NSGA-II) and Kursawe ((μ + λ) NSGA-II). The JAX package's functions
take one genome ``f32[dim]`` and are ``vmap``-ed; these take the
population ``f32[n, dim]`` and return ``f32[n, nobj]`` (minimisation).
"""

from __future__ import annotations

import math

import torch

from deap_tpu_torch.benchmarks import tools  # noqa: F401

__all__ = ["sphere", "rastrigin", "zdt1", "dtlz2", "kursawe"]


def sphere(x: torch.Tensor) -> torch.Tensor:
    """``f = Σ x_i²``."""
    return (x * x).sum(1, keepdim=True)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    """Rastrigin, ``f = 10·dim + Σ x_i² − 10·cos(2π x_i)``; optimum 0 at
    the origin."""
    term = x * x - 10.0 * torch.cos(2.0 * math.pi * x)
    return 10.0 * x.shape[1] + term.sum(1, keepdim=True)


def _zdt_g(x: torch.Tensor) -> torch.Tensor:
    return 1.0 + 9.0 * x[:, 1:].sum(1) / (x.shape[1] - 1)


def zdt1(x: torch.Tensor) -> torch.Tensor:
    """ZDT1: ``f1 = x0``, ``f2 = g (1 - sqrt(f1 / g))``."""
    g = _zdt_g(x)
    f1 = x[:, 0]
    return torch.stack([f1, g * (1.0 - torch.sqrt(f1 / g))], dim=1)


def _dtlz_spherical(x: torch.Tensor, obj: int, g: torch.Tensor,
                    ) -> torch.Tensor:
    xc = x[:, :obj - 1]
    cosc = torch.cos(0.5 * math.pi * xc)
    cum = torch.cat([torch.ones_like(x[:, :1]), torch.cumprod(cosc, dim=1)],
                    dim=1)                                  # [n, obj]
    fs = [(1.0 + g) * cum[:, obj - 1]]
    for m in range(obj - 2, -1, -1):
        fs.append((1.0 + g) * cum[:, m] * torch.sin(0.5 * math.pi * xc[:, m]))
    return torch.stack(fs, dim=1)


def dtlz2(x: torch.Tensor, obj: int) -> torch.Tensor:
    """DTLZ2 with ``obj`` objectives: the unit sphere's first orthant
    scaled by ``1 + g``, ``g = Σ (x_m - 0.5)²`` over the last
    ``dim - obj + 1`` variables."""
    g = ((x[:, obj - 1:] - 0.5) ** 2).sum(1)
    return _dtlz_spherical(x, obj, g)


#: Kursawe's objectives against the JAX package's (eager or jitted) on
#: the CPU: within ``KURSAWE_RTOL`` of each objective's sum of absolute
#: terms (torch's ``exp``, ``pow`` and ``sin`` are not XLA's, and the sums
#: run in another order; measured at most 3.2e-7 at L 3 and 30).
KURSAWE_RTOL = 1e-6


def kursawe(x: torch.Tensor) -> torch.Tensor:
    """Kursawe's two objectives: ``f1 = Σ -10 exp(-0.2 sqrt(x_i² +
    x_{i+1}²))`` over neighbouring genes, ``f2 = Σ |x_i|^0.8 + 5 sin(x_i³)``."""
    a, b = x[:, :-1], x[:, 1:]
    f1 = (-10.0 * torch.exp(-0.2 * torch.sqrt(a * a + b * b))).sum(1)
    f2 = (x.abs() ** 0.8 + 5.0 * torch.sin(x * x * x)).sum(1)
    return torch.stack([f1, f2], dim=1)
