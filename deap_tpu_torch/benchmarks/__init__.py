"""Benchmark objective functions, batched over rows.

Port of the functions of :mod:`deap_tpu.benchmarks` that the port's
paths use: sphere and Rastrigin (the continuous GA), ZDT1, DTLZ2
(NSGA-II, NSGA-III), Kursawe ((μ + λ) NSGA-II), Griewank (DE) and h1
(PSO); :mod:`.movingpeaks` is the dynamic landscape of the multi-swarm,
speciation and dynamic-DE strategies. The JAX package's functions
take one genome ``f32[dim]`` and are ``vmap``-ed; these take the
population ``f32[n, dim]`` and return ``f32[n, nobj]`` (minimisation).
"""

from __future__ import annotations

import math

import torch

from deap_tpu_torch.benchmarks import movingpeaks, tools  # noqa: F401

__all__ = ["sphere", "rastrigin", "griewank", "h1", "zdt1", "dtlz2",
           "kursawe", "movingpeaks"]


def sphere(x: torch.Tensor) -> torch.Tensor:
    """``f = Σ x_i²``."""
    return (x * x).sum(1, keepdim=True)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    """Rastrigin, ``f = 10·dim + Σ x_i² − 10·cos(2π x_i)``; optimum 0 at
    the origin."""
    term = x * x - 10.0 * torch.cos(2.0 * math.pi * x)
    return 10.0 * x.shape[1] + term.sum(1, keepdim=True)


#: Griewank against the JAX package's on the CPU: within ``GRIEWANK_RTOL``
#: of ``1 + Σ x²/4000 + Π |cos|`` (torch's ``cos`` and ``sqrt`` of the
#: index are not XLA's, and the product runs in another order)
GRIEWANK_RTOL = 1e-6


def griewank(x: torch.Tensor) -> torch.Tensor:
    """Griewank, ``f = Σ x_i²/4000 − Π cos(x_i / sqrt(i)) + 1`` (i from
    1); optimum 0 at the origin."""
    i = torch.arange(1, x.shape[1] + 1, dtype=x.dtype, device=x.device)
    return ((x * x).sum(1, keepdim=True) / 4000.0
            - torch.cos(x / torch.sqrt(i)).prod(1, keepdim=True) + 1.0)


#: h1 against the JAX package's on the CPU: within ``H1_RTOL`` (torch's
#: ``sin`` and ``sqrt`` are not XLA's)
H1_RTOL = 1e-6


def h1(x: torch.Tensor) -> torch.Tensor:
    """The 2-D maximisation landscape h1, optimum 2 at (8.6998, 6.7665):
    ``(sin²(x0 − x1/8) + sin²(x1 + x0/8)) / (sqrt((x0 − 8.6998)² + (x1 −
    6.7665)²) + 1)``."""
    x0, x1 = x[:, 0], x[:, 1]
    num = torch.sin(x0 - x1 / 8.0) ** 2 + torch.sin(x1 + x0 / 8.0) ** 2
    den = torch.sqrt((x0 - 8.6998) ** 2 + (x1 - 6.7665) ** 2) + 1.0
    return (num / den)[:, None]


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
