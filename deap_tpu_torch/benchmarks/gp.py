"""Symbolic-regression target functions.

Port of :mod:`deap_tpu.benchmarks.gp`: the ground truths a GP run tries
to rediscover. Each takes sample points ``f32[n, dims]`` and returns
``f32[n]`` (the JAX package's take one point and are ``vmap``-ed).
"""

from __future__ import annotations

import torch

__all__ = ["kotanchek", "salustowicz_1d", "salustowicz_2d",
           "unwrapped_ball", "rational_polynomial", "sin_cos", "ripple",
           "rational_polynomial2"]

#: the targets against the JAX package's (``jax.jit`` of its ``vmap``) on
#: the CPU: ``|port - jax| <= GP_TARGET_RTOL · max(1, |jax|)`` (torch's
#: ``exp``, ``sin``, ``cos`` are not XLA's; measured at most 2.6e-7 on 256
#: random points)
GP_TARGET_RTOL = 1e-6


def kotanchek(data: torch.Tensor) -> torch.Tensor:
    """``exp(−(x0 − 1)²) / (3.2 + (x1 − 2.5)²)``, x in [−1, 7]²."""
    return (torch.exp(-((data[:, 0] - 1.0) ** 2))
            / (3.2 + (data[:, 1] - 2.5) ** 2))


def salustowicz_1d(data: torch.Tensor) -> torch.Tensor:
    """``e^−x x³ cos x sin x (cos x sin²x − 1)``, x in [0, 10]."""
    x = data[:, 0]
    return (torch.exp(-x) * x ** 3 * torch.cos(x) * torch.sin(x)
            * (torch.cos(x) * torch.sin(x) ** 2 - 1.0))


def salustowicz_2d(data: torch.Tensor) -> torch.Tensor:
    """``salustowicz_1d(x0) · (x1 − 5)``, x in [0, 7]²."""
    return salustowicz_1d(data) * (data[:, 1] - 5.0)


def unwrapped_ball(data: torch.Tensor) -> torch.Tensor:
    """``10 / (5 + Σ (x_i − 3)²)``, x in [−2, 8]ⁿ."""
    return 10.0 / (5.0 + ((data - 3.0) ** 2).sum(1))


def rational_polynomial(data: torch.Tensor) -> torch.Tensor:
    """``30 (x0 − 1)(x2 − 1) / (x1² (x0 − 10))``."""
    return (30.0 * (data[:, 0] - 1.0) * (data[:, 2] - 1.0)
            / (data[:, 1] ** 2 * (data[:, 0] - 10.0)))


def sin_cos(data: torch.Tensor) -> torch.Tensor:
    """``6 sin(x0) cos(x1)``, x in [0, 6]²."""
    return 6.0 * torch.sin(data[:, 0]) * torch.cos(data[:, 1])


def ripple(data: torch.Tensor) -> torch.Tensor:
    """``(x0 − 3)(x1 − 3) + 2 sin((x0 − 4)(x1 − 4))``, x in [−5, 5]²."""
    return ((data[:, 0] - 3.0) * (data[:, 1] - 3.0)
            + 2.0 * torch.sin((data[:, 0] - 4.0) * (data[:, 1] - 4.0)))


def rational_polynomial2(data: torch.Tensor) -> torch.Tensor:
    """``((x0 − 3)⁴ + (x1 − 3)³ − (x1 − 3)) / ((x1 − 2)⁴ + 10)``."""
    return (((data[:, 0] - 3.0) ** 4 + (data[:, 1] - 3.0) ** 3
             - (data[:, 1] - 3.0)) / ((data[:, 1] - 2.0) ** 4 + 10.0))
