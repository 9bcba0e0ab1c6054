"""Benchmark objective functions, batched over rows.

Port of :mod:`deap_tpu.benchmarks`: the single-objective set (sphere,
Rastrigin and its scaled and skewed forms, Griewank, h1, Ackley, ...),
the multi-objective set (Kursawe, the ZDT and DTLZ families, Fonseca,
Poloni, Schaffer's, Dent), and the modules :mod:`.binary` (bit-genome
functions), :mod:`.cartpole` (the control task and its rollouts, J5), :mod:`.gp` (symbolic-regression targets), :mod:`.tools`
(transforms and quality metrics) and :mod:`.movingpeaks` (the dynamic
landscape). The JAX package's functions take one genome ``f32[dim]`` and
are ``vmap``-ed; these take the population ``f32[n, dim]`` and return
``f32[n, nobj]``. Weights follow the reference's docs: minimisation for
most, h1, shekel and Poloni maximisation.
"""

from __future__ import annotations

import math

import torch

from deap_tpu_torch.benchmarks import (  # noqa: F401
    binary, cartpole, gp, movingpeaks, tools)

__all__ = [
    "rand", "plane", "sphere", "cigar", "rosenbrock", "h1", "ackley",
    "bohachevsky", "griewank", "rastrigin", "rastrigin_scaled",
    "rastrigin_skew", "schaffer", "schwefel", "himmelblau", "shekel",
    "kursawe", "schaffer_mo", "zdt1", "zdt2", "zdt3", "zdt4", "zdt6",
    "dtlz1", "dtlz2", "dtlz3", "dtlz4", "dtlz5", "dtlz6", "dtlz7",
    "fonseca", "poloni", "dent", "binary", "cartpole", "gp", "movingpeaks",
    "tools",
]

#: the functions below against the JAX package's (``jax.jit`` of its
#: ``vmap``) on the CPU: ``|port - jax| <= BENCH_RTOL[name] · max(1,
#: |jax|)``. torch's ``exp``, ``cos``, ``sin``, ``sqrt`` and ``pow`` are not
#: XLA's, XLA contracts ``a*b + c`` into one rounding, and sums run in
#: another order; 0 where the two are bitwise. Each bound is about 4x the
#: largest error measured on 256 random rows (schaffer 2.3e-6, himmelblau
#: 1.2e-6, dtlz6 6.6e-7, the rest at most 4.9e-7).
BENCH_RTOL = {
    "plane": 0.0, "cigar": 1e-6, "rosenbrock": 1e-6, "ackley": 1e-6,
    "bohachevsky": 1e-6, "rastrigin_scaled": 2e-6, "rastrigin_skew": 1e-6,
    "schaffer": 1e-5, "schwefel": 1e-6, "himmelblau": 5e-6, "shekel": 1e-6,
    "schaffer_mo": 0.0, "zdt2": 2e-6, "zdt3": 2e-6, "zdt4": 1e-6,
    "zdt6": 2e-6, "dtlz1": 1e-6, "dtlz3": 1e-6, "dtlz4": 1e-6,
    "dtlz5": 1e-6, "dtlz6": 3e-6, "dtlz7": 2e-6, "fonseca": 1e-6,
    "poloni": 2e-6, "dent": 1e-6,
}


def rand(generator: torch.Generator, x: torch.Tensor) -> torch.Tensor:
    """A random "fitness" in [0, 1) a row, drawn from ``generator``."""
    return torch.rand((x.shape[0], 1), generator=generator,
                      device=generator.device)


def plane(x: torch.Tensor) -> torch.Tensor:
    """``f = x_0``."""
    return x[:, :1]


def sphere(x: torch.Tensor) -> torch.Tensor:
    """``f = Σ x_i²``."""
    return (x * x).sum(1, keepdim=True)


def cigar(x: torch.Tensor) -> torch.Tensor:
    """``f = x_0² + 1e6 Σ_{i>0} x_i²``."""
    return (x[:, 0] ** 2 + 1e6 * (x[:, 1:] ** 2).sum(1))[:, None]


def rosenbrock(x: torch.Tensor) -> torch.Tensor:
    """``f = Σ 100 (x_i² − x_{i+1})² + (1 − x_i)²`` (the reference's
    ``(x² − y)²`` form)."""
    a, b = x[:, :-1], x[:, 1:]
    return (100.0 * (a * a - b) ** 2 + (1.0 - a) ** 2).sum(1, keepdim=True)


def ackley(x: torch.Tensor) -> torch.Tensor:
    """Ackley, optimum 0 at the origin."""
    return (20.0 - 20.0 * torch.exp(-0.2 * torch.sqrt((x * x).mean(1)))
            + math.e - torch.exp(torch.cos(2.0 * math.pi * x).mean(1))
            )[:, None]


def bohachevsky(x: torch.Tensor) -> torch.Tensor:
    """Bohachevsky: ``Σ x_i² + 2 x_{i+1}² − 0.3 cos(3π x_i) − 0.4 cos(4π
    x_{i+1}) + 0.7``."""
    a, b = x[:, :-1], x[:, 1:]
    return (a ** 2 + 2.0 * b ** 2 - 0.3 * torch.cos(3.0 * math.pi * a)
            - 0.4 * torch.cos(4.0 * math.pi * b) + 0.7).sum(1, keepdim=True)


def rastrigin(x: torch.Tensor) -> torch.Tensor:
    """Rastrigin, ``f = 10·dim + Σ x_i² − 10·cos(2π x_i)``; optimum 0 at
    the origin."""
    term = x * x - 10.0 * torch.cos(2.0 * math.pi * x)
    return 10.0 * x.shape[1] + term.sum(1, keepdim=True)


def rastrigin_scaled(x: torch.Tensor) -> torch.Tensor:
    """Scaled Rastrigin: gene ``i`` scaled by ``10^(i / (dim − 1))``."""
    n = x.shape[1]
    i = torch.arange(n, dtype=x.dtype, device=x.device)
    s = 10.0 ** (i / (n - 1))
    return 10.0 * n + ((s * x) ** 2 - 10.0 * torch.cos(
        2.0 * math.pi * s * x)).sum(1, keepdim=True)


def rastrigin_skew(x: torch.Tensor) -> torch.Tensor:
    """Skewed Rastrigin: positive genes scaled by 10."""
    y = torch.where(x > 0, 10.0 * x, x)
    return 10.0 * x.shape[1] + (y * y - 10.0 * torch.cos(
        2.0 * math.pi * y)).sum(1, keepdim=True)


def schaffer(x: torch.Tensor) -> torch.Tensor:
    """Schaffer: ``Σ s^0.25 (sin²(50 s^0.1) + 1)``, ``s = x_i² +
    x_{i+1}²``."""
    a, b = x[:, :-1], x[:, 1:]
    s = a * a + b * b
    return (s ** 0.25 * (torch.sin(50.0 * s ** 0.1) ** 2 + 1.0)).sum(
        1, keepdim=True)


def schwefel(x: torch.Tensor) -> torch.Tensor:
    """Schwefel, optimum 0 at 420.96874636..."""
    return (418.9828872724339 * x.shape[1]
            - (x * torch.sin(torch.sqrt(x.abs()))).sum(1, keepdim=True))


def himmelblau(x: torch.Tensor) -> torch.Tensor:
    """Himmelblau, four optima at value 0."""
    x0, x1 = x[:, 0], x[:, 1]
    return ((x0 ** 2 + x1 - 11.0) ** 2 + (x0 + x1 ** 2 - 7.0) ** 2)[:, None]


def shekel(x: torch.Tensor, a, c) -> torch.Tensor:
    """Shekel's foxholes (maximisation): ``Σ_i 1 / (c_i + ‖x − a_i‖²)``;
    ``a`` ``[M, dim]`` the maxima, ``c`` ``[M]`` their widths."""
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    c = torch.as_tensor(c, dtype=x.dtype, device=x.device)
    d = ((x[:, None, :] - a[None]) ** 2).sum(2)
    return (1.0 / (c + d)).sum(1, keepdim=True)


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


def schaffer_mo(x: torch.Tensor) -> torch.Tensor:
    """Schaffer's two objectives on one gene: ``x_0²``, ``(x_0 − 2)²``."""
    x0 = x[:, 0]
    return torch.stack([x0 ** 2, (x0 - 2.0) ** 2], dim=1)


def _zdt_g(x: torch.Tensor) -> torch.Tensor:
    return 1.0 + 9.0 * x[:, 1:].sum(1) / (x.shape[1] - 1)


def zdt1(x: torch.Tensor) -> torch.Tensor:
    """ZDT1: ``f1 = x0``, ``f2 = g (1 - sqrt(f1 / g))``."""
    g = _zdt_g(x)
    f1 = x[:, 0]
    return torch.stack([f1, g * (1.0 - torch.sqrt(f1 / g))], dim=1)


def zdt2(x: torch.Tensor) -> torch.Tensor:
    """ZDT2: ``f1 = x0``, ``f2 = g (1 − (f1 / g)²)``."""
    g = _zdt_g(x)
    f1 = x[:, 0]
    return torch.stack([f1, g * (1.0 - (f1 / g) ** 2)], dim=1)


def zdt3(x: torch.Tensor) -> torch.Tensor:
    """ZDT3: ``f2 = g (1 − sqrt(f1 / g) − f1 / g · sin(10π f1))``."""
    g = _zdt_g(x)
    f1 = x[:, 0]
    return torch.stack([f1, g * (1.0 - torch.sqrt(f1 / g) - f1 / g
                                 * torch.sin(10.0 * math.pi * f1))], dim=1)


def zdt4(x: torch.Tensor) -> torch.Tensor:
    """ZDT4: ZDT1's front with a Rastrigin-like ``g``."""
    t = x[:, 1:]
    g = (1.0 + 10.0 * (x.shape[1] - 1)
         + (t ** 2 - 10.0 * torch.cos(4.0 * math.pi * t)).sum(1))
    f1 = x[:, 0]
    return torch.stack([f1, g * (1.0 - torch.sqrt(f1 / g))], dim=1)


def zdt6(x: torch.Tensor) -> torch.Tensor:
    """ZDT6: ``f1 = 1 − exp(−4 x0) sin⁶(6π x0)``, ``g = 1 + 9 (Σ x_i /
    (dim − 1))^0.25``."""
    g = 1.0 + 9.0 * (x[:, 1:].sum(1) / (x.shape[1] - 1)) ** 0.25
    x0 = x[:, 0]
    f1 = 1.0 - torch.exp(-4.0 * x0) * torch.sin(6.0 * math.pi * x0) ** 6
    return torch.stack([f1, g * (1.0 - (f1 / g) ** 2)], dim=1)


def _dtlz_rastrigin_g(xm: torch.Tensor) -> torch.Tensor:
    return 100.0 * (xm.shape[1] + ((xm - 0.5) ** 2 - torch.cos(
        20.0 * math.pi * (xm - 0.5))).sum(1))


def dtlz1(x: torch.Tensor, obj: int) -> torch.Tensor:
    """DTLZ1 with ``obj`` objectives: the simplex ``Σ f = 0.5`` scaled by
    ``1 + g``, ``g`` Rastrigin-like over the last ``dim − obj + 1``
    variables."""
    g = _dtlz_rastrigin_g(x[:, obj - 1:])
    xc = x[:, :obj - 1]
    cum = torch.cat([torch.ones_like(x[:, :1]), torch.cumprod(xc, dim=1)],
                    dim=1)                                  # [n, obj]
    fs = [0.5 * cum[:, obj - 1] * (1.0 + g)]
    for m in range(obj - 2, -1, -1):
        fs.append(0.5 * cum[:, m] * (1.0 - xc[:, m]) * (1.0 + g))
    return torch.stack(fs, dim=1)


def _dtlz_spherical(x: torch.Tensor, obj: int, g: torch.Tensor,
                    alpha: float = 1.0) -> torch.Tensor:
    xc = x[:, :obj - 1]
    if alpha != 1.0:
        xc = xc ** alpha
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


def dtlz3(x: torch.Tensor, obj: int) -> torch.Tensor:
    """DTLZ3: DTLZ2's sphere with DTLZ1's Rastrigin-like ``g``."""
    return _dtlz_spherical(x, obj, _dtlz_rastrigin_g(x[:, obj - 1:]))


def dtlz4(x: torch.Tensor, obj: int, alpha: float) -> torch.Tensor:
    """DTLZ4: DTLZ2 with the position variables mapped ``x → x^alpha``."""
    g = ((x[:, obj - 1:] - 0.5) ** 2).sum(1)
    return _dtlz_spherical(x, obj, g, alpha)


def _dtlz_theta(x: torch.Tensor, n_objs: int, g: torch.Tensor,
                ) -> torch.Tensor:
    """DTLZ5's and DTLZ6's geometry: the first angle is ``x_0``, the rest
    pass through ``θ(x) = π / (4 (1 + g)) · (1 + 2 g x)``."""
    gc = g[:, None]
    theta = math.pi / (4.0 * (1.0 + gc)) * (1.0 + 2.0 * gc * x)
    c0 = torch.cos(0.5 * math.pi * x[:, 0])
    s0 = torch.sin(0.5 * math.pi * x[:, 0])
    cum = torch.cat([torch.ones_like(x[:, :1]),
                     torch.cumprod(torch.cos(theta[:, 1:]), dim=1)], dim=1)
    fs = [(1.0 + g) * c0 * cum[:, x.shape[1] - 1]]
    for m in range(n_objs - 1, 0, -1):
        if m == 1:
            fs.append((1.0 + g) * s0)
        else:
            fs.append((1.0 + g) * c0 * cum[:, m - 2]
                      * torch.sin(theta[:, m - 1]))
    return torch.stack(fs, dim=1)


def dtlz5(x: torch.Tensor, n_objs: int) -> torch.Tensor:
    """DTLZ5: a degenerate curve front, ``g = Σ (x_m − 0.5)²``."""
    return _dtlz_theta(x, n_objs, ((x[:, n_objs - 1:] - 0.5) ** 2).sum(1))


def dtlz6(x: torch.Tensor, n_objs: int) -> torch.Tensor:
    """DTLZ6: DTLZ5 with ``g = Σ x_m^0.1``."""
    return _dtlz_theta(x, n_objs, (x[:, n_objs - 1:] ** 0.1).sum(1))


def dtlz7(x: torch.Tensor, n_objs: int) -> torch.Tensor:
    """DTLZ7: disconnected fronts; the first ``n_objs − 1`` objectives are
    the genes."""
    tail = x[:, n_objs - 1:]
    g = 1.0 + 9.0 / tail.shape[1] * tail.sum(1)
    head = x[:, :n_objs - 1]
    last = (1.0 + g) * (n_objs - (head / (1.0 + g[:, None]) * (
        1.0 + torch.sin(3.0 * math.pi * head))).sum(1))
    return torch.cat([head, last[:, None]], dim=1)


def fonseca(x: torch.Tensor) -> torch.Tensor:
    """Fonseca–Fleming's two objectives on the first 3 genes."""
    inv_sqrt = 1.0 / math.sqrt(3.0)
    x3 = x[:, :3]
    f1 = 1.0 - torch.exp(-((x3 - inv_sqrt) ** 2).sum(1))
    f2 = 1.0 - torch.exp(-((x3 + inv_sqrt) ** 2).sum(1))
    return torch.stack([f1, f2], dim=1)


def poloni(x: torch.Tensor) -> torch.Tensor:
    """Poloni's two objectives (maximisation) on 2 genes."""
    s1, c1, s2, c2 = (math.sin(1.0), math.cos(1.0), math.sin(2.0),
                      math.cos(2.0))
    a1 = 0.5 * s1 - 2.0 * c1 + s2 - 1.5 * c2
    a2 = 1.5 * s1 - c1 + 2.0 * s2 - 0.5 * c2
    x0, x1 = x[:, 0], x[:, 1]
    b1 = (0.5 * torch.sin(x0) - 2.0 * torch.cos(x0) + torch.sin(x1)
          - 1.5 * torch.cos(x1))
    b2 = (1.5 * torch.sin(x0) - torch.cos(x0) + 2.0 * torch.sin(x1)
          - 0.5 * torch.cos(x1))
    return torch.stack([1.0 + (a1 - b1) ** 2 + (a2 - b2) ** 2,
                        (x0 + 3.0) ** 2 + (x1 + 1.0) ** 2], dim=1)


def dent(x: torch.Tensor, lambda_: float = 0.85) -> torch.Tensor:
    """Dent's two objectives on 2 genes."""
    x0, x1 = x[:, 0], x[:, 1]
    d = lambda_ * torch.exp(-((x0 - x1) ** 2))
    s = (torch.sqrt(1.0 + (x0 + x1) ** 2)
         + torch.sqrt(1.0 + (x0 - x1) ** 2))
    return torch.stack([0.5 * (s + x0 - x1) + d, 0.5 * (s - x0 + x1) + d],
                       dim=1)


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
