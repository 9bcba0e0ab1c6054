"""Benchmark transform decorators, multi-objective quality metrics and
analytic optimal fronts.

Port of :mod:`deap_tpu.benchmarks.tools`. The transforms ``translate``,
``rotate``, ``scale``, ``noise`` and ``bound`` are decorator objects with
a method that updates their parameter, as the reference's are (so
``evaluate.translate(new_vector)`` works); they transform the genomes
``[n, dim]`` before the wrapped evaluation. ``noise`` draws from a
``torch.Generator``: the decorated evaluation's signature becomes
``(x, generator)``. Metrics take objective values (minimisation) as
tensors or arrays and return Python floats.
"""

from __future__ import annotations

import math
from functools import wraps
from math import comb

import numpy as np
import torch

from deap_tpu_torch.native import hypervolume as _hv

__all__ = ["translate", "rotate", "scale", "noise", "bound", "hypervolume",
           "convergence", "diversity", "igd", "optimal_front"]


class translate:
    """Translate the objective function by ``vector``: the wrapped
    evaluation sees ``x − vector``."""

    def __init__(self, vector):
        self.translate(vector)

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, **kwargs):
            return func(individual - self.vector.to(individual.device),
                        *args, **kwargs)
        wrapper.translate = self.translate
        return wrapper

    def translate(self, vector):
        self.vector = torch.as_tensor(vector, dtype=torch.float32)


class rotate:
    """Rotate the objective function by the orthogonal ``matrix``: the
    wrapped evaluation sees each genome times the inverse rotation."""

    def __init__(self, matrix):
        self.rotate(matrix)

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, **kwargs):
            m = self.matrix.to(individual.device)
            return func(individual @ m.T, *args, **kwargs)
        wrapper.rotate = self.rotate
        return wrapper

    def rotate(self, matrix):
        self.matrix = torch.linalg.inv(torch.as_tensor(
            matrix, dtype=torch.float32))


class scale:
    """Scale the objective function by ``factor`` per gene: the wrapped
    evaluation sees ``x / factor``."""

    def __init__(self, factor):
        self.scale(factor)

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, *args, **kwargs):
            return func(individual * self.factor.to(individual.device),
                        *args, **kwargs)
        wrapper.scale = self.scale
        return wrapper

    def scale(self, factor):
        self.factor = 1.0 / torch.as_tensor(factor, dtype=torch.float32)


class noise:
    """Additive objective noise of deviation ``sigma`` (a scalar or one an
    objective, ``None`` for none); the decorated evaluation takes the
    generator that draws it: ``evaluate(x, generator)``."""

    def __init__(self, sigma):
        self.noise(sigma)

    def __call__(self, func):
        @wraps(func)
        def wrapper(individual, generator, *args, **kwargs):
            values = func(individual, *args, **kwargs)
            if self.sigma is None:
                return values
            return values + self.sigma.to(values.device) * torch.randn(
                values.shape, generator=generator, device=values.device)
        wrapper.noise = self.noise
        return wrapper

    def noise(self, sigma):
        self.sigma = None if sigma is None else torch.as_tensor(
            sigma, dtype=torch.float32)


class bound:
    """Bring a decorated operator's outputs back into ``[low, up]`` by
    clipping, wrapping or mirroring (``type_``)."""

    def __init__(self, bounds, type_="clip"):
        self.low, self.up = (torch.as_tensor(b, dtype=torch.float32)
                             for b in bounds)
        if type_ not in ("clip", "wrap", "mirror"):
            raise ValueError(type_)
        self.type = type_

    def _apply(self, x):
        low, up = self.low.to(x.device), self.up.to(x.device)
        if self.type == "clip":
            return torch.minimum(torch.maximum(x, low), up)
        span = up - low
        if self.type == "wrap":
            return low + torch.remainder(x - low, span)
        t = torch.remainder(x - low, 2 * span)
        return low + torch.where(t > span, 2 * span - t, t)

    def __call__(self, func):
        @wraps(func)
        def wrapper(*args, **kwargs):
            out = func(*args, **kwargs)
            if isinstance(out, tuple):
                return tuple(self._apply(o) for o in out)
            return self._apply(out)
        return wrapper


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))


def diversity(first_front, first, last) -> float:
    """Deb's NSGA-II spread Δ: ``first_front`` is ``[n, 2]`` objective
    values in front order, ``first``/``last`` the extreme points of the
    optimal front. Smaller is better."""
    ff = _tensor(first_front)
    df = torch.hypot(ff[0, 0] - first[0], ff[0, 1] - first[1])
    dl = torch.hypot(ff[-1, 0] - last[0], ff[-1, 1] - last[1])
    if ff.shape[0] == 1:
        return float(df + dl)
    dt = torch.hypot(ff[:-1, 0] - ff[1:, 0], ff[:-1, 1] - ff[1:, 1])
    dm = dt.mean()
    di = (dt - dm).abs().sum()
    return float((df + dl + di) / (df + dl + dt.shape[0] * dm))


def convergence(first_front, optimal_front) -> float:
    """Mean distance from each front member to its nearest optimal
    point. Smaller is better."""
    a = _tensor(first_front)[:, None, :]
    z = _tensor(optimal_front)[None, :, :]
    d = ((a - z) ** 2).sum(-1).sqrt()
    return float(d.amin(1).mean())


def igd(A, Z) -> float:
    """Inverted generational distance: the mean over the reference points
    ``Z`` of the distance to the nearest point of the approximation
    ``A``."""
    a = _tensor(A)[:, None, :]
    z = _tensor(Z)[None, :, :]
    d = ((a - z) ** 2).sum(-1).sqrt()                       # [|A|, |Z|]
    return float(d.amin(0).mean())


def hypervolume(front, ref=None, weights=None) -> float:
    """Hypervolume of a front: a port :class:`Population` (its valid rows),
    or raw objective values with ``weights`` (default: minimise every
    objective). Computed in minimisation space, ``-wvalues``, against
    ``ref`` (default: the worst value + 1 per objective)."""
    from deap_tpu_torch.core.population import Population

    if isinstance(front, Population):
        w = (front.fitness * front.spec.warray(front.device))[front.valid]
        w = w.detach().cpu().numpy()
    else:
        front = np.asarray(front.detach().cpu() if isinstance(
            front, torch.Tensor) else front)
        if weights is None:
            weights = -np.ones(front.shape[-1])
        w = front * np.asarray(weights)
    wobj = -w
    if ref is None:
        ref = np.max(wobj, axis=0) + 1
    return _hv(wobj, np.asarray(ref))


def _dd_partitions(n: int, nobj: int) -> int:
    """Smallest Das-Dennis partition count whose lattice has >= n
    points."""
    p = 1
    while comb(p + nobj - 1, nobj - 1) < n:
        p += 1
    return p


def optimal_front(name: str, n: int = 100, nobj: int = 3) -> torch.Tensor:
    """Analytic Pareto-optimal fronts of the ZDT and DTLZ families:
    ``f32[n, 2]`` for ZDT (ZDT3's disconnected front is the non-dominated
    subset of a dense curve, subsampled), and for DTLZ the Das-Dennis
    lattice of at least ``n`` points, ``f32[m, nobj]`` (scaled by 0.5 for
    DTLZ1's simplex, projected onto the unit sphere for DTLZ2-4)."""
    from deap_tpu_torch.mo.emo import uniform_reference_points

    name = name.lower()
    if name in ("zdt1", "zdt4"):
        f1 = torch.linspace(0.0, 1.0, n)
        return torch.stack([f1, 1.0 - torch.sqrt(f1)], dim=1)
    if name == "zdt2":
        f1 = torch.linspace(0.0, 1.0, n)
        return torch.stack([f1, 1.0 - f1 ** 2], dim=1)
    if name == "zdt3":
        # f1 = x rises along the curve, so a point is non-dominated iff
        # its f2 is below every earlier f2
        x = torch.linspace(0.0, 1.0, 16 * n)
        f2 = 1.0 - torch.sqrt(x) - x * torch.sin(10.0 * math.pi * x)
        prev = torch.cat([torch.tensor([torch.inf]),
                          torch.cummin(f2, 0).values[:-1]])
        keep = torch.nonzero(f2 < prev)[:, 0]
        pick = torch.linspace(0, keep.shape[0] - 1, n).to(torch.int32)
        idx = keep[pick.long()]
        return torch.stack([x[idx], f2[idx]], dim=1)
    if name == "zdt6":
        # f2 = 1 - f1² over the attained f1, sorted and deduplicated
        x = torch.linspace(0.0, 1.0, 16 * n)
        f1 = 1.0 - torch.exp(-4.0 * x) * torch.sin(6.0 * math.pi * x) ** 6
        u = torch.unique(f1)
        pick = torch.linspace(0, u.shape[0] - 1, n).to(torch.int32)
        f1s = u[pick.long()]
        return torch.stack([f1s, 1.0 - f1s ** 2], dim=1)
    if name == "dtlz1":
        return 0.5 * uniform_reference_points(nobj, _dd_partitions(n, nobj))
    if name in ("dtlz2", "dtlz3", "dtlz4"):
        w = uniform_reference_points(nobj, _dd_partitions(n, nobj))
        return w / torch.linalg.norm(w, dim=1, keepdim=True)
    raise ValueError(f"no analytic front for {name!r}")
