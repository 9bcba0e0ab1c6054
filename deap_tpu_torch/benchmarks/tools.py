"""Multi-objective quality metrics and analytic optimal fronts.

Port of :func:`hypervolume`, :func:`convergence`, :func:`diversity` and
:func:`optimal_front` (its ZDT1 and DTLZ2 branches) of
:mod:`deap_tpu.benchmarks.tools`. Metrics take objective values
(minimisation) as tensors or arrays and return Python floats.
"""

from __future__ import annotations

from math import comb

import numpy as np
import torch

from deap_tpu_torch.native import hypervolume as _hv

__all__ = ["hypervolume", "convergence", "diversity", "optimal_front"]


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
    """Analytic Pareto-optimal front: ``f32[n, 2]`` for ZDT1, and for
    DTLZ2 the Das-Dennis lattice of at least ``n`` points projected onto
    the unit sphere, ``f32[m, nobj]``."""
    from deap_tpu_torch.mo.emo import uniform_reference_points

    name = name.lower()
    if name == "zdt1":
        f1 = torch.linspace(0.0, 1.0, n)
        return torch.stack([f1, 1.0 - torch.sqrt(f1)], dim=1)
    if name == "dtlz2":
        w = uniform_reference_points(nobj, _dd_partitions(n, nobj))
        return w / torch.linalg.norm(w, dim=1, keepdim=True)
    raise ValueError(f"no analytic front for {name!r} in the port "
                     f"(zdt1 and dtlz2 are ported)")
