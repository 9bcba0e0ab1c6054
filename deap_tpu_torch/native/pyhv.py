"""Pure-Python/numpy exact hypervolume.

A copy of :mod:`deap_tpu.native.pyhv` (the port imports nothing of the
JAX package). An independent implementation of the WFG exclusive-
hypervolume recursion (While, Fonseca et al. lineage) with a closed-form
2-D staircase fast path, the counterpart of DEAP's pure-Python
``tools/_hypervolume/pyhv.py``. The C++ binding of the JAX package is
not ported yet.

Convention: MINIMISATION relative to ``ref``; points not strictly below
``ref`` in every objective contribute nothing.
"""

from __future__ import annotations

import numpy as np


def _nondominated(pts: np.ndarray) -> np.ndarray:
    """Remove points weakly dominated by another (minimisation)."""
    n = len(pts)
    if n <= 1:
        return pts
    keep = np.ones(n, bool)
    for i in range(n):
        if not keep[i]:
            continue
        others = keep.copy()
        others[i] = False
        dom = (np.all(pts <= pts[i], axis=1)
               & np.any(pts < pts[i], axis=1) & others)
        if dom.any():
            keep[i] = False
    # drop exact duplicates, keep one copy
    uniq, idx = np.unique(pts[keep], axis=0, return_index=True)
    return uniq


def _hv2d(pts: np.ndarray, ref: np.ndarray) -> float:
    """Staircase: points sorted by f0 ascending have strictly descending
    f1 after nondominated filtering; sum the exclusive slabs."""
    order = np.argsort(pts[:, 0])
    pts = pts[order]
    f0 = np.append(pts[1:, 0], ref[0])
    return float(np.sum((f0 - pts[:, 0]) * (ref[1] - pts[:, 1])))


def _wfg(pts: np.ndarray, ref: np.ndarray) -> float:
    if len(pts) == 0:
        return 0.0
    if pts.shape[1] == 2:
        return _hv2d(pts, ref)
    if len(pts) == 1:
        return float(np.prod(ref - pts[0]))
    total = 0.0
    for i in range(len(pts)):
        p = pts[i]
        incl = float(np.prod(ref - p))
        rest = pts[i + 1:]
        if len(rest):
            limited = np.maximum(rest, p)
            limited = _nondominated(limited)
            total += incl - _wfg(limited, ref)
        else:
            total += incl
    return total


def hypervolume(points, ref) -> float:
    """Exact hypervolume of ``points`` (minimisation) w.r.t. ``ref``."""
    pts = np.asarray(points, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if pts.ndim != 2 or pts.shape[1] != ref.shape[0]:
        raise ValueError("points must be [n, d] with d == len(ref)")
    pts = pts[np.all(pts < ref, axis=1)]
    pts = _nondominated(pts)
    return _wfg(pts, ref)
