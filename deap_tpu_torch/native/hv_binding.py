"""The native exact hypervolume on the host.

``src/hv.cpp`` (the JAX package's C++ hypervolume, copied) is built by
the host's ``g++`` at first use into ``build/deap_tpu_torch/`` with the
JAX package's flags (``-O3 -march=native``: the same contractions, so
the same bits), the library's name keyed on a hash of its source, its
flags and what ``-march=native`` resolves to on this host, and loaded
with ctypes. :mod:`deap_tpu_torch.native` picks it, and falls back to
the pure-Python WFG with a warning where it does not build.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from deap_tpu_torch._build import host_library, host_target

SRC = Path(__file__).resolve().parent / "src" / "hv.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_F64P = ctypes.POINTER(ctypes.c_double)


def _target() -> Path:
    return host_target(SRC, "hv", GXX_FLAGS)


def library() -> ctypes.CDLL:
    """The loaded library, built with ``g++`` on first use."""
    lib = host_library(SRC, "hv", GXX_FLAGS)
    lib.dtt_hypervolume.restype = ctypes.c_double
    lib.dtt_hypervolume.argtypes = [_F64P, ctypes.c_int, ctypes.c_int,
                                    _F64P]
    lib.dtt_hv_contributions.restype = None
    lib.dtt_hv_contributions.argtypes = [_F64P, ctypes.c_int, ctypes.c_int,
                                         _F64P, _F64P]
    return lib


def _as_c(points, ref):
    host = lambda a: a.detach().cpu().numpy() if hasattr(a, "detach") else a
    pts = np.ascontiguousarray(host(points), dtype=np.float64)
    r = np.ascontiguousarray(host(ref), dtype=np.float64)
    if pts.ndim != 2 or r.ndim != 1 or pts.shape[1] != r.shape[0]:
        raise ValueError("points must be [n, d] with d == len(ref)")
    return pts, r


def hypervolume(points, ref) -> float:
    """Exact hypervolume (minimisation) of ``points`` ``[n, d]`` with
    respect to ``ref``; numpy arrays or tensors (copied to the host)."""
    pts, r = _as_c(points, ref)
    n, d = pts.shape
    return float(library().dtt_hypervolume(
        pts.ctypes.data_as(_F64P), n, d, r.ctypes.data_as(_F64P)))


def hv_contributions(points, ref) -> np.ndarray:
    """Each point's exclusive (leave-one-out) hypervolume contribution,
    ``float64[n]``."""
    pts, r = _as_c(points, ref)
    n, d = pts.shape
    out = np.empty(n, dtype=np.float64)
    library().dtt_hv_contributions(
        pts.ctypes.data_as(_F64P), n, d, r.ctypes.data_as(_F64P),
        out.ctypes.data_as(_F64P))
    return out
