"""The native ant simulator, a host evaluator that a caller picks.

``src/ant.cpp`` (the JAX package's native simulator, copied) is built by
the host's ``g++`` at first use into ``build/deap_tpu_torch/``, the
library's name keyed on a hash of its source and flags as
:mod:`deap_tpu_torch._build` keys the kernels, and loaded with ctypes.
It evaluates on the host; nothing falls back to it. On the card the ant
runs through J2 (:func:`deap_tpu_torch.gp.ant.ant_rollout`), and the
tests and ``chip_smoke.py`` hold the two equal.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from deap_tpu_torch._build import BUILD_DIR  # noqa: F401 (where it builds)
from deap_tpu_torch._build import host_library, host_target

SRC = Path(__file__).resolve().parent / "src" / "ant.cpp"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_I32P = ctypes.POINTER(ctypes.c_int32)


def _target() -> Path:
    return host_target(SRC, "ant", GXX_FLAGS)


def library() -> ctypes.CDLL:
    """The loaded simulator, built with ``g++`` on first use."""
    lib = host_library(SRC, "ant", GXX_FLAGS)
    lib.dtt_ant_eval.restype = None
    lib.dtt_ant_eval.argtypes = [
        _I32P, _I32P, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _I32P]
    return lib


def ant_eval(nodes, lengths, trail, start, max_moves: int = 600,
             start_dir: int = 1) -> np.ndarray:
    """Food eaten by each ant tree, simulated on the host.

    :param nodes: ``int32 [pop, max_len]`` prefix node arrays
        (:func:`deap_tpu_torch.gp.ant.ant_pset` encoding); numpy or a
        tensor (copied to the host).
    :param lengths: ``int32 [pop]``.
    :param trail: ``bool [rows, cols]`` food map.
    :param start: ``(row, col)`` start cell.
    :returns: ``int32 [pop]``.
    """
    host = lambda a, dt: np.ascontiguousarray(
        a.detach().cpu().numpy() if hasattr(a, "detach") else a, dt)
    nodes, lengths = host(nodes, np.int32), host(lengths, np.int32)
    trail8 = host(trail, np.uint8)
    pop, max_len = nodes.shape
    out = np.zeros((pop,), np.int32)
    library().dtt_ant_eval(
        nodes.ctypes.data_as(_I32P), lengths.ctypes.data_as(_I32P),
        pop, max_len,
        trail8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        trail8.shape[0], trail8.shape[1], max_moves,
        int(start[0]), int(start[1]), start_dir,
        out.ctypes.data_as(_I32P))
    return out
