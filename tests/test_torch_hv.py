"""The port's native hypervolume (its copy of the JAX package's C++ WFG,
built by ``g++`` at first use) against the JAX package's native library
and the pure-Python WFG, on the CPU.

- ``hypervolume`` and ``hv_contributions`` bitwise against
  ``deap_tpu.native``'s on the same points (both built with ``-O3
  -march=native``), d 2-6, with duplicates, dominated points and points
  beyond the reference.
- Within 1e-12 relative of the port's pure-Python ``pyhv`` (another
  summation order).
- ``HAVE_NATIVE_HV`` holds, ``benchmarks.tools.hypervolume`` runs the
  native library, and the fallback warns and gives the pure values.
"""

import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from deap_tpu import native as jnative
from deap_tpu.benchmarks import tools as jtools
from deap_tpu_torch import native as tnative
from deap_tpu_torch.benchmarks import tools as ttools
from deap_tpu_torch.native import hv_binding, pyhv


def _points(seed, n, d):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, d))
    if n >= 8:
        pts[1] = pts[0]                  # a duplicate
        pts[2] = pts[0] + 0.01           # dominated by row 0
        pts[3, 0] = 1.5                  # beyond the reference
    return pts


SHAPES = [(1, 2), (8, 2), (300, 2), (8, 3), (200, 3), (60, 4), (30, 5),
          (12, 6)]


@pytest.mark.parametrize("n,d", SHAPES, ids=[f"n{n}d{d}" for n, d in SHAPES])
def test_native_equals_the_jax_native_bitwise(n, d):
    pts, ref = _points(n * 10 + d, n, d), np.full(d, 1.1)
    assert tnative.hypervolume(pts, ref) == jnative.hypervolume(pts, ref)
    got = tnative.hv_contributions(pts, ref)
    assert got.dtype == np.float64
    assert got.tobytes() == np.asarray(jnative.hv_contributions(
        pts, ref)).tobytes()


@pytest.mark.parametrize("n,d", [(8, 2), (40, 2), (8, 3), (25, 3), (12, 4)])
def test_native_within_1e12_of_pyhv(n, d):
    pts, ref = _points(n + d, n, d), np.full(d, 1.1)
    want = pyhv.hypervolume(pts, ref)
    assert abs(tnative.hypervolume(pts, ref) - want) <= 1e-12 * abs(want)
    contrib = tnative.hv_contributions(pts, ref)
    loo = np.asarray([want - pyhv.hypervolume(np.delete(pts, i, 0), ref)
                      for i in range(n)])
    assert np.all(np.abs(contrib - loo) <= 1e-12 * abs(want))


def test_native_is_built_and_used():
    assert tnative.HAVE_NATIVE_HV
    target = hv_binding._target()
    assert target.exists() and target.name.startswith("libhv-")
    pts = torch.rand(50, 2, generator=torch.Generator().manual_seed(3))
    ref = [1.1, 1.1]
    assert tnative.hypervolume(pts, ref) == hv_binding.hypervolume(
        pts.numpy(), ref)
    w = -pts.numpy()   # maximisation values, as the metric takes them
    assert ttools.hypervolume(w, ref, weights=[1.0, 1.0]) == \
        jtools.hypervolume(w, ref, weights=[1.0, 1.0])


def test_fallback_warns_and_gives_the_pure_values(monkeypatch):
    monkeypatch.setattr(tnative, "_NATIVE", None)
    monkeypatch.setattr(hv_binding, "library", lambda: 1 / 0)
    pts, ref = _points(5, 10, 3), np.full(3, 1.1)
    with pytest.warns(UserWarning, match="pure-Python"):
        assert not tnative.HAVE_NATIVE_HV
    assert tnative.hypervolume(pts, ref) == pyhv.hypervolume(pts, ref)
    got = tnative.hv_contributions(pts, ref)
    want = jnative.hv_contributions(pts, ref)
    assert np.all(np.abs(got - want) <= 1e-12 * pyhv.hypervolume(pts, ref))


def test_native_refuses_mismatched_shapes():
    with pytest.raises(ValueError):
        tnative.hypervolume(np.ones((3, 2)), np.ones(3))


def test_this_slice_imports_without_jax():
    """The native hypervolume, the benchmark modules and the scans stand
    alone: importing and running them loads neither jax nor the JAX
    package."""
    script = textwrap.dedent("""
        import sys
        import numpy as np
        import torch
        from deap_tpu_torch import native
        from deap_tpu_torch.benchmarks import binary, gp, tools
        from deap_tpu_torch.mo import emo, ndsort
        assert native.HAVE_NATIVE_HV
        assert native.hypervolume(np.random.rand(20, 3), [1.1] * 3) > 0
        x = torch.rand(50, 3)
        assert tools.igd(x, x) == 0.0
        assert binary.trap(x > 0.5).shape == (50, 1)
        assert gp.ripple(x).shape == (50,)
        assert ndsort.nd_rank_sweep3(x).shape == (50,)
        assert emo.nd_rank_staircase(x[:, :2]).shape == (50,)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
    """)
    root = pathlib.Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", script], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
