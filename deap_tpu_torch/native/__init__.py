"""Host-side helpers of the port: the exact hypervolume.

``hypervolume`` and ``hv_contributions`` run the native C++ library
(:mod:`.hv_binding`), which the host's ``g++`` builds at first use.
Where it does not build they fall back to the pure-Python WFG
(:mod:`.pyhv`) with a warning, and ``HAVE_NATIVE_HV`` is False: the JAX
package's contract (``deap_tpu.native``), settled at first use rather
than at import.
"""

import warnings

import numpy as np

from deap_tpu_torch.native import pyhv

__all__ = ["hypervolume", "hv_contributions", "HAVE_NATIVE_HV"]

_NATIVE = None


def _native():
    """The native binding once it has built and loaded, else False."""
    global _NATIVE
    if _NATIVE is None:
        try:
            from deap_tpu_torch.native import hv_binding
            hv_binding.library()
            _NATIVE = hv_binding
        except Exception as exc:  # the JAX package's fallback contract
            _NATIVE = False
            warnings.warn(
                f"Native hypervolume library did not build ({exc!r}); using "
                f"the pure-Python WFG fallback (slow for large fronts).")
    return _NATIVE


def hypervolume(points, ref) -> float:
    """Exact hypervolume (minimisation) of ``points`` ``[n, d]`` with
    respect to ``ref``."""
    native = _native()
    if native:
        return native.hypervolume(points, ref)
    return pyhv.hypervolume(points, ref)


def hv_contributions(points, ref) -> np.ndarray:
    """Each point's exclusive (leave-one-out) hypervolume contribution."""
    native = _native()
    if native:
        return native.hv_contributions(points, ref)
    pts = np.asarray(points, dtype=np.float64)
    total = pyhv.hypervolume(pts, ref)
    return np.asarray([
        total - pyhv.hypervolume(np.delete(pts, i, axis=0), ref)
        for i in range(pts.shape[0])])


def __getattr__(name):
    if name == "HAVE_NATIVE_HV":
        return bool(_native())
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
