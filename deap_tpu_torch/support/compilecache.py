"""Persistent kernel build cache — cold-start economics.

Port of :mod:`deap_tpu.support.compilecache`. The port's compiled
programs are its kernel libraries: ``_build.py`` compiles each
``csrc/<name>.cu`` with ``nvcc`` into ``lib<name>-<hash>.so``, the hash
over the sources and the flags, and loads a library already there
without running ``nvcc``. :func:`enable` points those builds at a
directory of the caller's choice, so a second process (or a second
machine sharing the directory) loads every library at once instead of
paying ``nvcc`` again; an edited kernel has another hash and is built
anew, never loaded stale.

Opt-in only: the cache trades disk for latency and changes no computed
result, but a shared default directory could mix builds of unrelated
checkouts — so nothing is enabled unless the caller (or the environment
variable, through :func:`enable_from_env`) asks.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional

#: the environment opt-in (:func:`enable_from_env`)
ENV_VAR = "DEAP_TPU_TORCH_COMPILE_CACHE"

#: the directory the programmatic opt-in resolved to (None = not enabled
#: through this module)
_enabled_path: Optional[str] = None


def enabled_path() -> Optional[str]:
    """Where the cache currently points (via this module), or None."""
    return _enabled_path


def enable(path: str, min_compile_time_secs: float = 0.0) -> str:
    """Point the kernel builds (:data:`deap_tpu_torch._build.BUILD_DIR`)
    at ``path`` (created if missing): libraries built from now on go
    there, and one already there is loaded with no ``nvcc`` run.
    ``min_compile_time_secs`` is accepted for the JAX package's
    signature; every build is kept (a kernel library is never too cheap
    to keep). Libraries this process already loaded stay loaded."""
    del min_compile_time_secs
    from deap_tpu_torch import _build

    path = os.path.abspath(os.path.expanduser(str(path)))
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    global _enabled_path
    _enabled_path = path
    return path


def enable_compile_cache(path: Optional[str] = None,
                         min_compile_time_secs: float = 0.0) -> str:
    """The programmatic opt-in: point the kernel build cache at ``path``
    — default ``$DEAP_TPU_TORCH_COMPILE_CACHE``, else
    ``~/.cache/deap_tpu_torch/kernels`` — and journal a
    ``compile_cache`` event into any open run journal. Idempotent:
    re-enabling the same directory is a no-op. Returns the resolved
    path."""
    if path is None:
        path = os.environ.get(ENV_VAR) or os.path.join(
            os.path.expanduser("~"), ".cache", "deap_tpu_torch", "kernels")
    resolved = os.path.abspath(os.path.expanduser(str(path)))
    if _enabled_path == resolved:
        return resolved
    resolved = enable(resolved,
                      min_compile_time_secs=min_compile_time_secs)
    from deap_tpu_torch.telemetry.journal import broadcast
    broadcast("compile_cache", path=resolved)
    return resolved


def sibling_cache_dir() -> Optional[str]:
    """Directory for the sibling caches that should live — and be wiped
    — together with the built libraries: the dispatch tuning cache
    (:mod:`deap_tpu_torch.tuning`) stores its probe winners here when
    the build cache is enabled, and the artifact store
    (:mod:`deap_tpu_torch.support.artifacts`) defaults its directory
    under here too. None when the build cache is not enabled through
    this module."""
    return _enabled_path


def enable_artifact_cache(path: Optional[str] = None):
    """Enable the kernel-library artifact store (thin delegation to
    :func:`deap_tpu_torch.support.artifacts.enable_artifact_store`):
    by default it lives inside the enabled build cache. Returns the
    active :class:`~deap_tpu_torch.support.artifacts.
    ExecutableArtifactStore`."""
    from deap_tpu_torch.support.artifacts import enable_artifact_store
    return enable_artifact_store(path)


def enable_from_env(var: str = ENV_VAR) -> Optional[str]:
    """Enable the cache iff ``$DEAP_TPU_TORCH_COMPILE_CACHE`` names a
    directory; returns the resolved path (or ``None``)."""
    path = os.environ.get(var)
    if not path:
        return None
    return enable(path)
