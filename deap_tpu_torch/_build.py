"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, ``build/deap_tpu_torch/lib<name>-<hash>.so``
under the checkout root, and loaded with ``ctypes``. The hash covers the
sources and the flags, so an edited kernel is rebuilt and a stale one is
never loaded. Builds happen at first use (or all at once, in parallel,
through :func:`build`); nothing is compiled when a module is imported.
``nvcc``'s register and spill report is kept beside each library as
``.log``. Each ``nvcc`` build that runs is reported to the open run
journals as a ``compile`` row (:func:`deap_tpu_torch.telemetry.journal.
compile_observed`) and counted in :data:`COMPILE_SECONDS`. The host
libraries of :mod:`deap_tpu_torch.native` are built the same way by the
host's ``g++`` (:func:`host_library`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "deap_tpu_torch"
SOURCES = ("fused_variation", "packed_variation", "selgather_packed",
           "dominance", "fused_variation_eval", "fused_variation_real",
           "evolve_packed", "gp_grouped", "jacobi_eigh", "ant_rollout",
           "nd_scan", "cartpole_rollout")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: seconds of ``nvcc`` builds this process ran, summed (a one-element list
#: so readers see the updates)
COMPILE_SECONDS = [0.0]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return nvcc


def source_hash(name: str) -> str:
    """The hash of ``csrc/<name>.cu``, the shared headers and the flags
    that names its build."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


def _target(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{source_hash(name)}.so"


def loaded_hashes() -> Dict[str, str]:
    """``{library: source_hash}`` of every kernel library loaded so far."""
    with _LOCK:
        names = sorted(_LIBS)
    return {name: source_hash(name) for name in names}


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns each build's seconds (0 for a
    library already built); raises with the compiler's output if any
    build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    started, seconds = {}, {}
    for name in names:
        target = _target(name)
        if target.exists():
            seconds[name] = 0.0
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target, time.perf_counter())
    failures = []
    for name, (proc, tmp, target, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)
        COMPILE_SECONDS[0] += seconds[name]
        from deap_tpu_torch.telemetry.journal import compile_observed
        compile_observed(name, seconds[name])
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output for the current build of ``name``."""
    return _target(name).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            lib.dtt_error_string.argtypes = [INT]
            lib.dtt_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def function(lib_name: str, fn_name: str, argtypes: Sequence):
    """A launcher of the library with its ``argtypes`` declared; every
    launcher returns ``cudaGetLastError()`` as an int."""
    fn = getattr(library(lib_name), fn_name)
    fn.argtypes = list(argtypes)
    fn.restype = INT
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    """Raise when a launcher reports a CUDA error (a refused launch never
    runs, and a later synchronise would not report it)."""
    if err:
        msg = library(lib_name).dtt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


_HOST_LIBS: Dict[Path, ctypes.CDLL] = {}


def _native_target_flags() -> bytes:
    """What ``-march=native`` resolves to on this host (a library built
    for another host's CPU may not run here)."""
    out = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, check=True)
    return out.stdout


def host_target(src: Path, stem: str, flags: Sequence[str]) -> Path:
    """Where :func:`host_library` keeps the build of ``src``:
    ``BUILD_DIR/lib<stem>-<hash>.so``, the hash over the flags (and, with
    ``-march=native``, what they resolve to here) and the source."""
    digest = hashlib.sha256(" ".join(flags).encode())
    if "-march=native" in flags:
        digest.update(_native_target_flags())
    digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{stem}-{digest.hexdigest()[:16]}.so"


def host_library(src: Path, stem: str, flags: Sequence[str]) -> ctypes.CDLL:
    """The loaded host library of the C++ source ``src``, built with
    ``g++ flags`` on first use (:func:`host_target`)."""
    with _LOCK:
        lib = _HOST_LIBS.get(src)
        if lib is not None:
            return lib
        target = host_target(src, stem, flags)
        if not target.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            out = subprocess.run(["g++", *flags, str(src), "-o", str(tmp)],
                                 capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(f"g++ failed for {src}:\n{out.stderr}")
            os.replace(tmp, target)
        lib = _HOST_LIBS[src] = ctypes.CDLL(str(target))
        return lib
