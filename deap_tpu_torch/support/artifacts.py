"""Kernel-library artifact store — the build side of cold start.

Port of :mod:`deap_tpu.support.artifacts`. The JAX package persists
loaded XLA executables; the port's loaded executable is a built kernel
library, the ``lib<name>-<hash>.so`` that ``nvcc`` makes from
``csrc/<name>.cu``. The build cache (:mod:`~deap_tpu_torch.support.
compilecache`) keeps libraries in one build directory; this store keeps
them, checked, for any number of build directories: a process that
starts with an empty build directory copies a library in from the store
instead of running ``nvcc``.

This module is the sibling cache of the build cache: one directory
holding

- ``artifact_manifest.json`` — a **stdlib-only** JSON manifest mapping
  artifact keys to blob files, with a CRC32 and the environment stamps
  (card name, compute capability, ``nvcc`` version, torch version) that
  gate reuse. Atomic read-merge-write like the tuning cache, so
  concurrent processes merge instead of clobbering.
- ``<key>.so`` blob files — the libraries themselves, byte for byte.

Keying: ``(card name, compute capability, nvcc version, torch version,
source hash)``, the source hash being ``_build.py``'s hash of the
kernel's source, the shared headers and the flags. Any other card,
toolkit, torch or source misses and falls through to a fresh build.
Every consult is journaled (``artifact_hit`` / ``artifact_miss``) so a
restart's cold-start economics are attributable from the journal alone.

Fallback contract: any failure — torn blob, CRC mismatch, stamp
mismatch, unreadable file — is a journaled miss, and the caller builds
the same source it would have built with no store active. Results are
bit-identical either way (the stored library IS the built one). The
module imports only the standard library; the stamp imports torch when
it is first needed.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, Optional

__all__ = ["ExecutableArtifactStore", "active_store",
           "enable_artifact_store", "disable_artifact_store",
           "default_dir", "ARTIFACT_JOURNAL_KINDS"]

#: the environment opt-in (mirrors DEAP_TPU_TORCH_COMPILE_CACHE)
ENV_VAR = "DEAP_TPU_TORCH_ARTIFACT_CACHE"

#: manifest file-format stamp; bump on layout changes (readers skip
#: unknown formats rather than guessing)
MANIFEST_FORMAT = 1

#: journal kinds this module writes (the health report's startup ledger
#: tallies them)
ARTIFACT_JOURNAL_KINDS = ("artifact_hit", "artifact_miss")

MANIFEST_NAME = "artifact_manifest.json"

#: the fields of an entry that must equal this process's stamp
STAMP_FIELDS = ("device", "capability", "nvcc", "torch")

#: the active store — one slot, module-global (the build seam that
#: consults it is far from whoever enabled it)
_ACTIVE: list = [None]


def active_store() -> Optional["ExecutableArtifactStore"]:
    """The currently active artifact store, or None."""
    return _ACTIVE[0]


def default_dir() -> str:
    """Where the store lives when the caller names no path:
    ``$DEAP_TPU_TORCH_ARTIFACT_CACHE``, else an ``artifacts/`` directory
    INSIDE the enabled build cache (sibling artifacts live — and are
    wiped — together), else ``~/.cache/deap_tpu_torch/artifacts``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    from deap_tpu_torch.support.compilecache import sibling_cache_dir
    sib = sibling_cache_dir()
    if sib is not None:
        return os.path.join(sib, "artifacts")
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "deap_tpu_torch", "artifacts")


def _broadcast(kind: str, **payload: Any) -> None:
    try:
        from deap_tpu_torch.telemetry.journal import broadcast
        broadcast(kind, **payload)
    except Exception:
        pass


def _env_stamp() -> Dict[str, str]:
    """The reuse gate: a kernel library is built for one card, toolkit
    and torch, so entries written under any other are skipped, never
    loaded."""
    import torch

    from deap_tpu_torch import _build

    if torch.cuda.is_available():
        device = torch.cuda.get_device_name(0)
        capability = "%d.%d" % torch.cuda.get_device_capability(0)
    else:
        device, capability = "cpu", "none"
    return {"device": str(device), "capability": capability,
            "nvcc": _build.nvcc_version(), "torch": torch.__version__}


def _slug(text: str, width: int = 40) -> str:
    return "".join(c if c.isalnum() or c == "." else "-"
                   for c in str(text))[:width]


class ExecutableArtifactStore:
    """One artifact directory: manifest + kernel-library blobs.

    Thread-safe (one lock around manifest state); safe across processes
    (atomic read-merge-write puts). Constructing a store, or reading its
    manifest, imports nothing beyond the standard library.
    """

    def __init__(self, directory: str):
        self.directory = os.path.abspath(os.path.expanduser(
            str(directory)))
        os.makedirs(self.directory, exist_ok=True)
        self.manifest_path = os.path.join(self.directory, MANIFEST_NAME)
        self._lock = threading.Lock()
        self._entries: Dict[str, Dict[str, Any]] = self._read_manifest()
        self._stamp: Optional[Dict[str, str]] = None
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------- manifest ----

    def _read_manifest(self) -> Dict[str, Dict[str, Any]]:
        """Tolerant read: a missing, torn, or foreign-format manifest is
        an empty store, never an exception."""
        try:
            with open(self.manifest_path, "r") as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) \
                or doc.get("format") != MANIFEST_FORMAT:
            return {}
        entries = doc.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def _write_manifest(self, entries: Dict[str, Dict[str, Any]]) -> None:
        doc = {"format": MANIFEST_FORMAT, "entries": entries}
        fd, tmp = tempfile.mkstemp(dir=self.directory,
                                   suffix=".manifest.tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, sort_keys=True, indent=1)
            os.replace(tmp, self.manifest_path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def _merge_put(self, key: str, entry: Dict[str, Any]) -> None:
        """Read-merge-write: re-read the file under the lock, fold the
        new entry in, replace atomically — two processes writing
        different keys both survive."""
        with self._lock:
            on_disk = self._read_manifest()
            on_disk.update(self._entries)
            on_disk[key] = entry
            self._entries = on_disk
            self._write_manifest(on_disk)

    # ----------------------------------------------------------- keys ----

    def stamp(self) -> Dict[str, str]:
        with self._lock:
            if self._stamp is None:
                self._stamp = _env_stamp()
            return dict(self._stamp)

    def key_for(self, hlo_hash: str) -> str:
        """The artifact key of the library whose source hash is
        ``hlo_hash`` (the JAX package's name for the program
        fingerprint) under this process's stamp."""
        s = self.stamp()
        return "-".join(_slug(s[f]) for f in STAMP_FIELDS) + "-" + _slug(
            hlo_hash)

    def _blob_path(self, key: str) -> str:
        return os.path.join(self.directory, key + ".so")

    # ------------------------------------------------------- get / put ----

    def get(self, label: str, hlo_hash: str) -> Optional[bytes]:
        """The library bytes for ``hlo_hash`` under the current stamp,
        CRC-checked, or ``None`` (journaled ``artifact_miss`` with the
        reason) — the caller then builds, bit-identically."""
        t0 = time.perf_counter()
        key = self.key_for(hlo_hash)
        with self._lock:
            entry = self._entries.get(key)
        if entry is None:
            # another process may have written since we read the manifest
            with self._lock:
                fresh = self._read_manifest()
                fresh.update({k: v for k, v in self._entries.items()
                              if k not in fresh})
                self._entries = fresh
                entry = self._entries.get(key)
        reason = None
        if entry is None:
            reason = "absent"
        else:
            stamp = self.stamp()
            if any(entry.get(f) != stamp[f] for f in STAMP_FIELDS):
                reason = "stamp_mismatch"
        blob = None
        if reason is None:
            blob, reason = self._load(entry)
        if blob is None:
            self.misses += 1
            _broadcast("artifact_miss", label=str(label),
                       hlo_hash=str(hlo_hash), reason=reason)
            return None
        self.hits += 1
        _broadcast("artifact_hit", label=str(label),
                   hlo_hash=str(hlo_hash),
                   deserialize_s=round(time.perf_counter() - t0, 6),
                   bytes=len(blob))
        return blob

    def _load(self, entry: Dict[str, Any]):
        """(bytes, None) or (None, reason)."""
        path = os.path.join(self.directory,
                            os.path.basename(str(entry.get("file", ""))))
        try:
            with open(path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return None, "read_error"
        if zlib.crc32(raw) != entry.get("crc"):
            return None, "crc_mismatch"
        return raw, None

    def put(self, label: str, hlo_hash: str, compiled: Any) -> bool:
        """Persist one freshly built library (``compiled``: its path, or
        its bytes). Best-effort: an unreadable library or a full disk is
        skipped — the store only ever removes future builds, never adds
        failure modes to the run that populated it."""
        try:
            if isinstance(compiled, (bytes, bytearray)):
                payload = bytes(compiled)
            else:
                with open(compiled, "rb") as fh:
                    payload = fh.read()
            key = self.key_for(hlo_hash)
        except Exception:
            return False
        path = self._blob_path(key)
        try:
            fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".so.tmp")
            with os.fdopen(fd, "wb") as fh:
                fh.write(payload)
            os.replace(tmp, path)
        except OSError:
            return False
        entry = dict(self.stamp())
        entry.update(file=os.path.basename(path),
                     crc=zlib.crc32(payload), bytes=len(payload),
                     hlo_hash=str(hlo_hash), label=str(label))
        self._merge_put(key, entry)
        return True

    def copy_in(self, label: str, hlo_hash: str, target: str) -> bool:
        """On a hit, write the library to ``target`` (atomically) and
        return True; on a miss return False (journaled by :meth:`get`)."""
        blob = self.get(label, hlo_hash)
        if blob is None:
            return False
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(str(target)),
                                   suffix=".so.tmp")
        try:
            with os.fdopen(fd, "wb") as fh:
                fh.write(blob)
            os.replace(tmp, target)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True

    # ------------------------------------------------------ lifecycle ----

    def activate(self) -> "ExecutableArtifactStore":
        """Install as the process-wide active store (the build seam
        consults the active slot at build time)."""
        self._prev = _ACTIVE[0]
        _ACTIVE[0] = self
        return self

    def deactivate(self) -> None:
        if _ACTIVE[0] is self:
            _ACTIVE[0] = getattr(self, "_prev", None)
        self._prev = None


def enable_artifact_store(path: Optional[str] = None
                          ) -> ExecutableArtifactStore:
    """Create (or reuse) the store at ``path`` (default:
    :func:`default_dir`) and activate it. Idempotent: re-enabling the
    already-active directory returns the live store."""
    resolved = os.path.abspath(os.path.expanduser(
        str(path or default_dir())))
    cur = _ACTIVE[0]
    if cur is not None and cur.directory == resolved:
        return cur
    return ExecutableArtifactStore(resolved).activate()


def disable_artifact_store() -> None:
    """Deactivate the current store."""
    cur = _ACTIVE[0]
    if cur is not None:
        cur.deactivate()
