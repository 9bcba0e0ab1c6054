"""Persistent probe-winner cache for the dispatch tuner.

Port of :mod:`deap_tpu.tuning.cache`, a copy: one JSON document holding
every measured dispatch decision, stored next to the kernel build cache
(``support/compilecache.py``) so the two artifacts that make a process
warm-start — built kernel libraries and the dispatch choices that
select between them — live side by side and are wiped together.

Stdlib-only by design: ``telemetry/report.py`` renders the tuning
ledger without torch, and offline tooling (a human with ``python -m
json.tool``) must be able to read and edit the cache the same way. The
port keeps its own file under its own directory and never reads or
writes the JAX package's.

Entry shape (one per tuner key — see ``tuner.DispatchTuner.key_for``)::

    {
      "winner": "dc",                    # candidate name that measured fastest
      "timings": {"dc": 0.0021, ...},    # min-of-reps seconds per candidate
      "probe_s": 0.31,                   # wall cost of the whole probe
      "identity": "bitwise",             # how candidates were cross-checked
      "program": "nd_rank",              # observatory label for drift eviction
      "stamp": {"format": 1, "torch": "2.5.1", "cuda": "12.4"},
      "recorded_at": "2026-08-07T..",
    }

The file-level ``format`` stamp and the per-entry ``stamp`` implement
the invalidation ladder: a cache-format bump discards the whole file, a
torch or CUDA upgrade misses every old entry (the device type and name
are part of the *key*, so a new card simply probes fresh keys), and an
``hlo_drift`` alarm evicts the entries whose ``program`` launched other
kernels (``tuner.note_hlo_drift``).
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

#: bump to discard every existing cache file on format changes
CACHE_FORMAT = 1

#: directory override for the tuning cache (highest precedence)
ENV_DIR = "DEAP_TPU_TORCH_TUNING_CACHE"

FILENAME = "tuning_cache.json"


def default_dir() -> str:
    """Resolve the cache directory: ``$DEAP_TPU_TORCH_TUNING_CACHE``,
    else the enabled compile-cache directory (the "next to the compile
    cache" contract), else ``~/.cache/deap_tpu_torch``."""
    env = os.environ.get(ENV_DIR)
    if env:
        return env
    try:
        from deap_tpu_torch.support import compilecache
        path = compilecache.sibling_cache_dir()
        if path:
            return path
    except Exception:
        pass
    return os.path.join(os.path.expanduser("~"), ".cache", "deap_tpu_torch")


class TuningCache:
    """Atomic read-merge-write JSON store of probe winners.

    Writes go through a tempfile + ``os.replace`` so a crashed or
    concurrent process can never leave a torn file, and every ``put``
    re-reads the file first so two processes probing different knobs
    merge instead of clobbering (last writer wins per key, which is
    fine — both measured the same machine)."""

    def __init__(self, directory: Optional[str] = None):
        self.dir = str(directory) if directory else default_dir()
        self.path = os.path.join(self.dir, FILENAME)
        self._entries: Optional[Dict[str, Dict[str, Any]]] = None

    # -------------------------------------------------------------- read ----

    def _read_file(self) -> Dict[str, Dict[str, Any]]:
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("format") != CACHE_FORMAT:
            # unknown format: ignore rather than guess — the probe
            # protocol re-derives everything in one short pass
            return {}
        entries = doc.get("entries")
        return dict(entries) if isinstance(entries, dict) else {}

    def entries(self) -> Dict[str, Dict[str, Any]]:
        if self._entries is None:
            self._entries = self._read_file()
        return self._entries

    def refresh(self) -> None:
        """Drop the in-memory view; next access re-reads the file."""
        self._entries = None

    def get(self, key: str, stamp: Optional[Dict[str, Any]] = None
            ) -> Optional[Dict[str, Any]]:
        entry = self.entries().get(key)
        if entry is None:
            return None
        if stamp is not None and entry.get("stamp") != stamp:
            return None
        return entry

    # ------------------------------------------------------------- write ----

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        merged = self._read_file()
        merged.update(self.entries())
        merged[str(key)] = dict(entry)
        self._entries = merged
        self._write(merged)

    def evict(self, keys) -> List[str]:
        """Remove ``keys`` (those present); returns the evicted list."""
        merged = self._read_file()
        merged.update(self.entries())
        gone = [k for k in keys if merged.pop(k, None) is not None]
        self._entries = merged
        if gone:
            self._write(merged)
        return gone

    def evict_program(self, program: str) -> List[str]:
        """Evict every entry recorded against observatory label
        ``program`` — the ``hlo_drift`` invalidation path."""
        entries = self.entries()
        stale = [k for k, e in entries.items()
                 if e.get("program") == program]
        return self.evict(stale)

    def clear(self) -> None:
        self._entries = {}
        try:
            os.remove(self.path)
        except OSError:
            pass

    def _write(self, entries: Dict[str, Dict[str, Any]]) -> None:
        doc = {
            "format": CACHE_FORMAT,
            "updated_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "entries": entries,
        }
        os.makedirs(self.dir, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=self.dir, prefix=".tuning.",
                                   suffix=".json")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
