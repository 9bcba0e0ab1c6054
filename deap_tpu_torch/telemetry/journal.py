"""Run journal — structured JSONL host events for a whole run.

Port of :mod:`deap_tpu.telemetry.journal`: one append-only JSONL file
per run, each line ``{"t": <secs since open>, "kind": ..., ...}``, with
the same row kinds, so a reader of the JAX package's journals reads the
port's. ``t`` deltas come from the monotonic clock; the wall-clock
epoch of the open is the header's ``wall_start``. Kinds written here:

- ``header`` — torch / CUDA version, device name and count, plus an
  optional toolbox fingerprint.
- ``compile`` / ``retrace`` — every ``nvcc`` build of a kernel library
  that ran while the journal was open (:func:`deap_tpu_torch._build.
  build` reports each, never a library already built): ``dur_s``,
  ``seq`` and the library's name. Builds after :meth:`RunJournal.
  mark_steady` are journaled as ``retrace`` rows, with ``after``.
- ``meter`` — per-generation metric rows decoded from a
  :class:`~deap_tpu_torch.telemetry.meter.Meter`'s stacked states.
- ``span`` — per-name wall-time aggregates from a
  :class:`~deap_tpu_torch.support.profiling.SpanRecorder`.
- event kinds from subsystems (checkpoints, the resilient engine, the
  quarantine wrapper, the GP dispatchers) through
  :meth:`RunJournal.event` or the module-level :func:`broadcast`, which
  reaches every open journal.
- ``summary`` — a final roll-up, with ``n_compiles`` and
  ``n_retraces``.

This module imports only the standard library (``torch`` inside
:func:`environment_fingerprint`), so the report loads it by path.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["RunJournal", "JournalRows", "read_journal", "broadcast",
           "toolbox_fingerprint", "environment_fingerprint",
           "journal_generations", "listening", "compile_observed"]

_LOCK = threading.Lock()
_ACTIVE: List["RunJournal"] = []


def listening() -> bool:
    """Whether any journal is open — code that must pay (a host
    synchronise) to report an event asks this first."""
    with _LOCK:
        return bool(_ACTIVE)


def compile_observed(library: str, seconds: float) -> None:
    """Report one finished kernel build (``nvcc`` of ``library``, taking
    ``seconds``) to every open journal: the port's counterpart of the
    JAX package's ``jax.monitoring`` compile listener."""
    with _LOCK:
        journals = list(_ACTIVE)
    for j in journals:
        j._compile_observed(seconds, library)


def broadcast(kind: str, **payload: Any) -> None:
    """Write an event into every currently-open journal. For subsystem
    code (checkpointing, the quarantine wrapper) that should surface
    events when a journal happens to be open but must not depend on one
    being passed in."""
    with _LOCK:
        journals = list(_ACTIVE)
    for j in journals:
        j.event(kind, **payload)


def toolbox_fingerprint(toolbox: Any) -> Dict[str, Any]:
    """Which operators a toolbox binds, and a stable digest of the
    configuration — so journals from different runs are comparable."""
    aliases: Dict[str, str] = {}
    for name, val in sorted(vars(toolbox).items()):
        func = getattr(val, "func", val)
        bound = ""
        args = getattr(val, "args", ())
        kwargs = getattr(val, "keywords", {}) or {}
        if args or kwargs:
            bound = repr((args, tuple(sorted(kwargs.items()))))
        aliases[name] = "%s.%s%s" % (
            getattr(func, "__module__", "?"),
            getattr(func, "__name__", "?"), bound)
    digest = hashlib.sha1(
        json.dumps(aliases, sort_keys=True).encode()).hexdigest()[:12]
    return {"aliases": aliases, "digest": digest}


def environment_fingerprint(init_backend: bool = True) -> Dict[str, Any]:
    """torch and CUDA versions, the backend, the device's name and count.
    ``init_backend=False`` skips the device query (it initialises the
    CUDA driver)."""
    import torch

    fp: Dict[str, Any] = {"torch": torch.__version__,
                          "cuda": torch.version.cuda}
    if not init_backend:
        return fp
    try:
        if torch.cuda.is_available():
            fp["backend"] = "cuda"
            fp["device_kind"] = torch.cuda.get_device_name(0)
            fp["n_devices"] = torch.cuda.device_count()
        else:
            fp["backend"] = "cpu"
            fp["n_devices"] = 1
        fp["process_count"] = 1
    except Exception as e:  # the CUDA driver failed: still a journal
        fp["backend_error"] = repr(e)[:200]
    return fp


class RunJournal:
    """Append-only JSONL journal for one run::

        with RunJournal("run.jsonl") as journal:
            journal.header(toolbox=tb)
            ... run ...
            journal.summary(gens=100)
    """

    def __init__(self, path: str, run_id: Optional[str] = None,
                 fsync_every: Optional[int] = None):
        """``fsync_every=n`` fsyncs the file every n-th row, so a killed
        run loses at most n-1 rows (flush alone can lose the OS-buffered
        tail). :func:`read_journal` tolerates the torn last line a kill
        mid-``write`` leaves."""
        self.path = str(path)
        self.run_id = run_id or hex(int(time.time() * 1e6))[2:]
        self.fsync_every = int(fsync_every) if fsync_every else None
        self._rows_since_sync = 0
        self._t0 = time.monotonic()
        self.wall_start = time.time()
        # rows arrive from the main thread and from the checkpoint
        # writer's thread: one lock keeps lines whole
        self._write_lock = threading.Lock()
        # a restart over the same path keeps the previous journal: a
        # non-empty predecessor moves to `<path>.N` (next free integer)
        self.rotated_from: Optional[str] = None
        try:
            if os.path.getsize(self.path) > 0:
                n = 1
                while os.path.exists("%s.%d" % (self.path, n)):
                    n += 1
                self.rotated_from = "%s.%d" % (self.path, n)
                os.replace(self.path, self.rotated_from)
        except OSError:
            pass
        self._fh = open(self.path, "w")
        self._steady: Optional[str] = None
        self.n_compiles = 0
        self.n_retraces = 0
        self._closed = False
        with _LOCK:
            _ACTIVE.append(self)

    def _write(self, kind: str, payload: Dict[str, Any]) -> None:
        if self._closed:
            return
        line = {"t": round(time.monotonic() - self._t0, 6), "kind": kind}
        line.update(payload)
        with self._write_lock:
            if self._closed:
                return
            self._fh.write(json.dumps(line) + "\n")
            self._fh.flush()
            if self.fsync_every:
                self._rows_since_sync += 1
                if self._rows_since_sync >= self.fsync_every:
                    os.fsync(self._fh.fileno())
                    self._rows_since_sync = 0

    def header(self, toolbox: Any = None, init_backend: bool = True,
               **extra: Any) -> None:
        payload: Dict[str, Any] = {
            "run_id": self.run_id,
            "wall_start": round(self.wall_start, 6),
            "env": environment_fingerprint(init_backend),
            "monitoring": True,
        }
        if toolbox is not None:
            payload["toolbox"] = toolbox_fingerprint(toolbox)
        payload.update(extra)
        self._write("header", payload)

    def event(self, kind: str, **payload: Any) -> None:
        self._write(kind, payload)

    def _compile_observed(self, duration: float, library: str) -> None:
        with self._write_lock:
            self.n_compiles += 1
            seq = self.n_compiles
            steady = self._steady
            if steady is not None:
                self.n_retraces += 1
        row = {"dur_s": round(duration, 6), "seq": seq, "library": library}
        if steady is None:
            self._write("compile", row)
        else:
            self._write("retrace", {**row, "after": steady})

    def mark_steady(self, label: str = "") -> None:
        """Declare the run's builds finished: every kernel build observed
        after this point is journaled as a ``retrace``. The instrumented
        loops call this when their first run completes."""
        if self._steady is None:
            self._steady = label or "steady"
            self._write("steady", {"label": self._steady,
                                   "n_compiles": self.n_compiles})

    def meter_rows(self, meter: Any, stacked: Any, gen0: int = 1,
                   initial: Any = None) -> None:
        """Write per-generation ``meter`` rows from a loop's stacked meter
        states (one host copy, :meth:`Meter.rows`); ``initial`` (the
        state before the first generation) becomes the ``gen0 - 1``
        row."""
        first = gen0 - 1 if initial is not None else gen0
        for i, row in enumerate(meter.rows(stacked, initial=initial)):
            self._write("meter", {"gen": first + i, **row})

    def spans(self, recorder: Any) -> None:
        """Write one ``span`` aggregate row per span name recorded by a
        :class:`~deap_tpu_torch.support.profiling.SpanRecorder`."""
        for name, agg in sorted(recorder.aggregates().items()):
            self._write("span", {"name": name, **{
                k: (round(v, 9) if isinstance(v, float) else v)
                for k, v in agg.items()}})

    def summary(self, **payload: Any) -> None:
        payload.setdefault("n_compiles", self.n_compiles)
        payload.setdefault("n_retraces", self.n_retraces)
        self._write("summary", payload)

    def close(self) -> None:
        if self._closed:
            return
        with _LOCK:
            if self in _ACTIVE:
                _ACTIVE.remove(self)
        with self._write_lock:  # never close the file under a writer
            self._closed = True
            if self.fsync_every and self._rows_since_sync:
                try:
                    os.fsync(self._fh.fileno())
                except OSError:
                    pass
            self._fh.close()

    def __enter__(self) -> "RunJournal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class JournalRows(List[Dict[str, Any]]):
    """``read_journal``'s result: a plain list of event dicts, plus
    where the file stopped being parseable: ``tear_offset`` (byte offset
    of a torn last line, or ``None``) and ``skipped_offsets`` (byte
    offsets of malformed interior lines)."""

    def __init__(self, *args):
        super().__init__(*args)
        self.tear_offset: Optional[int] = None
        self.skipped_offsets: List[int] = []


def read_journal(path: str, strict: bool = False) -> JournalRows:
    """Parse a journal back into a list of event dicts. By default a torn
    last line (a writer killed mid-``write``) is reported as
    ``tear_offset`` and malformed interior lines are skipped with their
    offsets; ``strict=True`` raises ``ValueError`` naming the first bad
    byte offset instead."""
    out = JournalRows()
    with open(path, "rb") as fh:
        data = fh.read()
    offset = 0
    for raw in data.split(b"\n"):
        terminated = offset + len(raw) < len(data)
        line = raw.strip()
        if line:
            try:
                out.append(json.loads(line.decode("utf-8")))
            except (json.JSONDecodeError, UnicodeDecodeError):
                if strict:
                    raise ValueError(
                        f"{path}: unparseable journal line at byte "
                        f"{offset}" + ("" if terminated else
                                       " (torn tail — writer killed "
                                       "mid-write?)"))
                if terminated:
                    out.skipped_offsets.append(offset)
                else:
                    out.tear_offset = offset
        offset += len(raw) + 1
    return out


def journal_generations(path: str) -> List[str]:
    """All generations of a journal path, oldest first: the rotated
    predecessors ``<path>.1``, ``<path>.2``, …, then the live file. Only
    paths that exist are returned."""
    out: List[str] = []
    n = 1
    while os.path.exists("%s.%d" % (path, n)):
        out.append("%s.%d" % (path, n))
        n += 1
    if os.path.exists(path):
        out.append(path)
    return out
