"""Admission write-ahead log — durable "this job exists" records.

A copy of :mod:`deap_tpu.serving.wal` (standard library only). The
service plane's crash-consistency gap: the scheduler's
per-tenant checkpoints only exist once a tenant has *run* a segment,
so a ``kill -9`` between HTTP accept and the driver's admission loses
the job entirely — the client got a 200 and the restarted service has
never heard of it. This module closes that window with the same
durability discipline as :mod:`deap_tpu_torch.support.checkpoint`, adapted
from rename-a-whole-file to an **append-only record log**:

- every record is one line ``<crc32:8 hex> <json>\\n`` — the CRC covers
  the exact JSON bytes, so a torn/bit-rotted record can never parse as
  a different record (the checkpoint module's per-blob CRC, per line);
- :meth:`AdmissionWAL.append` writes, flushes and **fsyncs before
  returning** — the service ACKs a submit only after the record is
  durable, which is the whole contract: *ACKed implies replayable* —
  and :meth:`AdmissionWAL.append_many` amortises the fsync: a batch
  submit's N accept records cost one durability sync;
- a record torn by a mid-``write`` kill is, by that same contract, a
  job that was never ACKed — :meth:`replay` detects it (CRC/parse
  fail on the final line), reports its byte offset, and opening for
  append **truncates the tear away** so the log stays parseable (the
  `read_journal` torn-tail policy, made self-healing).

Record kinds (free-form dicts; the service writes these):

- ``accept`` — tenant_id, problem, params, idempotency_key?,
  request_id?: journaled *before* the submit ACK.
- ``done`` — tenant_id, status: the job reached a terminal state
  (finished / stopped / failed / deadline_exceeded) — replay skips it.

Ownership-transfer records (live migration): moving a
tenant between driver processes is a two-WAL handshake in which the
tenant is, at every instant, owned by exactly one log:

- ``offer`` (source WAL) — tenant_id, offer_id, target, gen + the
  original accept fields: fsync'd *before* the checkpoint is handed to
  the target. An offered tenant stays ``pending`` on the source — an
  offer is an intent, not a transfer — so a crash mid-handoff replays
  it on the source unless the target's durable adoption says otherwise
  (the resolution rule belongs to live migration, ROADMAP A13b).
- ``adopted`` (TARGET's own WAL) — same fields plus ``source``: folds
  exactly like an ``accept`` (the adopted tenant joins the target's
  pending set, its idempotency key maps on the target), and is indexed
  by ``offer_id`` in ``WALState.adoptions`` — the durable fact the
  source checks to decide who won.
- ``transferred`` (source WAL) — tenant_id, offer_id, target: the
  source's commit record, written only after the target ACKed. Folds
  as a terminal: the tenant leaves the source's pending set and its
  open offer closes.

:meth:`replay` folds the log into ``WALState``: the records, the
surviving ``pending`` jobs (accepted, not done — resubmitted by a
restarted :class:`~deap_tpu_torch.serving.service.EvolutionService`, where
tenants with checkpoints resume and the rest re-run deterministically
from their problem factory) and the ``idempotency`` key→tenant map
(duplicate submit retries — a client that never saw its ACK — map back
to the same tenant instead of admitting twins).
"""

from __future__ import annotations

import json
import os
import threading
import zlib
from typing import Any, Dict, List, Optional

__all__ = ["AdmissionWAL", "WALState", "scan_wal"]


class WALState:
    """:meth:`AdmissionWAL.replay`'s result."""

    def __init__(self):
        #: every valid record, in append order
        self.records: List[Dict[str, Any]] = []
        #: tenant_id -> its ``accept`` record, for jobs with no
        #: terminal ``done`` record — the restart's replay set
        self.pending: Dict[str, Dict[str, Any]] = {}
        #: idempotency key -> tenant_id for every accepted job (done
        #: or not: a retry of a finished job must still map to it)
        self.idempotency: Dict[str, str] = {}
        #: tenant_id -> its newest UNRESOLVED ``offer`` record (no
        #: ``transferred`` follow-up): the migrations a restarted
        #: source must resolve against the target's WAL
        self.offers: Dict[str, Dict[str, Any]] = {}
        #: offer_id -> the ``adopted`` record THIS log holds — the
        #: durable proof of adoption a source (or racing peer)
        #: resolves ownership against
        self.adoptions: Dict[str, Dict[str, Any]] = {}
        #: byte offset of a torn tail record (None = clean log)
        self.tear_offset: Optional[int] = None

    def __len__(self) -> int:
        return len(self.records)


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)) or ".",
                     os.O_RDONLY)
    except OSError:  # platform without dir-open: best effort
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class AdmissionWAL:
    """One append-only, CRC-framed, fsync-on-append record log.

    Thread-safe: front-end request threads append ``accept`` records
    while the driver appends ``done`` records; one lock keeps lines
    whole and fsyncs ordered.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self.n_appended = 0
        # scan-then-heal: parse what survives, truncate a torn tail so
        # the first append lands on a clean line boundary
        self._state = self._scan()
        if self._state.tear_offset is not None:
            with open(self.path, "r+b") as fh:
                fh.truncate(self._state.tear_offset)
                fh.flush()
                os.fsync(fh.fileno())
        new = not os.path.exists(self.path)
        self._fh = open(self.path, "ab")
        if new:
            _fsync_dir(self.path)

    # ------------------------------------------------------------ write ----

    @staticmethod
    def _frame(kind: str, fields: Dict[str, Any]) -> bytes:
        rec = {"kind": str(kind), **fields}
        body = json.dumps(rec, sort_keys=True).encode("utf-8")
        return b"%08x %s\n" % (zlib.crc32(body), body)

    def append(self, kind: str, **fields: Any) -> None:
        """Append one record and make it durable (flush + fsync)
        before returning — callers ACK only after this returns."""
        self.append_many([(kind, fields)])

    def append_many(self, records) -> int:
        """Append ``[(kind, fields), ...]`` as one write + ONE fsync —
        a batch submit's N accept records cost a single durability
        sync, ACKed only after the last record is on disk. Returns the
        record count."""
        lines = [self._frame(kind, fields) for kind, fields in records]
        if not lines:
            return 0
        with self._lock:
            if self._fh.closed:
                raise ValueError("AdmissionWAL is closed")
            self._fh.write(b"".join(lines))
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self.n_appended += len(lines)
        return len(lines)

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    def __enter__(self) -> "AdmissionWAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------- read ----

    def _scan(self) -> WALState:
        return scan_wal(self.path)

    @staticmethod
    def _parse(line: bytes) -> Optional[Dict[str, Any]]:
        if len(line) < 10 or line[8:9] != b" ":
            return None
        crc_hex, body = line[:8], line[9:]
        try:
            if int(crc_hex, 16) != zlib.crc32(body):
                return None
            rec = json.loads(body.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        return rec if isinstance(rec, dict) and "kind" in rec else None

    @staticmethod
    def _fold(state: WALState, rec: Dict[str, Any]) -> None:
        state.records.append(rec)
        kind = rec.get("kind")
        tid = rec.get("tenant_id")
        if kind == "accept" and tid is not None:
            state.pending.setdefault(str(tid), rec)
            key = rec.get("idempotency_key")
            if key:
                state.idempotency.setdefault(str(key), str(tid))
        elif kind == "done" and tid is not None:
            state.pending.pop(str(tid), None)
        elif kind == "offer" and tid is not None:
            # intent only: the tenant STAYS pending here — ownership
            # moves when `transferred` lands (or, after a crash, when
            # the resolution rule finds the target's durable adoption)
            state.offers[str(tid)] = rec
        elif kind == "adopted" and tid is not None:
            # the target's side: folds like an accept (this log now
            # owns the tenant) and is indexed by offer id as the
            # durable adoption proof
            state.pending.setdefault(str(tid), rec)
            key = rec.get("idempotency_key")
            if key:
                state.idempotency.setdefault(str(key), str(tid))
            oid = rec.get("offer_id")
            if oid:
                state.adoptions[str(oid)] = rec
        elif kind == "transferred" and tid is not None:
            state.pending.pop(str(tid), None)
            state.offers.pop(str(tid), None)

    def replay(self) -> WALState:
        """The fold of the log as it stood at open time (the
        constructor already healed any torn tail)."""
        return self._state


def scan_wal(path: str) -> WALState:
    """Read-only fold of a WAL file — **no healing**. The migration
    resolution rule reads a *peer's* log with this (is the adoption
    durable over there?); truncating another process's possibly-live
    torn tail would be a corruption, so only the owning
    :class:`AdmissionWAL` constructor ever heals."""
    state = WALState()
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except (FileNotFoundError, OSError):
        return state
    offset = 0
    for raw in data.split(b"\n"):
        terminated = offset + len(raw) < len(data)
        line = raw.strip()
        if line:
            rec = AdmissionWAL._parse(line)
            if rec is None:
                # CRC/parse failure: mid-file damage is skipped
                # (same policy as read_journal); an unterminated
                # final line is the torn tail — by the
                # fsync-before-ACK contract it was never ACKed,
                # so dropping it loses nothing
                if not terminated:
                    state.tear_offset = offset
            else:
                AdmissionWAL._fold(state, rec)
        offset += len(raw) + 1
    return state
