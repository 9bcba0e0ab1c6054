"""Deterministic fault injection — the proof harness for the
resilience layer.

Port of :mod:`deap_tpu.resilience.faultinject`. A :class:`FaultPlan` is
a list of :class:`Fault` objects fired by
:class:`~deap_tpu_torch.resilience.engine.ResilientRun` at well-defined
points of the drive (``segment_start`` / ``segment_attempt`` /
``segment_end`` / ``saved``), each carrying the segment bounds and the
live :class:`~deap_tpu_torch.support.checkpoint.Checkpointer`. Every
fault is a pure function of (event, bounds, its own fire counter) — no
clocks, no random numbers — so a test replays the exact same failure
schedule every run, which is what lets the tests pin bit-exact recovery.

Catalogue:

- :class:`KillAt` — simulate a hard kill (OOM-killer, node loss) by
  raising :class:`InjectedCrash` at a generation boundary, before or
  after the segment's checkpoint lands. The test then resumes with a
  fresh engine, exactly like a rescheduled pod would.
- :class:`PreemptAt` — deliver a real ``SIGTERM`` to this process at a
  segment boundary; the engine's handler finishes the in-flight
  segment, saves, journals ``preempted`` and raises ``Preempted``.
- :class:`CorruptCheckpoint` — flip (or truncate to) bytes of the
  checkpoint file just written, emulating a torn/rotted snapshot; the
  CRC layer must detect it and fall back.
- :class:`FailSegments` — raise a classifiable transient error
  (``RESOURCE_EXHAUSTED`` by default) on the first ``times`` attempts
  of a segment, exercising retry/backoff/degrade.
- :func:`nan_inject_evaluate` — wrap an evaluator so chosen rows come
  back NaN, exercising the quarantine wrapper and the ``non_finite``
  alarm.

Service-shaped faults — fired by
:class:`~deap_tpu_torch.serving.service.EvolutionService`'s
``fault_plan`` event stream (``step`` after every service loop
iteration, ``boundary`` inside the segment drain, ``segment`` inside the
segment-latency window, ``http_response`` before a response is written,
``wal_append`` after an admission-WAL record lands, ``result`` as a
tenant finishes):

- :class:`DropResponse` — the network loses a response: the handler
  raises :class:`InjectedDrop`, the service closes the connection
  without replying — the client must retry, and only an idempotency
  key keeps the retry from admitting a twin job.
- :class:`DelaySegment` — wedge the service loop for ``delay_s`` at a
  chosen step, the deterministic stand-in for a hung segment; the
  watchdog must notice (``driver_stall``), flip ``/healthz`` to 503
  and re-arm when the service loop recovers.
- :class:`KillServiceAt` — ``SIGKILL`` this process at a chosen service
  loop step or boundary: the real crash the admission WAL + checkpoint
  recovery path exists for. Only meaningful in a child process (the
  chaos harness is ROADMAP A13b).
- :class:`TornWAL` — tear the tail off the admission WAL right after a
  record lands (then optionally ``SIGKILL``), emulating a power cut
  mid-append; replay must drop exactly the torn (never-ACKed) record.
- :class:`CorruptResult` — silently corrupt a finishing tenant's raw
  result (one flipped byte in the first array leaf) at the service's
  ``result`` seam, BEFORE the wire encode. Every layer still reports
  success — journal, status, HTTP 200 — which is exactly the silent
  wrong-answer failure only the known-answer canary tenants
  (:mod:`deap_tpu_torch.serving.canary`) can catch: the corrupted result's
  wire digest no longer matches the canary's precomputed reference.
- :class:`KillDuringHandoff` — ``SIGKILL`` the source service loop at a
  chosen seam of the live-migration handshake (the JAX package's
  ``serving.migration`` fires ``migration`` events at
  ``after_offer`` / ``before_adopted`` / ``before_transferred``; live
  migration is ROADMAP A13b, so in the port it stays inert):
  between offer-fsync and adoption-ACK is the exactly-once protocol's
  worst window, and the chaos tests pin that the tenant survives on
  exactly one service loop with bit-identical digests no matter which
  seam the kill lands on.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Any, List, Optional

import torch

__all__ = ["InjectedCrash", "InjectedTransient", "InjectedDrop",
           "InjectedReject", "InjectedCorruption", "Fault",
           "FaultPlan", "KillAt", "PreemptAt", "CorruptCheckpoint",
           "FailSegments", "DropResponse", "Reject429",
           "DelaySegment", "KillServiceAt", "KillDuringHandoff",
           "TornWAL", "CorruptResult", "nan_inject_evaluate",
           "corrupt_file", "corrupt_pytree"]


class InjectedCrash(RuntimeError):
    """A simulated hard kill — deliberately *not* classified transient,
    so the engine must not retry it (a real SIGKILL retries nothing)."""


class InjectedTransient(RuntimeError):
    """A simulated infrastructure error whose message carries a
    transient marker (``RESOURCE_EXHAUSTED`` etc.) so
    :func:`~deap_tpu_torch.resilience.engine.classify_error` retries it."""


class InjectedDrop(RuntimeError):
    """A simulated lost response: the service's HTTP handler catches
    this and closes the connection without writing a reply — the
    client-visible shape of a network partition mid-response."""


class InjectedReject(RuntimeError):
    """A simulated overload rejection: the service's HTTP handler
    catches this and answers 429 + ``Retry-After`` *instead of* the
    real response — the deterministic 429 source behind the load
    generator's thundering-herd retry-storm model (every rejected
    client backs off the same ``Retry-After`` and returns at once)."""

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


class InjectedCorruption(RuntimeError):
    """A simulated silent wrong answer: the service's boundary handler
    catches this around the result handoff and perturbs the finishing
    tenant's raw result (:func:`corrupt_pytree`) *before* the wire
    encode — so every success signal still fires and only a
    known-answer digest compare can tell."""


class Fault:
    """One scheduled failure. Subclasses implement :meth:`fire`;
    ``fired`` counts activations so plans stay single-shot by
    default."""

    def __init__(self):
        self.fired = 0

    def fire(self, event: str, **ctx) -> None:  # pragma: no cover
        raise NotImplementedError


class FaultPlan:
    """An ordered set of faults sharing the engine's event stream."""

    def __init__(self, faults: Optional[List[Fault]] = None):
        self.faults = list(faults or [])
        self.log: List[dict] = []

    def add(self, fault: Fault) -> "FaultPlan":
        self.faults.append(fault)
        return self

    def fire(self, event: str, **ctx) -> None:
        self.log.append({"event": event,
                         **{k: v for k, v in ctx.items()
                            if isinstance(v, (int, str, float))}})
        for f in self.faults:
            f.fire(event, **ctx)


class KillAt(Fault):
    """Raise :class:`InjectedCrash` when the drive crosses generation
    ``gen`` — ``when='before_save'`` kills after the segment computed
    but before its checkpoint landed (the worst crash window: that
    segment's work is lost and resume replays it), ``'after_save'``
    kills right after the checkpoint landed."""

    def __init__(self, gen: int, when: str = "before_save"):
        super().__init__()
        if when not in ("before_save", "after_save"):
            raise ValueError(f"unknown when={when!r}")
        self.gen = int(gen)
        self.when = when

    def fire(self, event: str, **ctx) -> None:
        want = "segment_end" if self.when == "before_save" else "saved"
        if event == want and not self.fired and ctx["hi"] >= self.gen:
            self.fired += 1
            raise InjectedCrash(
                f"injected hard kill at gen {ctx['hi']} ({self.when})")


class PreemptAt(Fault):
    """Deliver a real ``SIGTERM`` to this process when the drive
    crosses generation ``gen`` — exercises the actual signal-handler
    path: the engine finishes the segment, saves, raises
    ``Preempted``."""

    def __init__(self, gen: int, signum: int = signal.SIGTERM):
        super().__init__()
        self.gen = int(gen)
        self.signum = signum

    def fire(self, event: str, **ctx) -> None:
        if event == "segment_end" and not self.fired \
                and ctx["hi"] >= self.gen:
            self.fired += 1
            signal.raise_signal(self.signum)


def corrupt_file(path: str, mode: str = "flip", nbytes: int = 16,
                 offset: int = -256) -> None:
    """Deterministically damage a file in place. ``flip`` XORs
    ``nbytes`` bytes starting at ``offset`` (negative = from the end);
    ``truncate`` cuts the file to ``offset`` bytes."""
    size = os.path.getsize(path)
    if mode == "truncate":
        with open(path, "r+b") as f:
            f.truncate(max(0, size + offset if offset < 0 else offset))
        return
    if mode != "flip":
        raise ValueError(f"unknown mode={mode!r}")
    start = size + offset if offset < 0 else offset
    start = max(0, min(start, max(0, size - nbytes)))
    with open(path, "r+b") as f:
        f.seek(start)
        chunk = f.read(nbytes)
        f.seek(start)
        f.write(bytes(b ^ 0xA5 for b in chunk))


class CorruptCheckpoint(Fault):
    """After the checkpoint for generation ``gen`` lands, damage its
    bytes (``mode`` as in :func:`corrupt_file`) — the restore path must
    detect the CRC mismatch and fall back to the newest valid older
    step. ``then_crash=True`` also raises :class:`InjectedCrash` so the
    test resumes from the damaged directory."""

    def __init__(self, gen: int, mode: str = "flip",
                 then_crash: bool = True):
        super().__init__()
        self.gen = int(gen)
        self.mode = mode
        self.then_crash = then_crash

    def fire(self, event: str, **ctx) -> None:
        if event == "saved" and not self.fired and ctx["hi"] >= self.gen:
            self.fired += 1
            corrupt_file(ctx["path"], mode=self.mode)
            if self.then_crash:
                raise InjectedCrash(
                    f"injected crash after corrupting {ctx['path']}")


class FailSegments(Fault):
    """Fail the first ``times`` attempts of the segment starting at
    ``lo`` with a transient error (``marker`` lands in the message so
    the classifier sees it) — retry/backoff must absorb the failures
    and the result must stay bit-exact."""

    def __init__(self, lo: int, times: int = 2,
                 marker: str = "RESOURCE_EXHAUSTED"):
        super().__init__()
        self.lo = int(lo)
        self.times = int(times)
        self.marker = marker

    def fire(self, event: str, **ctx) -> None:
        if event == "segment_attempt" and ctx["lo"] == self.lo \
                and self.fired < self.times:
            self.fired += 1
            raise InjectedTransient(
                f"{self.marker}: injected transient failure "
                f"(attempt {ctx['attempt']})")


# ---------------------------------------------- service-shaped faults ----


class DropResponse(Fault):
    """Drop the response of the next ``times`` requests whose route
    contains ``route_substr`` — fired on the service's
    ``http_response`` event *after* the request was processed, so the
    server-side effect (an accepted job, a durable WAL record) stands
    while the client never learns of it. The retry that follows is
    exactly the duplicate-submit case idempotency keys exist for."""

    def __init__(self, route_substr: str, times: int = 1):
        super().__init__()
        self.route_substr = str(route_substr)
        self.times = int(times)

    def fire(self, event: str, **ctx) -> None:
        if event == "http_response" and self.fired < self.times \
                and self.route_substr in str(ctx.get("route", "")):
            self.fired += 1
            raise InjectedDrop(
                f"injected response drop on {ctx.get('route')} "
                f"(#{self.fired}/{self.times})")


class Reject429(Fault):
    """Answer the next ``times`` requests whose route contains
    ``route_substr`` with 429 + ``Retry-After: retry_after_s`` —
    fired on the service's ``http_response`` event. Like
    :class:`DropResponse` it fires *after* processing (the request's
    server-side effects stand), so pair it with submit idempotency
    keys; its value is determinism — the retry storm hits exactly
    when scheduled, independent of real load."""

    def __init__(self, route_substr: str, times: int = 1,
                 retry_after_s: float = 1.0):
        super().__init__()
        self.route_substr = str(route_substr)
        self.times = int(times)
        self.retry_after_s = float(retry_after_s)

    def fire(self, event: str, **ctx) -> None:
        if event == "http_response" and self.fired < self.times \
                and self.route_substr in str(ctx.get("route", "")):
            self.fired += 1
            raise InjectedReject(
                f"injected 429 on {ctx.get('route')} "
                f"(#{self.fired}/{self.times})",
                retry_after_s=self.retry_after_s)


class DelaySegment(Fault):
    """Wedge the service loop for ``delay_s`` seconds at its step
    ``step`` (event ``step``, ``boundary`` with ``event='boundary'``,
    or — the regression-attribution seam — ``segment``, which the
    service fires INSIDE the scheduler's segment-latency window so
    the injected stall lands in the segment spans and histogram) —
    the deterministic hung-segment stand-in the watchdog must
    detect and, once the sleep returns, recover from."""

    def __init__(self, step: int, delay_s: float, event: str = "step"):
        super().__init__()
        self.step = int(step)
        self.delay_s = float(delay_s)
        self.event = str(event)

    def fire(self, event: str, **ctx) -> None:
        if event == self.event and not self.fired \
                and int(ctx.get("step", -1)) >= self.step:
            self.fired += 1
            time.sleep(self.delay_s)


class KillServiceAt(Fault):
    """``SIGKILL`` this process at service loop step ``step`` (or at a
    segment ``boundary`` with ``event='boundary'`` — mid-drain, after
    compute but amid bookkeeping: the worst window). No handler runs,
    no drain happens, nothing flushes — recovery is entirely the
    admission WAL + checkpoint replay path. Use inside a child process
    only."""

    def __init__(self, step: int, event: str = "step",
                 signum: int = signal.SIGKILL):
        super().__init__()
        self.step = int(step)
        self.event = str(event)
        self.signum = signum

    def fire(self, event: str, **ctx) -> None:
        if event == self.event and not self.fired \
                and int(ctx.get("step", -1)) >= self.step:
            self.fired += 1
            os.kill(os.getpid(), self.signum)


class KillDuringHandoff(Fault):
    """``SIGKILL`` the source process at a chosen **seam of the
    live-migration handshake** — fired on the ``migration`` event live
    migration emits with ``seam=`` context (ROADMAP A13b; inert until
    then):

    - ``after_offer`` — the offer record is fsync'd but the target has
      heard nothing: the tenant must replay on the SOURCE.
    - ``before_adopted`` — the target received the checkpoint but its
      ``adopted`` record is not yet durable: still the source's.
    - ``before_transferred`` — the target ACKed (its adoption is
      durable) but the source died before writing ``transferred``: the
      tenant must resume on the TARGET, and the restarted source must
      discover that from the target's WAL and retroactively close its
      open offer.

    Optionally filtered to one tenant (``tenant_substr``). Only
    meaningful in a chaos-harness child process."""

    def __init__(self, seam: str, tenant_substr: str = "",
                 signum: int = signal.SIGKILL):
        super().__init__()
        if seam not in ("after_offer", "before_adopted",
                        "before_transferred"):
            raise ValueError(f"unknown migration seam {seam!r}")
        self.seam = seam
        self.tenant_substr = str(tenant_substr)
        self.signum = signum

    def fire(self, event: str, **ctx) -> None:
        if event == "migration" and not self.fired \
                and str(ctx.get("seam")) == self.seam \
                and self.tenant_substr in str(ctx.get("tenant_id", "")):
            self.fired += 1
            os.kill(os.getpid(), self.signum)


class TornWAL(Fault):
    """After the ``seq``-th admission-WAL append, tear ``nbytes`` off
    the log's tail (a power cut mid-append) and — default — raise
    :class:`InjectedCrash` so the submit that wrote the record never
    ACKs. The restarted WAL must self-heal the tear and replay
    everything *except* the torn record."""

    def __init__(self, seq: int, nbytes: int = 7,
                 then_crash: bool = True):
        super().__init__()
        self.seq = int(seq)
        self.nbytes = int(nbytes)
        self.then_crash = then_crash

    def fire(self, event: str, **ctx) -> None:
        if event == "wal_append" and not self.fired \
                and int(ctx.get("seq", -1)) >= self.seq:
            self.fired += 1
            corrupt_file(ctx["path"], mode="truncate",
                         offset=-self.nbytes)
            if self.then_crash:
                raise InjectedCrash(
                    f"injected crash after tearing {ctx['path']}")


class CorruptResult(Fault):
    """Silently corrupt the raw result of the next ``times`` finishing
    tenants whose id contains ``tenant_substr`` — fired on the
    service's ``result`` event at the segment boundary where the
    tenant completes. The service catches the raised
    :class:`InjectedCorruption` and swaps in
    ``corrupt_pytree(result)`` before the result view is published, so
    the corruption is upstream of the wire digest: journal, tenant
    status and HTTP all report success, and only the known-answer
    canary's digest compare (:mod:`deap_tpu_torch.serving.canary`) can
    detect it. The default ``tenant_substr='canary'`` aims the fault
    straight at the canary tenants — the end-to-end detection proof
    ``bench.py --canary`` measures the latency of."""

    def __init__(self, tenant_substr: str = "canary", times: int = 1):
        super().__init__()
        self.tenant_substr = str(tenant_substr)
        self.times = int(times)

    def fire(self, event: str, **ctx) -> None:
        if event == "result" and self.fired < self.times \
                and self.tenant_substr in str(ctx.get("tenant_id", "")):
            self.fired += 1
            raise InjectedCorruption(
                f"injected result corruption for "
                f"{ctx.get('tenant_id')} (#{self.fired}/{self.times})")


def corrupt_pytree(tree: Any) -> Any:
    """Return ``tree`` with the first byte of its first numeric tensor or
    array leaf XOR-flipped — the smallest corruption that is guaranteed to
    change a digest over raw leaf bytes, whatever the dtype and whatever
    NaN/inf values arithmetic perturbations leave fixed. Structure,
    shapes, dtypes and devices are untouched; other leaves pass
    through."""
    import numpy as np

    from deap_tpu_torch.support.checkpoint import tree_flatten, tree_unflatten

    leaves, structure = tree_flatten(tree)
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            if leaf.numel() == 0 or leaf.dtype.is_complex:
                continue
            damaged = leaf.detach().clone().contiguous()
            damaged.reshape(-1).view(torch.uint8)[0] ^= 0xA5
        else:
            try:
                arr = np.asarray(leaf)
            except Exception:
                continue
            if arr.size == 0 or arr.dtype.kind not in "biufc":
                continue
            damaged = np.array(arr)  # contiguous owned copy
            damaged.reshape(-1).view(np.uint8)[0] ^= 0xA5
        leaves[i] = damaged
        return tree_unflatten(structure, leaves)
    return tree


def nan_inject_evaluate(evaluate, rows: Any):
    """Wrap a batched evaluator so fitness rows ``rows`` (indices) come
    back NaN every call — deterministic input for the quarantine
    wrapper."""
    rows = torch.as_tensor(rows, dtype=torch.int64)

    def wrapped(genomes):
        values = evaluate(genomes)
        flat_bad = torch.zeros(values.shape[0], dtype=torch.bool,
                               device=values.device)
        flat_bad[rows.to(values.device)] = True
        bad = flat_bad.reshape((-1,) + (1,) * (values.ndim - 1))
        return torch.where(bad, torch.nan, values)

    return wrapped
