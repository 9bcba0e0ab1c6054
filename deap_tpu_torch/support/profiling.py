"""Profiling and tracing hooks.

Port of :mod:`deap_tpu.support.profiling` onto ``torch.profiler``: a
whole-run trace written as a chrome trace (``chrome://tracing``,
``ui.perfetto.dev``), named spans that show up as labelled ranges on
the host and device timelines (``torch.profiler.record_function``), a
host-side wall-time aggregation of those spans, and per-generation wall
times. Usage::

    from deap_tpu_torch.support.profiling import trace, span, timed_generations

    with trace("build/ea-trace"):          # whole-run chrome trace
        pop, logbook, hof = algorithms.ea_simple(...)

    with span("variation"):                # a labelled range
        ...

    for gen, state, dt in timed_generations(run_one_gen, pop, ngen=100):
        ...                                # per-generation wall times

None of them changes a computed value: a span is a label and a wall
clock, :func:`sync` waits for the card and reads nothing back.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import random
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

__all__ = ["trace", "annotate", "span", "timed_generations",
           "timed_phases", "sync", "SpanRecorder", "set_span_recorder",
           "get_span_recorder", "device_memory_snapshot",
           "live_buffer_bytes"]

#: the file :func:`trace` writes inside its ``log_dir``
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str, **kwargs):
    """Profile everything run inside the context with ``torch.profiler``
    (host ops, and the card's kernels where CUDA is initialised) and
    write the chrome trace to ``log_dir/trace.json``; ``kwargs`` go to
    ``torch.profiler.profile`` (``record_shapes=True``, ...). Yields the
    profiler, whose ``key_averages()`` sum the kernels by name."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, **kwargs) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class SpanRecorder:
    """Host-side wall-time aggregation of :func:`span` blocks.

    While installed (``with SpanRecorder() as rec:`` or
    :func:`set_span_recorder`), every ``span(name)`` is also timed with
    ``time.perf_counter`` and accumulated per name: count / total / mean
    / p50 / p99 / max. The card runs asynchronously, so a span around
    work that ends without a synchronise times the host's enqueue of
    that work; a span around a read-back times the wait for the card.

    A bounded uniform reservoir (Vitter's algorithm R, ``max_samples``
    per name) backs the percentiles, so they keep moving on long runs;
    count / total / mean / max are exact. The replacement draws come
    from a ``random.Random(seed)`` of the recorder's own, so identical
    span streams aggregate identically and no draw of the run is
    touched. :meth:`record` and :meth:`aggregates` take one lock, so
    spans from several threads aggregate whole.
    """

    def __init__(self, max_samples: int = 4096, seed: int = 0):
        self.max_samples = int(max_samples)
        self._samples: Dict[str, list] = {}
        self._count: Dict[str, int] = {}
        self._total: Dict[str, float] = {}
        self._max: Dict[str, float] = {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._prev: Optional["SpanRecorder"] = None

    def record(self, name: str, seconds: float) -> None:
        with self._lock:
            n = self._count.get(name, 0) + 1
            self._count[name] = n
            self._total[name] = self._total.get(name, 0.0) + seconds
            self._max[name] = max(self._max.get(name, seconds), seconds)
            bucket = self._samples.setdefault(name, [])
            if len(bucket) < self.max_samples:
                bucket.append(seconds)
            else:
                # algorithm R: each of the n samples seen so far is kept
                # with probability max_samples / n
                j = self._rng.randrange(n)
                if j < self.max_samples:
                    bucket[j] = seconds

    def aggregates(self) -> Dict[str, Dict[str, float]]:
        """``{name: {count, total_s, mean_s, p50_s, p99_s, max_s}}``."""
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for name, n in self._count.items():
                total = self._total[name]
                samples = sorted(self._samples.get(name, ()))
                agg = {"count": n, "total_s": total, "mean_s": total / n}
                if samples:
                    m = len(samples)
                    agg["p50_s"] = samples[(m - 1) // 2]
                    agg["p99_s"] = samples[min(m - 1, int(0.99 * (m - 1)))]
                    agg["max_s"] = self._max[name]
                out[name] = agg
        return out

    def __enter__(self) -> "SpanRecorder":
        self._prev = set_span_recorder(self)
        return self

    def __exit__(self, *exc) -> None:
        set_span_recorder(self._prev)
        self._prev = None


# The active recorder: one slot for the process, so spans deep in the
# library reach the recorder a run installed without being handed it.
_RECORDER: list = [None]
# telemetry.tracing, imported at the first recorded span (the telemetry
# package imports this module)
_TRACING: list = [None]


def _tracing_mod():
    if _TRACING[0] is None:
        from deap_tpu_torch.telemetry import tracing as _tr
        _TRACING[0] = _tr
    return _TRACING[0]


def set_span_recorder(rec: Optional[SpanRecorder]) -> Optional[SpanRecorder]:
    """Install ``rec`` as the active span recorder (None disables);
    returns the previous one so callers can restore it."""
    prev = _RECORDER[0]
    _RECORDER[0] = rec
    return prev


def get_span_recorder() -> Optional[SpanRecorder]:
    return _RECORDER[0]


@contextlib.contextmanager
def span(name: str):
    """A named range: ``torch.profiler.record_function(name)``, so the
    block and the kernels it launches carry ``name`` in a profiler
    trace, and, while a :class:`SpanRecorder` is installed, the block's
    host wall time. Inside a traced request (:mod:`~deap_tpu_torch.
    telemetry.tracing`) a recorded span also lands in its waterfall."""
    rec = _RECORDER[0]
    if rec is None:
        with record_function(name):
            yield
        return
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        rec.record(name, dt)
        tr = _tracing_mod()
        if tr.current() is not None:
            tr.emit_current(f"span:{name}", dt)


def annotate(name: str) -> Callable:
    """Decorator: run the function inside ``record_function(name)``."""
    def deco(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with record_function(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


def sync(tree: Any) -> Any:
    """Wait until the work that produces ``tree``'s tensors has finished:
    ``torch.cuda.synchronize`` on each CUDA device among its leaves
    (dicts, sequences and dataclasses such as populations are walked;
    the whole device waits, so also work queued on other streams). CPU
    tensors and other leaves need no wait. Returns ``tree``."""
    # imported here: the checkpoint module imports the telemetry
    # package, which imports this module
    from deap_tpu_torch.support.checkpoint import tree_flatten
    devices = {leaf.device for leaf in tree_flatten(tree)[0]
               if isinstance(leaf, torch.Tensor) and leaf.is_cuda}
    for d in sorted(devices, key=str):
        torch.cuda.synchronize(d)
    return tree


def live_buffer_bytes() -> Dict[str, int]:
    """Bytes the caching allocator holds in live tensors, by platform:
    ``{"cuda": torch.cuda.memory_allocated()}`` summed over the devices,
    or ``{}`` where no CUDA context exists (nothing is initialised to
    answer)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return {}
    return {"cuda": sum(torch.cuda.memory_allocated(i)
                        for i in range(torch.cuda.device_count()))}


def device_memory_snapshot(path: Optional[str] = None) -> Dict[str, Any]:
    """One device-memory observation: :func:`live_buffer_bytes`, and,
    with ``path``, the allocator's ``torch.cuda.memory_stats()`` written
    there as JSON (``profile_path``, ``profile_bytes``; ``profile_error``
    where no CUDA context exists). A JSON-able dict: the flight recorder
    journals it as a ``device_memory`` event."""
    snap: Dict[str, Any] = {"live_bytes": live_buffer_bytes()}
    if path is not None:
        if not snap["live_bytes"]:
            snap["profile_error"] = "no CUDA context"
            return snap
        blob = json.dumps(torch.cuda.memory_stats(), sort_keys=True).encode()
        with open(path, "wb") as fh:
            fh.write(blob)
        snap["profile_path"] = str(path)
        snap["profile_bytes"] = len(blob)
    return snap


def timed_phases(phases: dict, reps: int = 3) -> dict:
    """``phases`` maps a label to a zero-argument thunk returning
    tensors; each is run once to warm up, then ``reps`` times under
    :func:`sync`, and the least wall seconds per label returned."""
    out = {}
    for name, thunk in phases.items():
        sync(thunk())
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            sync(thunk())
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out


def timed_generations(step: Callable, state: Any, ngen: int,
                      *step_args: Any) -> Iterator[Tuple[int, Any, float]]:
    """A generation loop that waits for each generation: yields ``(gen,
    state, seconds)`` with ``state = step(state, *step_args)``. For
    profiling only: the synchronise a generation costs the card its
    queue of work."""
    for gen in range(ngen):
        t0 = time.perf_counter()
        state = sync(step(state, *step_args))
        yield gen, state, time.perf_counter() - t0
