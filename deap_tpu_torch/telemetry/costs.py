"""Program observatory — what did a program launch on the card?

Port of :mod:`deap_tpu.telemetry.costs` onto ``torch.profiler``. The
JAX observatory profiles every AOT-compiled XLA program at the seams
that compile one; a port program is Python that launches kernels, so
its honest profile is what its first call per input signature ran,
observed under ``torch.profiler``:

- ``label`` — the program's name;
- ``compile_s`` — the ``nvcc`` seconds that call spent building kernel
  libraries (:data:`deap_tpu_torch._build.COMPILE_SECONDS`), 0 when
  every library was built;
- ``kernel_hash`` — a fingerprint of the CUDA kernels the call
  launched, by name and in order, together with ``build_hash``
  (``_build.py``'s hash of the loaded libraries' sources and flags);
  ``kernels`` lists the distinct names in first-launch order and
  ``n_launches`` counts the launches;
- ``kernel_us`` — each kernel's device microseconds in that call, from
  the profiler's ``key_averages``, and ``device_us`` their sum;
- ``max_memory_allocated_delta`` — how far the call raised
  ``torch.cuda.max_memory_allocated``.

Each record is journaled as a ``program_profile`` event. When the same
``(label, signature)`` is profiled again and launches a different
fingerprint, the observatory raises the ``hlo_drift`` alarm (the JAX
package's name) through the
:class:`~deap_tpu_torch.telemetry.probes.HealthMonitor`, journals it,
and evicts the dispatch tuner's winners recorded against that label and
against the labels of the instrumented programs it called
(:func:`deap_tpu_torch.tuning.note_hlo_drift`).

Keys of the JAX profile that only XLA can fill are absent, never
invented: ``hlo_hash`` (there is no HLO), ``flops``,
``bytes_accessed`` and ``optimal_seconds`` (there is no cost analysis),
``argument_bytes`` / ``output_bytes`` / ``temp_bytes`` /
``aliased_bytes`` / ``code_bytes`` and ``donating`` (there is no memory
analysis and no buffer donation to audit).

:func:`instrument` wraps a callable: while an observatory is active
(``with ProgramObservatory(...):``), the first call per input signature
runs under the profiler; profiling observes and changes no computed
value. With no active observatory the wrapper is one ``None`` check and
a tail call.

Usage::

    from deap_tpu_torch.telemetry import ProgramObservatory

    with ProgramObservatory(journal=tel.journal, health=monitor) as obs:
        res = ResilientRun(ckdir, telemetry=tel)
        pop, logbook, hof = res.ea_simple(generator, pop, tb, .5, .2, 100)
    obs.profiles   # one dict per profiled program (also journaled)
"""

from __future__ import annotations

import functools
import hashlib
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

from deap_tpu_torch import _build
from deap_tpu_torch.telemetry import tracing

__all__ = ["ProgramObservatory", "instrument", "observatory",
           "profile_compiled"]

#: the active observatory — one slot for the process (the instrumented
#: seams are built far from the run driver)
_ACTIVE: list = [None]


def observatory() -> Optional["ProgramObservatory"]:
    """The currently active observatory, or None."""
    return _ACTIVE[0]


def _leaf_descriptor(leaf: Any) -> Tuple:
    """A hashable signature of one argument leaf: a tensor by shape,
    dtype and device, anything else by repr."""
    if isinstance(leaf, torch.Tensor):
        return (tuple(leaf.shape), str(leaf.dtype), str(leaf.device))
    return ("py", repr(leaf))


def signature_of(tree: Any) -> Tuple:
    """The tree structure (dicts, sequences and dataclasses such as
    :class:`~deap_tpu_torch.core.population.Population`) and every
    leaf's descriptor."""
    # imported here: the checkpoint module imports the journal, whose
    # package imports this module
    from deap_tpu_torch.support.checkpoint import tree_flatten
    leaves, structure = tree_flatten(tree)
    return (repr(structure), tuple(_leaf_descriptor(x) for x in leaves))


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def _kernel_events(prof) -> List[Any]:
    """The device kernels of a finished profile, in launch order."""
    cuda = torch.autograd.DeviceType.CUDA
    evts = [e for e in prof.events() if e.device_type == cuda]
    return sorted(evts, key=lambda e: e.time_range.start)


def _profile_call(fn: Callable, args, kwargs):
    """Run ``fn(*args, **kwargs)`` under ``torch.profiler`` and return
    ``(result, fields)``: the profile's fields bar ``label``."""
    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
        peak0 = torch.cuda.max_memory_allocated()
    built0 = _build.COMPILE_SECONDS[0]
    with profile(activities=activities) as prof:
        out = fn(*args, **kwargs)
        if cuda:
            torch.cuda.synchronize()
    compile_s = _build.COMPILE_SECONDS[0] - built0
    launches = [e.name for e in _kernel_events(prof)]
    names = list(dict.fromkeys(launches))
    kernel_us = {}
    if names:
        wanted = set(names)
        for avg in prof.key_averages():
            if avg.key in wanted:
                kernel_us[avg.key] = round(_device_us(avg), 3)
    builds = _build.loaded_hashes()
    build_hash = hashlib.sha1(json.dumps(
        builds, sort_keys=True).encode()).hexdigest()[:16]
    kernel_hash = hashlib.sha1(json.dumps(
        [launches, build_hash]).encode()).hexdigest()[:16]
    fields = {"kernel_hash": kernel_hash, "build_hash": build_hash,
              "compile_s": round(float(compile_s), 6),
              "kernels": names, "n_launches": len(launches),
              "kernel_us": kernel_us,
              "device_us": round(sum(kernel_us.values()), 3)}
    if cuda:
        fields["max_memory_allocated_delta"] = int(
            torch.cuda.max_memory_allocated() - peak0)
    return out, fields


class ProgramObservatory:
    """Collects per-program profiles and drift alarms.

    :param journal: a :class:`~deap_tpu_torch.telemetry.journal.
        RunJournal` for ``program_profile`` / ``alarm`` events; default
        broadcasts into every open journal.
    :param health: a :class:`~deap_tpu_torch.telemetry.probes.
        HealthMonitor`; drift fires its ``hlo_drift`` alarm. Without one
        the drift still lands in the journal as an ``alarm`` event.
    :param on_profile: optional callback receiving each profile dict.

    Entering the context installs this observatory as the process-wide
    active one; exiting restores the previous. :attr:`profiles`
    accumulates one dict per profiled program; :attr:`drifts` the drift
    alarms.
    """

    def __init__(self, journal=None, health=None,
                 on_profile: Optional[Callable] = None):
        self.journal = journal
        self.health = health
        self.on_profile = on_profile
        self.profiles: List[Dict[str, Any]] = []
        self.drifts: List[Dict[str, Any]] = []
        #: (label, signature) -> kernel_hash
        self._fingerprints: Dict[Tuple, str] = {}
        #: label -> the labels of the instrumented programs it called
        #: (run as they are, their kernels in its profile)
        self._nested: Dict[str, set] = {}
        self._prev: Optional[ProgramObservatory] = None

    def __enter__(self) -> "ProgramObservatory":
        self._prev = _ACTIVE[0]
        _ACTIVE[0] = self
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE[0] = self._prev
        self._prev = None

    def _journal(self, kind: str, **payload) -> None:
        if self.journal is not None:
            self.journal.event(kind, **payload)
        else:
            from deap_tpu_torch.telemetry.journal import broadcast
            broadcast(kind, **payload)

    def record(self, label: str, fields: Dict[str, Any],
               signature: Any = None) -> Dict[str, Any]:
        """Record one profiled call's ``fields`` (:func:`_profile_call`):
        journal its ``program_profile`` row and check it against any
        earlier profile of the same ``(label, signature)``."""
        profile_ = {"label": str(label), **fields}
        ids = tracing.current_ids()
        if ids:
            profile_.update(ids)
            tracing.emit_current("compile", profile_["compile_s"],
                                 phase="compile", always=True,
                                 label=profile_["label"],
                                 kernel_hash=profile_["kernel_hash"])
        self.profiles.append(profile_)
        self._journal("program_profile", **profile_)
        if self.on_profile is not None:
            self.on_profile(profile_)

        key = (profile_["label"], signature)
        seen = self._fingerprints.get(key)
        if seen is not None and seen != profile_["kernel_hash"]:
            self._drift(profile_, seen)
        self._fingerprints[key] = profile_["kernel_hash"]
        return profile_

    def _drift(self, profile_: Dict[str, Any], seen: str) -> None:
        """The same (label, signature) launched other kernels."""
        detail = {"program": profile_["label"],
                  "prev_kernel_hash": seen,
                  "kernel_hash": profile_["kernel_hash"]}
        if self.health is not None:
            alarm = self.health.program_drift(**detail)
        else:
            alarm = {"alarm": "hlo_drift", "gen": None, **detail}
        self.drifts.append(alarm)
        self._journal("alarm", **alarm)
        # a drifted program invalidates its measured dispatch winners
        # and those of the programs it called, whose kernels its profile
        # holds: the tuning cache's timings belonged to the old kernels
        # (journaled per eviction as ``tuning_invalidation``)
        from deap_tpu_torch import tuning
        label = profile_["label"]
        for program in [label] + sorted(self._nested.get(label, ())):
            tuning.note_hlo_drift(program)


def profile_compiled(label: str, fn: Callable, *args,
                     signature: Any = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` and, while an observatory is active,
    profile the call into it (a caller that drives its own program, a
    benchmark harness). Returns ``(result, profile or None)``."""
    obs = _ACTIVE[0]
    if obs is None:
        return fn(*args, **kwargs), None
    out, fields = _profile_call(fn, args, kwargs)
    return out, obs.record(label, fields, signature=signature)


#: the label of the instrumented program running under an active
#: observatory, else None: the programs it calls run as they are (its
#: profile holds their kernels) and are noted as nested in it, so its
#: drift evicts their tuning winners too
_RUNNING: list = [None]


class _InstrumentedFunction:
    """The wrapper :func:`instrument` returns: with no active observatory
    a tail call; with one, the first call per input signature runs under
    the profiler and is recorded, later calls of that signature run as
    they are. A call made while another profiler runs (the resilient
    engine's flight recorder) runs as it is and leaves its signature to
    the next call: profilers do not nest. Nor do programs: one called
    inside another instrumented program (``nd_rank`` inside a resilient
    segment) runs as it is, and the observatory notes it as nested in
    the outer label, whose drift then evicts its tuning winners."""

    def __init__(self, fn: Callable, label: str,
                 signature: Optional[Callable] = None):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self.label = str(label)
        self._signature = signature
        self._seen: set = set()

    def __call__(self, *args, **kwargs):
        obs = _ACTIVE[0]
        outer = _RUNNING[0]
        if obs is None or outer is not None:
            if obs is not None and outer != self.label:
                obs._nested.setdefault(outer, set()).add(self.label)
            return self._fn(*args, **kwargs)
        if torch.autograd._profiler_enabled():
            return self._fn(*args, **kwargs)
        _RUNNING[0] = self.label
        try:
            sig = (self._signature(*args, **kwargs) if self._signature
                   else signature_of((args, kwargs)))
            if sig in self._seen:
                return self._fn(*args, **kwargs)
            self._seen.add(sig)
            out, fields = _profile_call(self._fn, args, kwargs)
        finally:
            _RUNNING[0] = None
        obs.record(self.label, fields, signature=sig)
        return out


def instrument(fn: Callable, label: str,
               signature: Optional[Callable] = None) -> Callable:
    """Wrap ``fn`` so the active observatory profiles its first call per
    input signature (see :class:`_InstrumentedFunction`). ``signature``
    maps the call's arguments to a hashable key; default every tensor
    leaf's shape, dtype and device and every other leaf's repr."""
    return _InstrumentedFunction(fn, label, signature=signature)
