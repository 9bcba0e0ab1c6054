"""Probe-and-persist dispatch tuner.

Port of :mod:`deap_tpu.tuning.tuner`. Every static dispatch guess of
the package — the nd-sort engine thresholds, the GP interpreter mode,
host-vs-device compaction, the CMA eigensolver, fused-vs-unfused
variation, ``segment_len`` — was measured on one machine. On another
card those numbers are guesses. At first use of a tunable decision
point on a given ``(device type, device name, knob, shape-bucket)`` key
the :class:`DispatchTuner` *short-probes* the candidate implementations
— warm each (the call that pays any ``nvcc`` build), time the best of
``reps`` calls with the card synchronised before and after each, check
that the candidates agree before trusting either — picks the measured
winner, persists it in the :class:`~deap_tpu_torch.tuning.cache.
TuningCache` next to the kernel build cache, and journals the decision
as a ``tuning_decision`` event.

Decision ladder (first match wins), implemented by :func:`resolve`:

1. ``DEAP_TPU_TORCH_TUNE_<KNOB>`` env var — the explicit escape hatch,
   honoured even when the tuner is disabled.
2. Tuning-cache hit (tuner enabled) — a prior process probed this key.
3. Short probe (tuner enabled, call site can probe — no CUDA graph is
   being captured) — measure, persist, journal.
4. The static default — exactly the behaviour without a tuner.

The tuner is **off by default** (``DEAP_TPU_TORCH_TUNE=1`` or
:func:`enable` opts in), so every code path keeps its static behaviour
bit for bit until a user asks for measured dispatch. Correctness never
rides on the probe: every candidate set is bit-identical by
construction or cross-checked by a tolerance predicate (``eigh``), and
an identity failure keeps the static default and journals the failure
(or raises, with ``strict_identity=True``). A candidate that raises
never wins: its timing is recorded as ``None`` and its error text is
journaled. On the card the probe then raises: a kernel that fails to
build or launch there is a fault, not a slower candidate. On the CPU
the fastest survivor serves this process, and nothing is persisted, so
a later process probes the key again.

On the card no candidate is a kernel's plain PyTorch version: ``fused``
races ``unfused`` against ``fused_kernel`` (K1), ``nd_impl`` offers
the ``[n, n]`` matrix only below the size at which the static rule takes
K7, and ``nd_cross`` has one candidate a device (K8 on the card, its
plain version on the CPU), so ``nd_rank_prefix`` asks no tuner.

Stale entries are evicted by the program observatory's ``hlo_drift``
alarm (:func:`note_hlo_drift`, wired in ``telemetry/costs.py``) and by
the cache-format / torch-version stamp (``cache.py``).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.tuning.cache import CACHE_FORMAT, TuningCache

#: master switch: truthy value auto-enables a process-wide tuner
ENV_ENABLE = "DEAP_TPU_TORCH_TUNE"

#: per-knob override prefix: ``DEAP_TPU_TORCH_TUNE_<KNOB>`` (knob
#: upper-cased)
ENV_PREFIX = "DEAP_TPU_TORCH_TUNE_"

#: the tunable decision points: knob -> (candidate values, static default
#: description). Candidate sets marked '*' are cross-checked by tolerance
#: instead of bitwise.
KNOBS = {
    "nd_impl": (("matrix", "tiled", "staircase", "sweep", "dc"),
                "device/n/nobj threshold rule (mo/emo.py)"),
    "nd_cross": (("plain", "kernel"),
                 "'kernel' (K8) on the card, 'plain' on the CPU: one "
                 "candidate a device (the env may only name it; no "
                 "tuner call)"),
    "gp_mode": (("scan", "sweep", "grouped"),
                "'grouped' in make_symbreg_loop, 'scan' elsewhere"),
    "compaction": (("host", "device"),
                   "'host' on the CPU, 'device' on the card (cache/env "
                   "only)"),
    "eigh_impl": (("lapack", "jacobi"),
                  "'lapack' (tolerance-checked*, not bitwise)"),
    "fused": (("unfused", "fused_plain", "fused_kernel"),
              "fused when capable: the kernel on the card, the plain "
              "apply on the CPU"),
    "segment_len": (None, "10 (cache/env only)"),
    "gp_batch": (("batched", "solo"),
                 "'batched' (the serving scheduler's knob; not ported)"),
}

_ACTIVE: list = [None]
_ENV_CHECKED: list = [False]

#: (knob, bucket, source, winner) already journaled this process —
#: decisions are journaled once per key, not once per call
_SEEN: set = set()


# ----------------------------------------------------------- env plumbing ----

def _truthy(value: Optional[str]) -> bool:
    return bool(value) and value.strip().lower() in ("1", "on", "true",
                                                     "yes")


def env_override(knob: str) -> Optional[str]:
    """The ``DEAP_TPU_TORCH_TUNE_<KNOB>`` escape hatch, or None."""
    value = os.environ.get(ENV_PREFIX + knob.upper())
    if value is None or not value.strip():
        return None
    return value.strip()


def int_env(name: str, default: int) -> int:
    """Integer threshold override ``DEAP_TPU_TORCH_TUNE_<NAME>`` (the
    ``ND_*_THRESHOLD`` family), falling back to ``default`` on unset
    or unparseable values."""
    value = os.environ.get(ENV_PREFIX + name.upper())
    if value is None or not value.strip():
        return default
    try:
        return int(value)
    except ValueError:
        return default


# ------------------------------------------------------------- activation ----

def enable(cache_dir: Optional[str] = None, *, reps: int = 2,
           strict_identity: bool = False) -> "DispatchTuner":
    """Install a process-wide tuner (a second call replaces the first,
    dropping its session memo)."""
    tuner = DispatchTuner(cache_dir, reps=reps,
                          strict_identity=strict_identity)
    _ACTIVE[0] = tuner
    _ENV_CHECKED[0] = True
    return tuner


def disable() -> None:
    """Remove the active tuner; also blocks the ``DEAP_TPU_TORCH_TUNE``
    env auto-enable for the rest of the process."""
    _ACTIVE[0] = None
    _ENV_CHECKED[0] = True


def active_tuner() -> Optional["DispatchTuner"]:
    """The installed tuner, auto-creating one on first call when
    ``DEAP_TPU_TORCH_TUNE`` is truthy. None == every decision point uses
    its static default."""
    tuner = _ACTIVE[0]
    if tuner is not None:
        return tuner
    if not _ENV_CHECKED[0]:
        _ENV_CHECKED[0] = True
        if _truthy(os.environ.get(ENV_ENABLE)):
            _ACTIVE[0] = DispatchTuner()
            return _ACTIVE[0]
    return None


def _reset_for_tests() -> None:
    """Forget activation latches and journal dedup (test isolation)."""
    _ACTIVE[0] = None
    _ENV_CHECKED[0] = False
    _SEEN.clear()


# ------------------------------------------------------------- inspection ----

def is_concrete(*trees: Any) -> bool:
    """False while a CUDA graph is being captured on the current stream
    (nothing may run for timing then, and the ladder stops at the
    cache); True otherwise. The trees are accepted for the JAX package's
    signature: a tensor is always concrete."""
    del trees
    return not (torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())


def shape_bucket(n: int) -> int:
    """Pow-2 ceiling — the shape-bucket component of tuning keys, so a
    pop of 4000 and 4096 share one probed winner."""
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def _device(device=None) -> torch.device:
    """The device a decision is for: ``device``, else the current card
    where there is one, else the CPU."""
    if device is not None:
        return torch.device(device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _journal(knob: str, bucket: Tuple, **payload: Any) -> None:
    from deap_tpu_torch.telemetry.journal import broadcast

    broadcast("tuning_decision", knob=knob,
              bucket="/".join(str(b) for b in bucket), **payload)


def _journal_once(knob: str, bucket: Tuple, **payload: Any) -> None:
    token = (knob, tuple(bucket), payload.get("source"),
             payload.get("winner"))
    if token in _SEEN:
        return
    _SEEN.add(token)
    _journal(knob, bucket, **payload)


def _leaf_bytes(leaf: Any) -> Tuple:
    """(shape, dtype, raw bytes) of one result leaf: a NaN equals a NaN
    of the same bits."""
    if isinstance(leaf, torch.Tensor):
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        return (tuple(leaf.shape), str(leaf.dtype),
                raw.cpu().numpy().tobytes())
    if isinstance(leaf, (np.ndarray, np.generic, bool, int, float)):
        a = np.asarray(leaf)
        return a.shape, str(a.dtype), a.tobytes()
    return (), type(leaf).__name__, repr(leaf).encode()


# ------------------------------------------------------------ the tuner ----

class DispatchTuner:
    """Probe-and-persist winner selection for one process.

    ``reps`` is the best-of-reps timing count after the warm-up call
    (which pays any build and is excluded). ``strict_identity=True``
    turns an identity failure into a raise instead of a journaled
    fallback."""

    def __init__(self, cache: Any = None, *, reps: int = 2,
                 strict_identity: bool = False):
        self.cache = (cache if isinstance(cache, TuningCache)
                      else TuningCache(cache))
        self.reps = max(int(reps), 1)
        self.strict_identity = bool(strict_identity)
        #: key -> winner, the in-process memo (one probe / file read per
        #: key per process)
        self._session: Dict[str, str] = {}

    # ------------------------------------------------------------- keys ----

    def stamp(self) -> Dict[str, Any]:
        return {"format": CACHE_FORMAT, "torch": torch.__version__,
                "cuda": torch.version.cuda}

    def key_for(self, knob: str, bucket: Sequence[Any],
                device=None) -> str:
        """``<device type>/<device name>/<knob>/<bucket...>``: the card's
        name (spaces as ``_``) on ``cuda``, ``cpu`` on the CPU."""
        dev = _device(device)
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else dev.type)
        parts = [dev.type, name.replace(" ", "_"), str(knob)]
        return "/".join(parts + [str(b) for b in bucket])

    # ---------------------------------------------------------- deciding ----

    def decide(self, knob: str, *, bucket: Tuple, default: str,
               candidates: Optional[Dict[str, Any]] = None,
               check: Any = "bitwise", program: Optional[str] = None,
               device=None) -> str:
        """Cache → probe → static, returning the winning candidate name.
        ``candidates`` maps name -> zero-arg probe fn, ``(fn, weight)``
        (timing divided by ``weight``), or ``None`` when this call site
        cannot probe."""
        dev = _device(device)
        key = self.key_for(knob, bucket, dev)
        memo = self._session.get(key)
        if memo is not None:
            return memo
        names = tuple(candidates) if candidates else ()
        entry = self.cache.get(key, stamp=self.stamp())
        if entry is not None and (not names
                                  or entry.get("winner") in names):
            winner = str(entry["winner"])
            _journal_once(knob, bucket, source="cache", winner=winner,
                          default=default, cache_hit=True,
                          probe_s=entry.get("probe_s"), program=program)
            self._session[key] = winner
            return winner
        probeable = bool(candidates) and all(
            callable(c[0] if isinstance(c, tuple) else c)
            for c in candidates.values())
        if not probeable:
            # not memoised: a later call that can probe on the same key
            # should still get its chance
            _journal_once(knob, bucket, source="static", winner=default,
                          default=default, cache_hit=False,
                          program=program)
            return default
        winner, timings, probe_s, identity, errors = self._probe(
            candidates, check, dev)
        extra = {"errors": errors} if errors else {}
        if errors and dev.type == "cuda":
            _journal(knob, bucket, source="static", winner=default,
                     default=default, cache_hit=False, timings=timings,
                     probe_s=round(probe_s, 6), identity=identity,
                     reason="candidate failed", program=program, **extra)
            raise RuntimeError(
                f"tuning probe for {knob!r} {bucket!r} on {dev}: "
                f"candidates {sorted(errors)} failed: {errors}")
        if winner is None or identity == "failed":
            reason = ("identity" if identity == "failed"
                      else "all candidates failed")
            if identity == "failed" and self.strict_identity:
                raise AssertionError(
                    f"tuning probe for {knob!r} {bucket!r}: candidates "
                    "disagree — refusing to pick a winner")
            _journal(knob, bucket, source="static", winner=default,
                     default=default, cache_hit=False, timings=timings,
                     probe_s=round(probe_s, 6), identity=identity,
                     reason=reason, program=program, **extra)
            self._session[key] = default
            return default
        if errors:
            # a winner by default is this process's alone: never
            # persisted, so a later process probes the key again
            _journal(knob, bucket, source="probe", winner=winner,
                     default=default, cache_hit=False, timings=timings,
                     probe_s=round(probe_s, 6), identity=identity,
                     program=program, persisted=False, **extra)
            self._session[key] = winner
            return winner
        self.record(knob, bucket, winner, timings=timings,
                    probe_s=probe_s, identity=identity, program=program,
                    default=default, device=dev)
        return winner

    def record(self, knob: str, bucket: Tuple, winner: str, *,
               timings: Dict[str, Optional[float]], probe_s: float,
               identity: str = "bitwise",
               program: Optional[str] = None,
               default: Optional[str] = None, device=None) -> None:
        """Persist + journal a measured decision (the tail of
        :meth:`decide`; also the entry point for probes made out of band,
        such as a ``segment_len`` sweep)."""
        key = self.key_for(knob, bucket, device)
        timings = {k: (round(v, 6) if v is not None else None)
                   for k, v in timings.items()}
        self.cache.put(key, {
            "winner": winner,
            "timings": timings,
            "probe_s": round(float(probe_s), 6),
            "identity": identity,
            "program": program,
            "stamp": self.stamp(),
            "recorded_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        })
        _journal(knob, bucket, source="probe", winner=winner,
                 default=default, cache_hit=False, timings=timings,
                 probe_s=round(float(probe_s), 6), identity=identity,
                 program=program)
        self._session[key] = winner

    # ----------------------------------------------------------- probing ----

    def _probe(self, candidates: Dict[str, Any], check: Any,
               device: torch.device):
        """Warm each candidate once, then the best of ``reps`` calls,
        each timed from a synchronised card to its work's end (the card's
        work, not the enqueue)."""
        t0 = time.perf_counter()
        timings: Dict[str, Optional[float]] = {}
        results: Dict[str, Any] = {}
        errors: Dict[str, str] = {}
        for name, cand in candidates.items():
            fn, weight = (cand if isinstance(cand, tuple)
                          else (cand, 1.0))
            try:
                results[name] = fn()  # warm: builds, allocator, caches
                best = float("inf")
                for _ in range(self.reps):
                    _sync(device)
                    t1 = time.perf_counter()
                    fn()
                    _sync(device)
                    best = min(best, time.perf_counter() - t1)
                timings[name] = best / float(weight)
            except Exception as exc:
                # a candidate that cannot run must never win (decide
                # raises on the card)
                results.pop(name, None)
                timings[name] = None
                errors[name] = repr(exc)[:300]
        probe_s = time.perf_counter() - t0
        live = {k: v for k, v in timings.items() if v is not None}
        if not live:
            return None, timings, probe_s, "skipped", errors
        identity = self._check_identity(results, check)
        winner = min(live, key=live.get)
        return winner, timings, probe_s, identity, errors

    @staticmethod
    def _check_identity(results: Dict[str, Any], check: Any) -> str:
        """'bitwise' / 'tolerance' / 'failed' / 'skipped'."""
        if check is None or len(results) < 2:
            return "skipped"
        if callable(check):
            try:
                return "tolerance" if check(results) else "failed"
            except Exception:
                return "failed"
        ref = None
        for res in results.values():
            leaves = [_leaf_bytes(leaf) for leaf in pytree.tree_leaves(res)]
            if ref is None:
                ref = leaves
            elif leaves != ref:
                return "failed"
        return "bitwise"


# ----------------------------------------------------------- entry points ----

def resolve(knob: str, *, bucket: Tuple = (), default: str,
            candidates: Optional[Dict[str, Any]] = None,
            check: Any = "bitwise", program: Optional[str] = None,
            device=None) -> str:
    """The one call every tunable decision point makes — the env /
    cache / probe / static ladder (module docstring). ``device`` is
    where the decision's work runs (default: the current card, else the
    CPU). Returns a candidate name; the caller maps it onto its own
    dispatch."""
    env = env_override(knob)
    if env is not None:
        names = tuple(candidates) if candidates else ()
        if names and env not in names:
            raise ValueError(
                f"{ENV_PREFIX}{knob.upper()}={env!r} is not a valid "
                f"candidate here (expected one of {sorted(names)})")
        _journal_once(knob, bucket, source="env", winner=env,
                      default=default, cache_hit=False, program=program)
        return env
    tuner = active_tuner()
    if tuner is None:
        return default
    return tuner.decide(knob, bucket=bucket, default=default,
                        candidates=candidates, check=check,
                        program=program, device=device)


def resolve_int(knob: str, *, bucket: Tuple = (), default: int,
                program: Optional[str] = None, device=None) -> int:
    """:func:`resolve` for integer-valued knobs (``segment_len``): env /
    cache / static — never probed inline (an integer knob has no
    candidate closures at the call site; a sweep probes and persists it
    out of band through :meth:`DispatchTuner.record`)."""
    winner = resolve(knob, bucket=bucket, default=str(int(default)),
                     candidates=None, check=None, program=program,
                     device=device)
    try:
        value = int(winner)
    except (TypeError, ValueError):
        return int(default)
    return value if value >= 1 else int(default)


def note_hlo_drift(program: str) -> int:
    """Evict every tuning entry recorded against observatory label
    ``program`` — called from ``ProgramObservatory._drift`` when the
    same (label, signature) launches other kernels. The measured winner
    belonged to the old program; re-probe. Returns the eviction count
    (0 when no tuner is active)."""
    tuner = active_tuner()
    if tuner is None:
        return 0
    evicted = tuner.cache.evict_program(str(program))
    if evicted:
        from deap_tpu_torch.telemetry.journal import broadcast

        for key in evicted:
            tuner._session.pop(key, None)
            broadcast("tuning_invalidation", key=key,
                      program=str(program), reason="hlo_drift")
    return len(evicted)
