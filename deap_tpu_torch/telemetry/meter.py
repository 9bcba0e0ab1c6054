"""Metrics plane — counters, gauges and histograms as device state.

Port of :mod:`deap_tpu.telemetry.meter`. A :class:`Meter` declares a
fixed set of metrics; its ``init()`` state is a flat dict of tensors on
the run's device, and ``inc`` / ``set`` / ``observe`` are functional
updates that return a new dict. The JAX meter rides a ``lax.scan``'s
carry and its rows come back in one transfer after the scan; the port's
loops are Python loops, so each generation's state stays on the device,
:meth:`Meter.stack` stacks them into ``[ngen, ...]`` tensors when the
loop ends, and :meth:`Meter.rows` copies them to the host in one
transfer (every metric's bytes packed into one buffer). No update reads
a value back, so a generation with telemetry waits for the card no more
than one without (:meth:`stream` is the exception, and off by
default).

Telemetry must never change computed results: meter updates read the
population but draw nothing and feed nothing back.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from deap_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["Meter", "MeterState", "mean_f32"]

MeterState = Dict[str, torch.Tensor]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def mean_f32(x: torch.Tensor, dim=None) -> torch.Tensor:
    """The float32 mean as the JAX package's ``jnp.mean`` computes it: the
    sum times the float32 reciprocal of the count (XLA folds the division
    by a constant into that product), so means of exact sums (counts,
    integer fitness) equal the JAX package's bit for bit."""
    x = x.to(torch.float32)
    n = x.numel() if dim is None else x.shape[dim]
    s = x.sum() if dim is None else x.sum(dim)
    return s * float(np.float32(1) / np.float32(max(n, 1)))


class Meter:
    """Declarative metric registry with a dict-of-tensors state.

    Declare every metric before ``init()``::

        meter = Meter()
        meter.counter("nevals")
        meter.gauge("best")
        meter.histogram("fitness", lo=0.0, hi=100.0, bins=16)
        state = meter.init(device="cuda")
        state = meter.inc(state, "nevals", (~pop.valid).sum())
        state = meter.set(state, "best", pop.wvalues[:, 0].max())
        state = meter.observe(state, "fitness", pop.wvalues[:, 0])

    Counters are cumulative; gauges hold the last value set; histograms
    accumulate bucket counts over ``[lo, hi)`` (under- and overflow
    clamp into the edge buckets, so totals are conserved).

    ``host_copies`` counts the device-to-host transfers :meth:`row` and
    :meth:`rows` made.
    """

    def __init__(self):
        self._specs: Dict[str, dict] = {}
        self.host_copies = 0

    # ------------------------------------------------------- declaration ----

    def _declare(self, name: str, **spec) -> None:
        prev = self._specs.get(name)
        if prev is not None:
            if prev != spec:
                raise ValueError(
                    f"metric {name!r} re-declared with a different spec: "
                    f"{prev} vs {spec}")
            return  # idempotent: loops and probes may both declare
        self._specs[name] = spec

    def counter(self, name: str, shape: Sequence[int] = (),
                dtype=torch.int32, internal: bool = False) -> None:
        self._declare(name, kind="counter", shape=tuple(shape),
                      dtype=_dtype_name(dtype), internal=bool(internal))

    def gauge(self, name: str, shape: Sequence[int] = (),
              dtype=torch.float32, internal: bool = False) -> None:
        """``internal=True`` marks carry-only state (a probe's previous
        best, a per-individual lineage array): it lives in the state like
        any gauge but :meth:`row` / :meth:`rows` leave it out."""
        self._declare(name, kind="gauge", shape=tuple(shape),
                      dtype=_dtype_name(dtype), internal=bool(internal))

    def histogram(self, name: str, lo: float, hi: float,
                  bins: int = 16) -> None:
        if not hi > lo:
            raise ValueError(f"histogram {name!r}: need hi > lo, "
                             f"got [{lo}, {hi})")
        self._declare(name, kind="histogram", lo=float(lo), hi=float(hi),
                      bins=int(bins))

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(self._specs)

    def spec(self, name: str) -> dict:
        return dict(self._specs[name])

    # ------------------------------------------------------------- state ----

    def init(self, device: DeviceLike = None) -> MeterState:
        """Zeroed state on ``device`` (the card unless ``device="cpu"``)."""
        dev = resolve_device(device)
        state: MeterState = {}
        for name, s in self._specs.items():
            if s["kind"] == "histogram":
                state[name] = torch.zeros((s["bins"],), dtype=torch.int32,
                                          device=dev)
            else:
                state[name] = torch.zeros(s["shape"],
                                          dtype=getattr(torch, s["dtype"]),
                                          device=dev)
        return state

    def _check(self, name: str, kind: str) -> dict:
        s = self._specs.get(name)
        if s is None:
            raise KeyError(f"metric {name!r} was never declared "
                           f"(known: {sorted(self._specs)})")
        if s["kind"] != kind:
            raise TypeError(f"metric {name!r} is a {s['kind']}, "
                            f"not a {kind}")
        return s

    @staticmethod
    def _value(value, dtype: torch.dtype, like: torch.Tensor) -> torch.Tensor:
        """``value`` as a new tensor of ``dtype`` on ``like``'s device; a
        Python number is filled in place there, never copied from the
        host (a pageable copy would wait for the card)."""
        if isinstance(value, torch.Tensor):
            return value.to(device=like.device, dtype=dtype, copy=True)
        return torch.full((), value, dtype=dtype, device=like.device)

    # --------------------------------------------------------- updates ----

    def inc(self, state: MeterState, name: str, value=1) -> MeterState:
        s = self._check(name, "counter")
        cur = state[name]
        return {**state, name: cur + self._value(
            value, getattr(torch, s["dtype"]), cur)}

    def set(self, state: MeterState, name: str, value) -> MeterState:
        s = self._check(name, "gauge")
        cur = state[name]
        v = self._value(value, getattr(torch, s["dtype"]), cur)
        return {**state, name: v.expand(s["shape"]).clone()}

    def observe(self, state: MeterState, name: str, values,
                mask=None) -> MeterState:
        """Bucketize ``values`` into the histogram's counts; ``mask``
        (same shape) drops rows without changing bucket geometry. The
        index divides by ``hi - lo`` as a 0-d tensor: PyTorch's CUDA
        kernels multiply by a Python number's reciprocal instead, which
        puts a value next to an edge in another bucket than the JAX
        package's true division. NaN lands in bucket 0, as there."""
        s = self._check(name, "histogram")
        cur = state[name]
        v = torch.as_tensor(values).reshape(-1).to(device=cur.device,
                                                  dtype=torch.float32)
        bins, lo, hi = s["bins"], s["lo"], s["hi"]
        width = torch.full((), hi - lo, dtype=torch.float32, device=cur.device)
        pos = torch.floor((v - lo) / width * bins)
        pos = torch.nan_to_num(pos, nan=0.0)  # XLA converts NaN to 0
        idx = pos.clamp(0, bins - 1).to(torch.int64)
        ones = torch.ones_like(idx, dtype=torch.int32)
        if mask is not None:
            m = torch.as_tensor(mask).reshape(-1).to(cur.device)
            ones = torch.where(m, ones, torch.zeros_like(ones))
        return {**state, name: cur.index_add(0, idx, ones)}

    # --------------------------------------------------------- streaming ----

    def stream(self, state: MeterState, gen, emit: Callable) -> None:
        """Opt-in live tail: copy this generation's state to the host now
        (one transfer, which waits for the card) and call ``emit(gen,
        row)``."""
        emit(int(gen), self.row(state))

    def get(self, state: MeterState, name: str) -> torch.Tensor:
        """A metric's current value (probes read carried quantities)."""
        if name not in self._specs:
            raise KeyError(f"metric {name!r} was never declared "
                           f"(known: {sorted(self._specs)})")
        return state[name]

    # ------------------------------------------------------- host decode ----

    def stack(self, states: Sequence[MeterState]) -> Dict[str, torch.Tensor]:
        """Stack per-generation states into ``[ngen, ...]`` tensors on
        their device (``{}`` for no state)."""
        if not states:
            return {}
        return {k: torch.stack([st[k] for st in states])
                for k in states[0]}

    def _host(self, arrays: Mapping[str, Any]) -> Dict[str, np.ndarray]:
        """The arrays as numpy, device tensors copied in one transfer:
        their bytes packed into one buffer on the device."""
        out: Dict[str, np.ndarray] = {}
        dev = [k for k, v in arrays.items()
               if isinstance(v, torch.Tensor) and v.device.type != "cpu"]
        for k, v in arrays.items():
            if k not in dev:
                out[k] = (v.numpy() if isinstance(v, torch.Tensor)
                          else np.asarray(v))
        if dev:
            parts = [arrays[k].contiguous().reshape(-1).view(torch.uint8)
                     for k in dev]
            blob = torch.cat(parts).cpu().numpy()
            self.host_copies += 1
            off = 0
            for k, part in zip(dev, parts):
                t = arrays[k]
                nb = part.numel()
                dt = np.dtype(_dtype_name(t.dtype))
                out[k] = np.frombuffer(blob[off:off + nb].tobytes(),
                                       dtype=dt).reshape(tuple(t.shape))
                off += nb
        return out

    def row(self, state: Mapping[str, Any]) -> Dict[str, Any]:
        """One state as a JSON-serialisable dict (``internal`` metrics
        left out); device tensors cross in one transfer."""
        visible = {n: state[n] for n, s in self._specs.items()
                   if not s.get("internal")}
        arrs = self._host(visible)
        return {n: (arrs[n].item() if arrs[n].ndim == 0
                    else arrs[n].tolist()) for n in visible}

    def rows(self, stacked: Mapping[str, Any], initial: Any = None) -> list:
        """Decode stacked ``[ngen, ...]`` states into per-generation row
        dicts, with ``initial`` (one state) as the first row when given;
        device tensors cross in one transfer."""
        names = [n for n, s in self._specs.items() if not s.get("internal")]
        arrays: Dict[str, Any] = {}
        for n in names:
            parts: List[Any] = []
            if initial is not None:
                parts.append(initial[n][None] if isinstance(
                    initial[n], torch.Tensor) else np.asarray(initial[n])[None])
            if n in stacked:
                parts.append(stacked[n])
            if not parts:
                continue
            if all(isinstance(p, torch.Tensor) for p in parts):
                arrays[n] = torch.cat([p.to(parts[0].device) for p in parts])
            else:
                arrays[n] = np.concatenate([
                    p.cpu().numpy() if isinstance(p, torch.Tensor)
                    else np.asarray(p) for p in parts])
        arrs = self._host(arrays)
        ngen = next(iter(arrs.values())).shape[0] if arrs else 0
        return [{n: (arrs[n][i].item() if arrs[n][i].ndim == 0
                     else arrs[n][i].tolist()) for n in arrays}
                for i in range(ngen)]
