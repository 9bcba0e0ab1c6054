"""DrainSignal — SIGTERM/SIGINT → one graceful-drain callback.

A copy of :mod:`deap_tpu.resilience.drain` (standard library only). The
service-plane sibling of :class:`~deap_tpu_torch.resilience.engine.
ResilientRun`'s signal guard: where the resilient runner turns a signal
into "finish the in-flight segment, checkpoint, raise
:class:`Preempted`", a server turns it into "stop admitting, finish the
in-flight segment, checkpoint every tenant, exit" (the service is
ROADMAP A13). This helper owns only the signal plumbing:

- install from the **main thread only** (CPython delivers signals
  there; installing elsewhere raises ``ValueError`` — surfaced, not
  swallowed, unless ``strict=False``);
- the handler body is minimal and reentrancy-safe: it sets a flag and
  invokes the callback **once** (a second SIGTERM during a slow drain
  doesn't re-enter it) — so callbacks must themselves be
  non-blocking (``service.drain(wait=False)`` is);
- previous handlers are saved and restored by :meth:`uninstall` /
  context-manager exit, so a test harness's (or pytest's) own
  handlers survive.
"""

from __future__ import annotations

import signal
import threading
from typing import Callable, Dict, Iterable, Optional

__all__ = ["DrainSignal"]


class DrainSignal:
    """Route ``signals`` (default SIGTERM + SIGINT) to ``callback``
    exactly once::

        ds = DrainSignal(lambda signum: service.drain(wait=False))
        with ds:                  # or ds.install() / ds.uninstall()
            serve_forever()
    """

    def __init__(self, callback: Callable[[int], None],
                 signals: Iterable[int] = (signal.SIGTERM,
                                           signal.SIGINT),
                 strict: bool = True):
        self.callback = callback
        self.signals = tuple(signals)
        self.strict = bool(strict)
        self.fired: Optional[int] = None  # signum that triggered
        self._prev: Dict[int, object] = {}
        self._installed = False

    def _handler(self, signum, frame):
        if self.fired is not None:
            return  # drain already in flight; stay quiet
        self.fired = signum
        self.callback(signum)

    def install(self) -> "DrainSignal":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            if self.strict:
                raise RuntimeError(
                    "DrainSignal.install() must run on the main "
                    "thread (CPython delivers signals there)")
            return self
        for sig in self.signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()
        self._installed = False

    def __enter__(self) -> "DrainSignal":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
