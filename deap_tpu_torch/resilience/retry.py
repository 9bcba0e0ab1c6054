"""RetryPolicy — bounded, optionally jittered exponential backoff.

A copy of :mod:`deap_tpu.resilience.retry` (standard library only), so
the port never imports the JAX package: the same policy, the same
seeded jitter, the same schedule for the same seed.

Jitter: retries synchronised across hundreds of clients re-collide on
every attempt (the thundering-herd failure mode of a service restart);
``jitter=0.5`` spreads each delay uniformly over ``[delay*(1-j),
delay*(1+j)]`` using the policy's own seeded ``random.Random`` — the
schedule stays deterministic per (seed, attempt sequence), which is
what lets chaos tests replay exact retry timelines.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional

__all__ = ["RetryPolicy"]


class RetryPolicy:
    """Bounded exponential backoff for transient failures.

    ``delay(attempt)`` is ``backoff_s * backoff_factor**attempt``
    clamped to ``max_backoff_s``, spread by ``jitter`` (fraction, 0 =
    deterministic). ``sleep`` is injectable so tests never wait."""

    def __init__(self, max_retries: int = 2, backoff_s: float = 0.05,
                 backoff_factor: float = 2.0, max_backoff_s: float = 5.0,
                 sleep: Callable[[float], None] = time.sleep,
                 jitter: float = 0.0, seed: Optional[int] = 0):
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_factor = float(backoff_factor)
        self.max_backoff_s = float(max_backoff_s)
        self.sleep = sleep
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def delay(self, attempt: int) -> float:
        base = min(self.backoff_s * self.backoff_factor ** attempt,
                   self.max_backoff_s)
        if not self.jitter:
            return base
        lo = base * (1.0 - self.jitter)
        hi = base * (1.0 + self.jitter)
        return min(lo + (hi - lo) * self._rng.random(),
                   self.max_backoff_s)
