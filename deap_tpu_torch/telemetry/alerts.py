"""Multi-window burn-rate SLO alerting — pending → firing → resolved.

A copy of the JAX package's ``deap_tpu/telemetry/alerts.py`` (standard
library only): the port keeps its own and never imports that one.

The journal, the windowed SLO curves and the Prometheus instruments
are all *passive*: somebody has to look. This module is the active
half of the observability plane (ISSUE 19): a deterministic,
tick-driven alert state machine in the SRE multi-window burn-rate
style. Each :class:`AlertRule` watches one metric stream (a
:data:`~deap_tpu_torch.telemetry.slo.CURVE_METRICS` name, a per-boundary
sample the service feeds live, or a phase-histogram quantile) over a
**fast/slow window pair**: the fast window makes the alert responsive,
the slow window makes it confident — both must burn for the alert to
fire, which is what keeps one noisy sample from paging anyone.

Definitions, chosen for exactness over journal-row streams (the
"error budget" of a latency SLO is not a counter, so classic
request-ratio burn rates don't apply directly):

- a **sample** is one ``(t, value)`` observation of a rule's metric;
  it *burns* when ``value > threshold``;
- a window's **burn rate** is the burning fraction of the samples
  inside ``(now - window_s, now]`` — ``None`` with no samples
  (absence of evidence never transitions an alert);
- the state machine (per rule, evaluated at :meth:`AlertEngine.tick`):

  ======== ===================================== =========
  from     condition                             to
  ======== ===================================== =========
  inactive fast ≥ burn and slow ≥ burn           firing
  inactive fast ≥ burn (slow not yet)            pending
  pending  fast ≥ burn and slow ≥ burn           firing
  pending  fast < burn (or no fast samples)      inactive
  firing   fast < burn (or no fast samples)      resolved
  resolved (immediately, unjournaled)            inactive
  ======== ===================================== =========

Every transition is journaled as one ``alert`` row and handed to
``on_transition`` (the service updates the ``deap_alert_state`` gauge
there). **Determinism is the design contract**: the engine never
reads a clock — every ``observe``/``tick`` takes an explicit ``t`` —
so the same sample stream and config produce byte-identical journaled
transitions (pinned by ``tests/test_alerts.py``).

Like ``slo.py`` and ``report.py`` this module imports **nothing but
the standard library** and is loadable standalone by file path (no
``deap_tpu_torch`` package, no torch) — the fleet report evaluates journaled
curves through it on boxes that must not initialise a backend.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

__all__ = ["ALERT_STATES", "ALERT_STATE_VALUES", "AlertRule",
           "AlertEngine", "default_rules", "service_rules"]

#: the alert lifecycle (``resolved`` is the one-transition
#: notification state; the engine collapses it to ``inactive`` at the
#: next evaluation without journaling the collapse)
ALERT_STATES = ("inactive", "pending", "firing", "resolved")

#: the ``deap_alert_state{name}`` gauge encoding — resolved is 0 so
#: scrapers see firing alerts, not history
ALERT_STATE_VALUES = {"inactive": 0, "resolved": 0,
                      "pending": 1, "firing": 2}


@dataclass(frozen=True)
class AlertRule:
    """One burn-rate alert: samples of ``metric`` above ``threshold``
    burn; the alert fires when the burning fraction reaches ``burn``
    in BOTH the fast and the slow window."""

    name: str
    metric: str
    threshold: float
    fast_window_s: float = 10.0
    slow_window_s: float = 60.0
    burn: float = 0.5
    description: str = ""

    def __post_init__(self):
        if self.fast_window_s <= 0:
            raise ValueError("fast_window_s must be positive")
        if self.slow_window_s < self.fast_window_s:
            raise ValueError("slow_window_s must be >= fast_window_s "
                             "(the slow window is the confidence "
                             "window)")
        if not 0.0 < self.burn <= 1.0:
            raise ValueError("burn must be in (0, 1]")


def default_rules(fast_window_s: float = 10.0,
                  slow_window_s: float = 60.0) -> tuple:
    """Rules over the windowed-SLO-curve vocabulary (thresholds match
    :data:`deap_tpu_torch.telemetry.slo.DEFAULT_SLOS`) — feed with
    :meth:`AlertEngine.observe_curve`."""
    mk = lambda *a, **kw: AlertRule(  # noqa: E731
        *a, fast_window_s=fast_window_s,
        slow_window_s=slow_window_s, **kw)
    return (
        mk("shed_rate", "shed_rate", 0.05,
           description="over 5% of offered load shed"),
        mk("deadline_miss_rate", "deadline_miss_rate", 0.01,
           description="over 1% of arrivals miss their deadline"),
        mk("queue_wait_p99", "queue_wait_p99", 60.0,
           description="tenants queued over 60 s at p99"),
        mk("segment_p99", "segment_p99", 30.0,
           description="scheduler segments over 30 s at p99"),
    )


def service_rules(fast_window_s: float = 10.0,
                  slow_window_s: float = 60.0) -> tuple:
    """The rules the service driver loop feeds live at every segment
    boundary: the canary's known-answer verdicts plus the boundary's
    shed/deadline-miss deltas. The canary rule's ``burn`` is an
    epsilon: a known-answer failure is an *incident*, not a rate, so
    ANY failing sample in the window fires — even when surrounded by
    passing canaries at a tight cadence — within the same boundary the
    mismatch is detected at (the ≤ 2 boundary detection-latency gate
    of ``bench.py --canary``). It resolves once the fast window is
    clean again."""
    mk = lambda *a, **kw: AlertRule(  # noqa: E731
        *a, fast_window_s=fast_window_s,
        slow_window_s=slow_window_s, **kw)
    return (
        mk("canary_failure", "canary_fail", 0.5, burn=1e-9,
           description="known-answer canary wire-digest mismatch"),
        mk("shed_rate", "shed_rate", 0.05,
           description="over 5% of offered load shed"),
        mk("deadline_miss_rate", "deadline_miss_rate", 0.01,
           description="over 1% of arrivals miss their deadline"),
    )


class AlertEngine:
    """The tick-driven burn-rate state machine over a set of
    :class:`AlertRule`\\ s.

    ``journal`` (a :class:`~deap_tpu_torch.telemetry.journal.RunJournal`,
    duck-typed on ``.event``) receives one ``alert`` row per
    transition; ``on_transition(transition_dict)`` is the metrics
    hook. Feed samples with :meth:`observe` (live) or
    :meth:`observe_curve` (a ``windowed_curve`` result), then
    :meth:`tick` with the evaluation time."""

    def __init__(self, rules: Optional[Iterable[AlertRule]] = None,
                 journal: Any = None,
                 on_transition: Optional[
                     Callable[[Dict[str, Any]], None]] = None):
        self.rules = tuple(default_rules() if rules is None
                           else rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {names}")
        self.journal = journal
        self.on_transition = on_transition
        self._by_metric: Dict[str, List[AlertRule]] = {}
        for r in self.rules:
            self._by_metric.setdefault(r.metric, []).append(r)
        self._samples: Dict[str, List[tuple]] = \
            {r.name: [] for r in self.rules}
        self._state: Dict[str, str] = \
            {r.name: "inactive" for r in self.rules}
        self._since: Dict[str, Optional[float]] = \
            {r.name: None for r in self.rules}
        self._last_burn: Dict[str, tuple] = \
            {r.name: (None, None) for r in self.rules}
        #: the full transition history, in order — the deterministic
        #: artifact the tests pin
        self.transitions: List[Dict[str, Any]] = []

    # -- ingestion -----------------------------------------------------

    def observe(self, t: float, metric: str, value: Any) -> None:
        """One sample of ``metric`` at time ``t``; ``None`` values are
        skipped (an empty window must not look healthy *or* sick)."""
        if value is None:
            return
        for rule in self._by_metric.get(metric, ()):
            self._samples[rule.name].append(
                (float(t), float(value) > rule.threshold))

    def observe_curve(self,
                      windows: Iterable[Dict[str, Any]]) -> None:
        """Feed a :func:`~deap_tpu_torch.telemetry.slo.windowed_curve`
        result: each window's metrics are observed at the window's
        closing edge ``t1``."""
        for w in windows:
            t = w.get("t1", w.get("t0", 0.0))
            for metric in self._by_metric:
                if metric in w:
                    self.observe(t, metric, w[metric])

    # -- evaluation ----------------------------------------------------

    def _burn(self, rule: AlertRule, now: float,
              window_s: float) -> Optional[float]:
        lo = now - window_s
        n = bad = 0
        for t, burning in self._samples[rule.name]:
            if lo < t <= now:
                n += 1
                bad += burning
        return (bad / n) if n else None

    def tick(self, now: float) -> List[Dict[str, Any]]:
        """Evaluate every rule at time ``now``; returns (and records,
        and journals) the transitions this tick produced."""
        now = float(now)
        out: List[Dict[str, Any]] = []
        for rule in self.rules:
            fast = self._burn(rule, now, rule.fast_window_s)
            slow = self._burn(rule, now, rule.slow_window_s)
            self._last_burn[rule.name] = (fast, slow)
            fast_hot = fast is not None and fast >= rule.burn
            slow_hot = slow is not None and slow >= rule.burn
            st = self._state[rule.name]
            if st == "resolved":  # one-tick state; collapse silently
                st = "inactive"
            new = st
            if st == "inactive":
                if fast_hot and slow_hot:
                    new = "firing"
                elif fast_hot:
                    new = "pending"
            elif st == "pending":
                if fast_hot and slow_hot:
                    new = "firing"
                elif not fast_hot:
                    new = "inactive"
            elif st == "firing":
                if not fast_hot:
                    new = "resolved"
            if new != st:
                tr = {"name": rule.name, "metric": rule.metric,
                      "from": st, "to": new, "at": round(now, 6),
                      "fast_burn": (round(fast, 4)
                                    if fast is not None else None),
                      "slow_burn": (round(slow, 4)
                                    if slow is not None else None),
                      "threshold": rule.threshold, "burn": rule.burn}
                self.transitions.append(tr)
                out.append(tr)
                self._since[rule.name] = now
                if self.journal is not None:
                    self.journal.event(
                        "alert", name=tr["name"], state=tr["to"],
                        prev=tr["from"], at=tr["at"],
                        metric=tr["metric"],
                        fast_burn=tr["fast_burn"],
                        slow_burn=tr["slow_burn"],
                        threshold=tr["threshold"], burn=tr["burn"])
                if self.on_transition is not None:
                    self.on_transition(tr)
            self._state[rule.name] = new
            # trim: samples older than the slow window can never
            # matter again (ticks are monotone by contract)
            lo = now - rule.slow_window_s
            buf = self._samples[rule.name]
            if buf and buf[0][0] <= lo:
                self._samples[rule.name] = \
                    [s for s in buf if s[0] > lo]
        return out

    # -- inspection ----------------------------------------------------

    def state(self, name: str) -> str:
        return self._state[name]

    def firing(self) -> List[str]:
        """The names of currently-firing alerts, sorted."""
        return sorted(n for n, s in self._state.items()
                      if s == "firing")

    def snapshot(self) -> List[Dict[str, Any]]:
        """The full ``GET /v1/alerts`` payload: one dict per rule
        (state, windows, last burn rates, since-when)."""
        out = []
        for rule in self.rules:
            fast, slow = self._last_burn[rule.name]
            out.append({
                "name": rule.name, "metric": rule.metric,
                "threshold": rule.threshold, "burn": rule.burn,
                "fast_window_s": rule.fast_window_s,
                "slow_window_s": rule.slow_window_s,
                "state": self._state[rule.name],
                "since": self._since[rule.name],
                "fast_burn": fast, "slow_burn": slow,
                "description": rule.description,
            })
        return out
