"""Autoscaling control loop — SLO metrics in, lane budgets out.

A copy of :mod:`deap_tpu.serving.autoscale` (standard library only).
The decision half of the service plane's control loop. The scheduler
already *measures* everything an autoscaler needs (queue depth,
queue-wait p99, lane occupancy per bucket — :meth:`deap_tpu_torch.
serving.scheduler.Scheduler.slo_snapshot`); this module turns those readings
into actions:

- **lane counts** — double a bucket's lane budget under sustained
  queue pressure, halve it under sustained idleness (pow-2 moves keep
  every setting on the lane lattice);
- **prewarm targets** — when pressure first appears, predict the next
  lattice point and warm it *before* the scale-up lands (the
  controller routes these through ``serving.prewarm``);
- **spill list** — under pressure with full lanes, long-resident
  tenants are swapped out to checkpoint (the scheduler's existing
  eviction machinery; spill just requests it ahead of the fairness
  quantum).

**Hysteresis, not thresholds.** Every action requires the triggering
condition to hold for N *consecutive* observations (``up_after`` /
``down_after``), and any applied change starts a per-bucket
``cooldown`` during which the bucket is left alone. An oscillating
queue depth (burst, empty, burst, …) therefore never flaps the lane
budget — pinned by ``tests/test_torch_service.py``, which drives this
module as a pure unit: synthetic snapshots in, decisions out, no
sockets, no torch (this file imports only the standard library).

The policy is deliberately separate from its actuation: the
:class:`~deap_tpu_torch.serving.service.EvolutionService` driver thread owns
applying decisions to the scheduler and journaling each one as an
``autoscale_decision`` event.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

__all__ = ["AutoscaleConfig", "AutoscaleDecision", "AutoscalePolicy"]


@dataclasses.dataclass
class AutoscaleConfig:
    """Knobs of the control loop (documented in
    ``docs/advanced/serving.md``). Defaults are deliberately
    conservative: two consecutive pressured reads to scale up, three
    idle reads to scale down, two ticks of cooldown after any move."""

    #: lane-budget bounds (pad_pow2'd by the scheduler on apply)
    min_lanes: int = 1
    max_lanes: int = 64
    #: pressure = queue_depth >= queue_high, or queue-wait p99 above
    #: wait_p99_high seconds (when the histogram has data)
    queue_high: int = 1
    wait_p99_high: float = 1.0
    #: idle = zero queue and occupancy at or below occupancy_low
    occupancy_low: float = 0.5
    #: consecutive observations required before acting
    up_after: int = 2
    down_after: int = 3
    #: ticks a bucket is left alone after any applied change
    cooldown: int = 2
    #: a resident this many segments old is spillable under pressure
    spill_idle_segments: int = 4
    #: when the snapshot carries the true idleness signal
    #: (``gens_since_interaction``, the third element of each ``idle``
    #: tuple), a resident is spillable only after this many
    #: generations without a client interaction — mid-job residents
    #: whose clients are long-polling (gens-idle ~0) are never
    #: spilled, no matter how long they have held a lane (the
    #: spill-thrash fix: residency age alone spilled busy tenants)
    spill_idle_gens: int = 1
    #: emit a prewarm target for the next lattice point as soon as
    #: pressure is first observed (one step ahead of the scale-up)
    prewarm_ahead: bool = True


@dataclasses.dataclass
class AutoscaleDecision:
    """One tick's actions. Empty lists/dicts mean "leave everything
    alone" — the controller only journals non-trivial decisions."""

    #: bucket label -> new lane budget (only buckets that change)
    lane_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: (bucket label, lane count) programs to compile ahead of need
    prewarm: List[Tuple[str, int]] = dataclasses.field(
        default_factory=list)
    #: tenant ids to swap out to checkpoint (pressure relief)
    spill: List[str] = dataclasses.field(default_factory=list)
    #: bucket label -> human-readable reason (journaled)
    reasons: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __bool__(self) -> bool:
        return bool(self.lane_counts or self.prewarm or self.spill)


class _BucketCtl:
    """Per-bucket hysteresis state."""

    __slots__ = ("over", "under", "cooldown", "prewarmed")

    def __init__(self):
        self.over = 0       # consecutive pressured observations
        self.under = 0      # consecutive idle observations
        self.cooldown = 0   # ticks until this bucket may act again
        self.prewarmed = set()  # lane counts already targeted


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class AutoscalePolicy:
    """The pure decision function, with its hysteresis memory.

    ``decide`` consumes one snapshot — a mapping of bucket label to a
    stats dict with at least ``queue_depth``, ``occupancy``, ``lanes``
    and optionally ``queue_wait_p99`` (seconds or None) and ``idle``
    (iterable of ``(tenant_id, segments_resident)``) — exactly what
    :meth:`Scheduler.slo_snapshot` returns — and yields an
    :class:`AutoscaleDecision`. No clocks, no I/O: feeding the same
    snapshot sequence always yields the same decision sequence."""

    def __init__(self, config: Optional[AutoscaleConfig] = None):
        self.config = config or AutoscaleConfig()
        self._ctl: Dict[str, _BucketCtl] = {}

    # ------------------------------------------------------------------

    def _pressured(self, stats: Mapping[str, Any]) -> bool:
        cfg = self.config
        if int(stats.get("queue_depth", 0)) >= cfg.queue_high:
            return True
        p99 = stats.get("queue_wait_p99")
        return p99 is not None and float(p99) > cfg.wait_p99_high

    def _idle(self, stats: Mapping[str, Any]) -> bool:
        cfg = self.config
        return (int(stats.get("queue_depth", 0)) == 0
                and float(stats.get("occupancy", 0.0))
                <= cfg.occupancy_low)

    def decide(self, snapshot: Mapping[str, Mapping[str, Any]]
               ) -> AutoscaleDecision:
        cfg = self.config
        d = AutoscaleDecision()
        for label, stats in snapshot.items():
            ctl = self._ctl.setdefault(label, _BucketCtl())
            lanes = int(stats.get("lanes", 1))
            pressured = self._pressured(stats)
            idle = self._idle(stats)
            if ctl.cooldown > 0:
                # a bucket in cooldown is left alone AND its counters
                # stay frozen — observations during cooldown never
                # accumulate toward the next trigger
                ctl.cooldown -= 1
                ctl.over = ctl.under = 0
                continue
            # consecutive-observation counters: any break resets — an
            # oscillating signal never accumulates to a trigger
            ctl.over = ctl.over + 1 if pressured else 0
            ctl.under = ctl.under + 1 if idle else 0
            if pressured:
                target = min(_pow2(lanes) * 2, _pow2(cfg.max_lanes))
                if cfg.prewarm_ahead and target > lanes \
                        and target not in ctl.prewarmed:
                    # predict the lattice point one tick ahead of the
                    # scale-up so the compile is off the critical path
                    ctl.prewarmed.add(target)
                    d.prewarm.append((label, target))
                if ctl.over >= cfg.up_after:
                    if target > lanes:
                        d.lane_counts[label] = target
                        d.reasons[label] = (
                            f"scale_up: queue_depth="
                            f"{stats.get('queue_depth')} wait_p99="
                            f"{stats.get('queue_wait_p99')} for "
                            f"{ctl.over} ticks")
                        ctl.cooldown = cfg.cooldown
                        ctl.over = 0
                    elif float(stats.get("occupancy", 0.0)) >= 1.0:
                        # at the lane ceiling with a queue: relieve
                        # pressure by spilling genuinely idle tenants
                        # — gens-since-interaction first (a parked
                        # ask-tell tenant nobody polls), residency age
                        # as the tie-break / legacy 2-tuple fallback
                        def _spillable(t):
                            if t[1] < cfg.spill_idle_segments:
                                return False
                            return (len(t) < 3
                                    or t[2] >= cfg.spill_idle_gens)

                        spillable = sorted(
                            (t for t in stats.get("idle", ())
                             if _spillable(t)),
                            key=lambda t: (-(t[2] if len(t) > 2
                                             else t[1]), -t[1]))
                        take = spillable[:int(stats["queue_depth"])]
                        if take:
                            d.spill.extend(t[0] for t in take)
                            d.reasons[label] = (
                                f"spill: at max_lanes={lanes} with "
                                f"queue_depth={stats['queue_depth']}")
                            ctl.cooldown = cfg.cooldown
                            ctl.over = 0
            elif ctl.under >= cfg.down_after:
                target = max(_pow2(lanes) // 2,
                             _pow2(max(1, cfg.min_lanes)))
                if target < lanes:
                    d.lane_counts[label] = target
                    d.reasons[label] = (
                        f"scale_down: idle (occupancy="
                        f"{stats.get('occupancy'):.2f}) for "
                        f"{ctl.under} ticks")
                    ctl.cooldown = cfg.cooldown
                    ctl.under = 0
        return d
