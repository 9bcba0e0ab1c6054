"""Jobs, tenants and the shape-bucket lattice.

Port of :mod:`deap_tpu.serving.tenant`. A :class:`Job` is what a user
submits: which loop family, which problem (toolbox), a
``torch.Generator``, a generation budget and the per-run knobs. A
:class:`Tenant` is the scheduler's record of one job: its status, its run
directory (checkpoints and accumulated records), its lane while
resident.

**Bucketing.** One engine serves only jobs that share everything shape-
or program-relevant, so jobs are admitted into buckets keyed by
:func:`bucket_key` — loop family, population/state shapes and dtypes,
fitness arity and weights, mu/lambda, the toolbox fingerprint, statistics
fields, probe types, the hall of fame's size, and the device type of the
job's generator (where the JAX package keys the PRNG implementation).
Within a bucket each tenant has its own generator state, initial values,
``ngen`` and cxpb/mutpb.

**Lattice.** :func:`pad_pow2` is the JAX package's lane-count and
key-horizon lattice; the scheduler keeps it for its lane budgets.

**The generator.** Admission snapshots the job's generator state
(:meth:`~deap_tpu_torch.serving.multirun.MultiRunEngine.lane_init`
reads ``get_state()``): the caller's generator is never advanced, and a
tenant's result is defined as the solo run from that state.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from deap_tpu_torch.core.population import Population
from deap_tpu_torch.support.checkpoint import Checkpointer, tree_flatten
from deap_tpu_torch.telemetry.journal import toolbox_fingerprint

__all__ = ["Job", "Tenant", "bucket_key", "pad_pow2"]


def pad_pow2(n: int, cap: Optional[int] = None) -> int:
    """The smallest power of two >= ``n`` (optionally clamped to
    ``cap``) — the lane-count / key-horizon lattice."""
    if n < 1:
        raise ValueError("pad_pow2 needs n >= 1")
    p = 1
    while p < n:
        p *= 2
    if cap is not None:
        p = min(p, int(cap))
    return p


@dataclasses.dataclass
class Job:
    """One evolution job as submitted to the scheduler.

    ``init`` is the founder :class:`Population` (population families),
    the founder genomes (``"gp"``), the stacked demes (``"island"``) or
    the initial strategy state (``ea_generate_update``, which also needs
    ``spec``). ``generator`` is the run's ``torch.Generator``: admission
    reads its state and never advances it. ``hyper`` holds the family's
    per-run knobs (``cxpb``/``mutpb``). ``program`` tags the problem for
    bucketing (default the toolbox fingerprint's digest). ``health`` is a
    per-tenant :class:`~deap_tpu_torch.telemetry.probes.HealthMonitor`
    (never share one across jobs): alarms journal under this tenant's id
    and ``early_stop`` frees the lane at the next segment boundary.
    ``request_id`` is the submitting HTTP request's ``X-Request-Id``
    (None in-process), stamped into this tenant's journal rows; it is not
    part of the bucket key.
    """

    tenant_id: str
    family: str
    toolbox: Any
    generator: torch.Generator
    init: Any
    ngen: int
    hyper: Dict[str, float] = dataclasses.field(default_factory=dict)
    mu: Optional[int] = None
    lambda_: Optional[int] = None
    spec: Any = None
    stats: Any = None
    probes: Tuple = ()
    halloffame_size: int = 0
    health: Any = None
    program: Optional[str] = None
    request_id: Optional[str] = None


def _shape_sig(tree: Any) -> Tuple:
    leaves, _ = tree_flatten(tree)
    return tuple((tuple(leaf.shape), str(leaf.dtype).replace("torch.", ""))
                 for leaf in leaves if isinstance(leaf, torch.Tensor))


def bucket_key(job: Job) -> Tuple:
    """The hashable bucket a job is admitted into: jobs with equal keys
    run through one engine. GP jobs carry no toolbox — their program is
    the ``GpJobSpec`` fingerprint (primitive roster, loop statics,
    dataset), and the spec's static tuple joins the shape signature.
    Island jobs append their topology (n_islands/island_size/freq/mig_k).
    The generator's device type closes every key: a bucket's lanes draw
    on one device."""
    device = ("device", job.generator.device.type)
    if job.family == "gp":
        program = job.program
        if program is None:
            program = job.spec.fingerprint()
        shapes = (("gp",) + job.spec.static_key(), _shape_sig(job.init),
                  device)
        return (job.family, program, shapes, job.mu, job.lambda_,
                (), (), int(job.halloffame_size))
    program = job.program
    if program is None:
        program = toolbox_fingerprint(job.toolbox)["digest"]
    if isinstance(job.init, Population):
        shapes = (("pop", job.init.size, job.init.nobj,
                   tuple(job.init.spec.weights)),
                  _shape_sig(job.init.genomes),
                  _shape_sig(job.init.extras))
    else:
        weights = (tuple(job.spec.weights)
                   if job.spec is not None and job.family != "island"
                   else None)
        shapes = (("state", weights), _shape_sig(job.init))
    if job.family == "island":
        shapes = shapes + (("island",) + job.spec.static_key(),)
    shapes = shapes + (device,)
    stats_fields = (tuple(job.stats.fields)
                    if job.stats is not None else ())
    probe_types = tuple(type(p).__name__ for p in job.probes)
    return (job.family, program, shapes, job.mu, job.lambda_,
            stats_fields, probe_types, int(job.halloffame_size))


class Tenant:
    """Runtime record of one admitted job.

    Owns the tenant's run directory (``<root>/tenants/<id>/``) whose
    checkpoints are the scheduler's swap unit: :meth:`checkpoint` writes
    the lane (its generator state included) and the records so far with
    ``tenant_id`` in the meta, :meth:`restore` reads the newest valid
    checkpoint back *filtered on that id* — co-located or misconfigured
    tenant directories never cross-restore
    (``Checkpointer.restore_latest(tenant_id=...)``).
    """

    #: admission/run states
    QUEUED, RUNNING, FINISHED, STOPPED = \
        "queued", "running", "finished", "stopped"

    def __init__(self, job: Job, root: str):
        self.job = job
        self.id = job.tenant_id
        self.run_dir = os.path.join(root, "tenants", str(job.tenant_id))
        self.status = self.QUEUED
        self.gen = 0
        self.slot: Optional[int] = None
        self.segments_resident = 0
        self.lane: Optional[Dict[str, Any]] = None
        self.record_chunks: List[Any] = []
        self.result: Optional[tuple] = None
        self.stopped_at: Optional[int] = None
        self.has_checkpoint = False
        # when this tenant last joined the queue (submission or
        # eviction), for the queue-wait SLO; monotonic
        self.enqueued_at = time.monotonic()
        # the generation count at the last client interaction (poll,
        # stream read, status): the autoscaler's idleness signal
        self._interact_gen = 0
        self._ckpt: Optional[Checkpointer] = None

    def note_interaction(self) -> None:
        """A client touched this tenant — resets the idleness clock
        (written by the service's driver thread)."""
        self._interact_gen = self.gen

    @property
    def gens_since_interaction(self) -> int:
        """Generations advanced since a client last interacted — the
        spill actuator's idleness signal."""
        return max(0, self.gen - self._interact_gen)

    @property
    def ckpt(self) -> Checkpointer:
        if self._ckpt is None:
            # fsync=False: tenants checkpoint every boundary, and a
            # service kill leaves the page cache intact
            self._ckpt = Checkpointer(
                os.path.join(self.run_dir, "ckpt"), keep=2, fsync=False)
        return self._ckpt

    @property
    def done(self) -> bool:
        return self.status in (self.FINISHED, self.STOPPED)

    def checkpoint(self, engine, meta: Optional[Dict[str, Any]] = None
                   ) -> str:
        """Persist the swap unit: the lane and the records so far, keyed
        by the completed-generation count, ``tenant_id`` in the meta."""
        records = engine.concat_records(self.record_chunks)
        state = {"lane": self.lane, "records": records,
                 "family": engine.family}
        m = {"tenant_id": self.id, "gen": self.gen,
             "ngen": int(self.job.ngen), **(meta or {})}
        rid = getattr(self.job, "request_id", None)
        if rid and "request_id" not in m:
            m["request_id"] = rid
        path = self.ckpt.save(self.gen, state, meta=m)
        self.has_checkpoint = True
        return path

    def probe_checkpoint(self) -> bool:
        """True when this tenant's run dir already holds a checkpoint
        stamped with its id (an earlier process checkpointed it, e.g. a
        service drain); sets ``has_checkpoint`` so admission resumes.
        Fresh tenants take the stat-only path."""
        if not os.path.isdir(os.path.join(self.run_dir, "ckpt")):
            return False
        from deap_tpu_torch.support.checkpoint import checkpoint_meta
        for step in reversed(self.ckpt.steps()):
            try:
                meta = checkpoint_meta(self.ckpt.path_for(step)) or {}
            except Exception:
                continue
            if meta.get("tenant_id") == self.id:
                self.has_checkpoint = True
                return True
        return False

    def restore(self, engine) -> None:
        """Load the newest valid checkpoint *for this tenant* onto the
        engine's device (the resume half of the swap)."""
        got = self.ckpt.restore_latest(tenant_id=self.id,
                                       device=engine.device)
        if got is None:
            raise FileNotFoundError(
                f"tenant {self.id}: no checkpoint under "
                f"{self.ckpt.directory}")
        step, state = got
        if state.get("family") != engine.family:
            raise ValueError(
                f"tenant {self.id}: checkpoint family "
                f"{state.get('family')!r} != bucket {engine.family!r}")
        self.lane = state["lane"]
        self.record_chunks = ([] if state["records"] is None
                              else [state["records"]])
        self.gen = int(step)

    def evict(self) -> None:
        self.status = self.QUEUED
        self.slot = None
        self.lane = None          # the swap unit is on disk
        self.record_chunks = []   # rolled into the checkpoint
        self.segments_resident = 0
        self.enqueued_at = time.monotonic()
