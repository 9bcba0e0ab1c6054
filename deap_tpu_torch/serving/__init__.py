"""Multi-tenant evolution serving — the run axis, the scheduler and the
network service.

Port of :mod:`deap_tpu.serving` (ROADMAP A13a):

- :mod:`~deap_tpu_torch.serving.multirun` and
  :mod:`~deap_tpu_torch.serving.gp_multirun` — the **run axis**: N
  independent runs (their own generators, hyperparameters and
  generation budgets) advance together, one batched pass a generation
  (one K1 plane over every lane's rows, one J1 launch over every CMA-ES
  lane's matrix, one K9 evaluation over every GP lane's trees), each
  lane bit for bit its solo loop;
- :mod:`~deap_tpu_torch.serving.scheduler` — the **ask-tell serving
  layer**: admission into shape buckets, lane budgets, segment-cadence
  execution, per-tenant eviction/resume with checkpoints as the swap
  unit;
- :mod:`~deap_tpu_torch.serving.service` — the **network service**: a
  stdlib HTTP/JSON front end (driver-thread queue handoff, bearer auth
  and quotas, NDJSON streaming, the admission WAL, graceful drain) with
  the :mod:`~deap_tpu_torch.serving.autoscale` control loop, the
  known-answer :mod:`~deap_tpu_torch.serving.canary` and the stdlib
  :mod:`~deap_tpu_torch.serving.client`.

Live migration, traffic replay and the chaos harness (the JAX package's
``migration``, ``loadgen`` and ``chaos``) are ROADMAP A13b.
"""

from deap_tpu_torch.serving.multirun import FAMILIES, MultiRunEngine, multirun
from deap_tpu_torch.serving.gp_multirun import (
    GpJobSpec,
    GpMultiRunEngine,
    IslandJobSpec,
    IslandMultiRunEngine,
)
from deap_tpu_torch.serving.tenant import (
    Job,
    Tenant,
    bucket_key,
    pad_pow2,
)
from deap_tpu_torch.serving.scheduler import (
    Scheduler,
    SchedulerBusyError,
    prewarm,
)
from deap_tpu_torch.serving.autoscale import (
    AutoscaleConfig,
    AutoscaleDecision,
    AutoscalePolicy,
)
from deap_tpu_torch.serving.service import EvolutionService
from deap_tpu_torch.serving.client import (
    ClientAbandoned,
    ServiceClient,
    ServiceError,
)
from deap_tpu_torch.serving.wal import AdmissionWAL, scan_wal
from deap_tpu_torch.support.compilecache import enable_compile_cache

__all__ = [
    "AdmissionWAL",
    "AutoscaleConfig",
    "AutoscaleDecision",
    "AutoscalePolicy",
    "ClientAbandoned",
    "EvolutionService",
    "FAMILIES",
    "GpJobSpec",
    "GpMultiRunEngine",
    "IslandJobSpec",
    "IslandMultiRunEngine",
    "Job",
    "MultiRunEngine",
    "Scheduler",
    "SchedulerBusyError",
    "ServiceClient",
    "ServiceError",
    "Tenant",
    "bucket_key",
    "enable_compile_cache",
    "multirun",
    "pad_pow2",
    "prewarm",
    "scan_wal",
]
