"""Self-tuning dispatch — probe-and-persist winner selection for every
static dispatch knob of the port (see :mod:`deap_tpu_torch.tuning.tuner`
for the protocol and :data:`KNOBS` for the knob table). Port of
:mod:`deap_tpu.tuning`."""

from deap_tpu_torch.tuning.cache import CACHE_FORMAT, TuningCache, default_dir
from deap_tpu_torch.tuning.tuner import (DispatchTuner, KNOBS, active_tuner,
                                         disable, enable, env_override,
                                         int_env, is_concrete, note_hlo_drift,
                                         resolve, resolve_int, shape_bucket)

__all__ = [
    "CACHE_FORMAT", "TuningCache", "default_dir", "DispatchTuner",
    "KNOBS", "active_tuner", "disable", "enable", "env_override",
    "int_env", "is_concrete", "note_hlo_drift", "resolve",
    "resolve_int", "shape_bucket",
]
