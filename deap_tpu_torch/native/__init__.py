"""Host-side helpers of the port: the exact hypervolume (numpy)."""

from deap_tpu_torch.native.pyhv import hypervolume

__all__ = ["hypervolume"]
