"""Constraint handling — penalty decorators for evaluation functions.

Port of :mod:`deap_tpu.ops.constraint`: :func:`delta_penalty` and
:func:`closest_valid_penalty` wrap a batched evaluate function so that
infeasible rows receive a penalised fitness; feasibility is a boolean
mask and the penalty applies through ``torch.where``. Toolbox use::

    tb.register("evaluate", my_eval)
    tb.decorate("evaluate", delta_penalty(feasible_fn, 7.0, distance_fn,
                                          spec=spec))
"""

from __future__ import annotations

from functools import wraps
from typing import Callable, Optional, Sequence, Union

import torch

from deap_tpu_torch.core.fitness import FitnessSpec

__all__ = ["delta_penalty", "closest_valid_penalty", "DeltaPenalty",
           "DeltaPenality", "ClosestValidPenalty", "ClosestValidPenality"]


def _sign_weights(spec: FitnessSpec, device) -> torch.Tensor:
    """±1 per objective (the reference's ``1 if w >= 0 else -1``)."""
    return torch.where(spec.warray(device) >= 0, 1.0, -1.0)


def _as_obj(values: torch.Tensor, nobj: int) -> torch.Tensor:
    v = torch.as_tensor(values).to(torch.float32)
    if v.ndim == 1:
        v = v[:, None]
    if v.shape[-1] == 1 and nobj > 1:
        v = v.expand(v.shape[:-1] + (nobj,))
    return v


def delta_penalty(feasibility: Callable, delta: Union[float, Sequence[float]],
                  distance: Optional[Callable] = None,
                  spec: FitnessSpec = FitnessSpec((-1.0,))) -> Callable:
    """Penalised fitness ``Δ_i − s_i·d_i(x)`` for infeasible rows, ``s_i``
    the sign of objective ``i``'s weight.

    :param feasibility: batched ``genomes -> bool[n]``.
    :param delta: scalar or per-objective constants, worse than any real
        fitness.
    :param distance: optional batched ``genomes -> f32[n] | f32[n, nobj]``
        growing away from the feasible region.
    """
    nobj = spec.nobj

    def decorator(func):
        @wraps(func)
        def wrapper(genomes, *args, **kwargs):
            values = _as_obj(func(genomes, *args, **kwargs), nobj)
            dev = values.device
            delta_arr = torch.as_tensor(delta, dtype=torch.float32,
                                        device=dev).reshape(-1).expand(nobj)
            feas = feasibility(genomes)
            if distance is not None:
                dists = _as_obj(distance(genomes), nobj)
            else:
                dists = torch.zeros_like(values)
            penal = delta_arr[None, :] - _sign_weights(spec, dev)[None, :] * dists
            return torch.where(feas[:, None], values, penal)

        return wrapper

    return decorator


def closest_valid_penalty(feasibility: Callable, feasible: Callable,
                          alpha: float, distance: Optional[Callable] = None,
                          spec: FitnessSpec = FitnessSpec((-1.0,))
                          ) -> Callable:
    """Penalised fitness ``f_i(valid(x)) − α·s_i·d_i(valid(x), x)`` for
    infeasible rows.

    :param feasible: batched projection ``genomes -> genomes``, the
        closest feasible individual of each row.
    :param distance: optional batched ``(valid_genomes, genomes) -> f32[n]
        | f32[n, nobj]``.
    """
    nobj = spec.nobj

    def decorator(func):
        @wraps(func)
        def wrapper(genomes, *args, **kwargs):
            values = _as_obj(func(genomes, *args, **kwargs), nobj)
            feas = feasibility(genomes)
            projected = feasible(genomes)
            f_fbl = _as_obj(func(projected, *args, **kwargs), nobj)
            if distance is not None:
                dists = _as_obj(distance(projected, genomes), nobj)
            else:
                dists = torch.zeros_like(values)
            signs = _sign_weights(spec, values.device)
            penal = f_fbl - alpha * signs[None, :] * dists
            return torch.where(feas[:, None], values, penal)

        return wrapper

    return decorator


# DEAP-style aliases, including the reference's kept misspellings
DeltaPenalty = delta_penalty
DeltaPenality = delta_penalty
ClosestValidPenalty = closest_valid_penalty
ClosestValidPenality = closest_valid_penalty
