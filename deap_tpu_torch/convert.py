"""Carry population, hall-of-fame, Pareto-archive, GP-genome and CMA-ES
family state between the two packages.

The port never imports the JAX package, so state crosses as numpy arrays
plus the weights tuple: ``np.asarray`` of a ``deap_tpu`` ``Population``'s
fields goes in, the port's :class:`Population` comes out, and back. The
tests use it to run both packages on the same state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import Population
from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.strategies.cma import CMAState, MOState, OnePlusLambdaState
from deap_tpu_torch.support.hof import HallOfFame
from deap_tpu_torch.support.pareto import ParetoArchive


def to_tensor(array, device: DeviceLike = None) -> torch.Tensor:
    """A numpy (or numpy-convertible) array as a tensor on ``device``."""
    return torch.from_numpy(np.array(array)).to(resolve_device(device))


def to_numpy(tensor: torch.Tensor) -> np.ndarray:
    return tensor.detach().cpu().numpy()


def population_from_arrays(genomes, fitness, valid, weights: Sequence[float],
                           extras: Optional[Dict[str, Any]] = None,
                           device: DeviceLike = None) -> Population:
    """The port's population from numpy fields (``genomes`` may be a dict
    or tuple of arrays)."""
    conv = lambda a: to_tensor(a, device)
    return Population(genomes=pytree.tree_map(conv, genomes),
                      fitness=conv(fitness), valid=conv(valid),
                      extras=pytree.tree_map(conv, extras or {}),
                      spec=FitnessSpec(weights))


def population_to_arrays(pop: Population) -> Dict[str, Any]:
    """``{genomes, fitness, valid, extras, weights}`` as numpy arrays."""
    return {"genomes": pytree.tree_map(to_numpy, pop.genomes),
            "fitness": to_numpy(pop.fitness),
            "valid": to_numpy(pop.valid),
            "extras": pytree.tree_map(to_numpy, pop.extras),
            "weights": pop.spec.weights}


def hof_from_arrays(genomes, fitness, filled, weights: Sequence[float],
                    device: DeviceLike = None) -> HallOfFame:
    conv = lambda a: to_tensor(a, device)
    return HallOfFame(genomes=pytree.tree_map(conv, genomes),
                      fitness=conv(fitness), filled=conv(filled),
                      spec=FitnessSpec(weights))


def hof_to_arrays(hof: HallOfFame) -> Dict[str, Any]:
    """``{genomes, fitness, filled, weights}`` as numpy arrays."""
    return {"genomes": pytree.tree_map(to_numpy, hof.genomes),
            "fitness": to_numpy(hof.fitness),
            "filled": to_numpy(hof.filled),
            "weights": hof.spec.weights}


def pareto_from_arrays(genomes, fitness, filled, weights: Sequence[float],
                       device: DeviceLike = None) -> ParetoArchive:
    conv = lambda a: to_tensor(a, device)
    return ParetoArchive(genomes=pytree.tree_map(conv, genomes),
                         fitness=conv(fitness), filled=conv(filled),
                         spec=FitnessSpec(weights))


def pareto_to_arrays(archive: ParetoArchive) -> Dict[str, Any]:
    """``{genomes, fitness, filled, weights}`` as numpy arrays."""
    return {"genomes": pytree.tree_map(to_numpy, archive.genomes),
            "fitness": to_numpy(archive.fitness),
            "filled": to_numpy(archive.filled),
            "weights": archive.spec.weights}


_GP_DTYPES = {"nodes": np.int32, "consts": np.float32, "length": np.int32}


def gp_genomes_from_arrays(arrays: Dict[str, Any],
                           device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """The port's GP trees from the JAX package's genome dict (``nodes``
    int32, ``consts`` float32, ``length`` int32, as numpy)."""
    return {k: to_tensor(np.asarray(arrays[k], dtype), device)
            for k, dtype in _GP_DTYPES.items()}


def gp_genomes_to_arrays(genomes: Dict[str, torch.Tensor]
                         ) -> Dict[str, np.ndarray]:
    """The port's GP trees as the JAX package's genome dict of numpy
    arrays."""
    return {k: to_numpy(genomes[k]).astype(dtype, copy=False)
            for k, dtype in _GP_DTYPES.items()}


#: the fields of a CMA-ES state and their dtypes
CMA_FIELDS = {"centroid": np.float32, "sigma": np.float32, "C": np.float32,
              "B": np.float32, "diagD": np.float32, "ps": np.float32,
              "pc": np.float32, "count": np.int32}


def cma_state_from_arrays(centroid, sigma, C, B, diagD, ps, pc, count,
                          device: DeviceLike = None) -> CMAState:
    """The port's CMA-ES state from the JAX package's ``CMAState`` fields
    as numpy arrays (``B`` as the reference computed it, signs and all)."""
    fields = dict(centroid=centroid, sigma=sigma, C=C, B=B, diagD=diagD,
                  ps=ps, pc=pc, count=count)
    return CMAState(**{k: to_tensor(np.asarray(v, CMA_FIELDS[k]), device)
                       for k, v in fields.items()})


def cma_state_to_arrays(state: CMAState) -> Dict[str, np.ndarray]:
    """The CMA-ES state's fields as numpy arrays, by name."""
    return {k: to_numpy(getattr(state, k)) for k in CMA_FIELDS}


#: the fields of a (1+λ)-CMA-ES state and their dtypes
ONE_PLUS_LAMBDA_FIELDS = {"parent": np.float32, "parent_w": np.float32,
                          "sigma": np.float32, "C": np.float32,
                          "A": np.float32, "pc": np.float32,
                          "psucc": np.float32}


def one_plus_lambda_state_from_arrays(parent, parent_w, sigma, C, A, pc,
                                      psucc, device: DeviceLike = None
                                      ) -> OnePlusLambdaState:
    """The port's (1+λ)-CMA-ES state from the JAX package's
    ``OnePlusLambdaState`` fields as numpy arrays."""
    fields = dict(parent=parent, parent_w=parent_w, sigma=sigma, C=C, A=A,
                  pc=pc, psucc=psucc)
    return OnePlusLambdaState(**{
        k: to_tensor(np.asarray(v, ONE_PLUS_LAMBDA_FIELDS[k]), device)
        for k, v in fields.items()})


def one_plus_lambda_state_to_arrays(state: OnePlusLambdaState
                                    ) -> Dict[str, np.ndarray]:
    """The (1+λ)-CMA-ES state's fields as numpy arrays, by name."""
    return {k: to_numpy(getattr(state, k)) for k in ONE_PLUS_LAMBDA_FIELDS}


#: the fields of an MO-CMA-ES state and their dtypes
MO_FIELDS = {"x": np.float32, "w": np.float32, "sigmas": np.float32,
             "A": np.float32, "invA": np.float32, "pc": np.float32,
             "psucc": np.float32}


def mo_state_from_arrays(x, w, sigmas, A, invA, pc, psucc,
                         device: DeviceLike = None) -> MOState:
    """The port's MO-CMA-ES state from the JAX package's ``MOState``
    fields as numpy arrays."""
    fields = dict(x=x, w=w, sigmas=sigmas, A=A, invA=invA, pc=pc,
                  psucc=psucc)
    return MOState(**{k: to_tensor(np.asarray(v, MO_FIELDS[k]), device)
                      for k, v in fields.items()})


def mo_state_to_arrays(state: MOState) -> Dict[str, np.ndarray]:
    """The MO-CMA-ES state's fields as numpy arrays, by name."""
    return {k: to_numpy(getattr(state, k)) for k in MO_FIELDS}
