"""Carry population, hall-of-fame, Pareto-archive, GP-genome (one tree
a row, or a tuple of branches), strategy and moving-peaks state between
the two packages.

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

from deap_tpu_torch.benchmarks.movingpeaks import MovingPeaksState
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import Population
from deap_tpu_torch.device import DeviceLike, make_generator, resolve_device
from deap_tpu_torch.strategies.cma import CMAState, MOState, OnePlusLambdaState
from deap_tpu_torch.strategies.eda import EMNAState, PBILState
from deap_tpu_torch.strategies.multiswarm import (MultiSwarmState,
                                                  SpeciationState)
from deap_tpu_torch.strategies.pso import SwarmState
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


def adf_genomes_from_arrays(branches: Sequence[Dict[str, Any]],
                            device: DeviceLike = None):
    """The port's multi-branch (ADF) trees from the JAX package's tuple
    of branch genome dicts. Typed trees are plain genome dicts:
    :func:`gp_genomes_from_arrays` carries them."""
    return tuple(gp_genomes_from_arrays(b, device) for b in branches)


def adf_genomes_to_arrays(genomes) -> tuple:
    """The port's multi-branch trees as the JAX package's tuple of branch
    genome dicts of numpy arrays."""
    return tuple(gp_genomes_to_arrays(b) for b in genomes)


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


def _from_fields(cls, dtypes, fields, device):
    return cls(**{k: to_tensor(np.asarray(v, dtypes[k]), device)
                  for k, v in fields.items()})


def _to_fields(state, dtypes) -> Dict[str, np.ndarray]:
    return {k: to_numpy(getattr(state, k)) for k in dtypes}


#: the fields of a PSO swarm and their dtypes
SWARM_FIELDS = {k: np.float32 for k in ("x", "v", "w", "pbest_x", "pbest_w",
                                        "gbest_x", "gbest_w")}


def swarm_state_from_arrays(x, v, w, pbest_x, pbest_w, gbest_x, gbest_w,
                            device: DeviceLike = None) -> SwarmState:
    """The port's PSO swarm from the JAX package's ``SwarmState``
    fields as numpy arrays."""
    return _from_fields(SwarmState, SWARM_FIELDS, dict(
        x=x, v=v, w=w, pbest_x=pbest_x, pbest_w=pbest_w, gbest_x=gbest_x,
        gbest_w=gbest_w), device)


def swarm_state_to_arrays(state: SwarmState) -> Dict[str, np.ndarray]:
    return _to_fields(state, SWARM_FIELDS)


#: the fields of a multi-swarm state and their dtypes (``nevals`` is the
#: JAX package's int32 count, int64 in the port)
MULTISWARM_FIELDS = {"x": np.float32, "v": np.float32, "pbest_x": np.float32,
                     "pbest_f": np.float32, "sbest_x": np.float32,
                     "sbest_f": np.float32, "active": np.bool_,
                     "nevals": np.int64}


def multiswarm_state_from_arrays(x, v, pbest_x, pbest_f, sbest_x, sbest_f,
                                 active, nevals, device: DeviceLike = None
                                 ) -> MultiSwarmState:
    return _from_fields(MultiSwarmState, MULTISWARM_FIELDS, dict(
        x=x, v=v, pbest_x=pbest_x, pbest_f=pbest_f, sbest_x=sbest_x,
        sbest_f=sbest_f, active=active, nevals=nevals), device)


def multiswarm_state_to_arrays(state: MultiSwarmState
                               ) -> Dict[str, np.ndarray]:
    return _to_fields(state, MULTISWARM_FIELDS)


#: the fields of a speciation swarm and their dtypes
SPECIATION_FIELDS = {"x": np.float32, "v": np.float32, "pbest_x": np.float32,
                     "pbest_f": np.float32, "nevals": np.int64}


def speciation_state_from_arrays(x, v, pbest_x, pbest_f, nevals,
                                 device: DeviceLike = None
                                 ) -> SpeciationState:
    return _from_fields(SpeciationState, SPECIATION_FIELDS, dict(
        x=x, v=v, pbest_x=pbest_x, pbest_f=pbest_f, nevals=nevals), device)


def speciation_state_to_arrays(state: SpeciationState
                               ) -> Dict[str, np.ndarray]:
    return _to_fields(state, SPECIATION_FIELDS)


def _generator(seed, generator_state, device) -> torch.Generator:
    """A generator from a seed, or at a saved position."""
    gen = make_generator(0 if seed is None else seed, device)
    if generator_state is not None:
        gen.set_state(torch.from_numpy(np.asarray(generator_state,
                                                  np.uint8)))
    return gen


def pbil_state_from_arrays(prob_vector, seed: Optional[int] = None,
                           generator_state=None,
                           device: DeviceLike = None) -> PBILState:
    """A PBIL state from its probability vector; its update draws from a
    generator made from ``seed`` (where the JAX package carries a key) or
    set to a saved ``generator_state``."""
    return PBILState(
        prob_vector=to_tensor(np.asarray(prob_vector, np.float32), device),
        generator=_generator(seed, generator_state, device))


def pbil_state_to_arrays(state: PBILState) -> Dict[str, np.ndarray]:
    """``{prob_vector, generator_state}`` as numpy arrays."""
    return {"prob_vector": to_numpy(state.prob_vector),
            "generator_state": state.generator.get_state().numpy()}


#: the fields of an EMNA state and their dtypes
EMNA_FIELDS = {"centroid": np.float32, "sigma": np.float32}


def emna_state_from_arrays(centroid, sigma,
                           device: DeviceLike = None) -> EMNAState:
    return _from_fields(EMNAState, EMNA_FIELDS,
                        dict(centroid=centroid, sigma=sigma), device)


def emna_state_to_arrays(state: EMNAState) -> Dict[str, np.ndarray]:
    return _to_fields(state, EMNA_FIELDS)


#: the tensor fields of a moving-peaks landscape and their dtypes
MOVINGPEAKS_FIELDS = {"position": np.float32, "height": np.float32,
                      "width": np.float32, "last_change": np.float32,
                      "current_error": np.float32,
                      "offline_error_sum": np.float32}


def movingpeaks_state_from_arrays(position, height, width, last_change,
                                  nevals, current_error, offline_error_sum,
                                  seed: Optional[int] = None,
                                  generator_state=None,
                                  device: DeviceLike = None
                                  ) -> MovingPeaksState:
    """A moving-peaks landscape from the JAX package's
    ``MovingPeaksState`` fields as numpy arrays (``nevals`` becomes a
    host int); its changes draw from a generator made from ``seed`` or
    set to a saved ``generator_state``."""
    fields = dict(position=position, height=height, width=width,
                  last_change=last_change, current_error=current_error,
                  offline_error_sum=offline_error_sum)
    return MovingPeaksState(
        **{k: to_tensor(np.asarray(v, MOVINGPEAKS_FIELDS[k]), device)
           for k, v in fields.items()},
        generator=_generator(seed, generator_state, device),
        nevals=int(nevals))


def movingpeaks_state_to_arrays(state: MovingPeaksState
                                ) -> Dict[str, Any]:
    """The landscape's fields as numpy arrays, ``nevals`` an int and the
    generator's position as ``generator_state``."""
    out: Dict[str, Any] = _to_fields(state, MOVINGPEAKS_FIELDS)
    out["nevals"] = state.nevals
    out["generator_state"] = state.generator.get_state().numpy()
    return out
