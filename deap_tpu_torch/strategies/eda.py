"""Estimation-of-distribution strategies: PBIL and EMNA.

Port of :mod:`deap_tpu.strategies.eda`: ask-tell strategies over a state
of tensors for :func:`deap_tpu_torch.algorithms.ea_generate_update`.
Each ``generate(generator, state)`` draws and hands the draws to
``sample``; PBIL's update also draws (its mutation), from the generator
its state carries, and hands them to ``update_from_draws``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deap_tpu_torch.core.fitness import FitnessSpec, lex_sort_desc
from deap_tpu_torch.device import (DeviceLike, check_generator,
                                   make_generator, resolve_device)
from deap_tpu_torch.ops.linalg import div_rn, sqrt_rn

__all__ = ["PBILState", "PBIL", "EMNAState", "EMNA", "EMNA_RTOL"]

#: one EMNA update against the JAX package's from the same state and
#: samples: ``centroid`` within ``EMNA_RTOL`` of the largest
#: ``|centroid|`` and ``sigma`` within ``EMNA_RTOL`` relative (the mean
#: and the sum of squares under the root add µ rows in another order)
EMNA_RTOL = 1e-5


@dataclasses.dataclass(frozen=True)
class PBILState:
    prob_vector: torch.Tensor     # [dim] Bernoulli parameters
    generator: torch.Generator    # draws the update's mutation


class PBIL:
    """Population-Based Incremental Learning: sample λ bitstrings from a
    probability vector; pull the vector toward the best sample; mutate
    each component with probability ``mut_prob`` by ``mut_shift`` toward
    a random bit."""

    def __init__(self, ndim: int, learning_rate: float = 0.3,
                 mut_prob: float = 0.1, mut_shift: float = 0.05,
                 lambda_: int = 20, spec: FitnessSpec = FitnessSpec((1.0,)),
                 device: DeviceLike = None):
        self.ndim = ndim
        self.learning_rate = learning_rate
        self.mut_prob = mut_prob
        self.mut_shift = mut_shift
        self.lambda_ = lambda_
        self.spec = spec
        self.device = resolve_device(device)

    def initial_state(self, generator: Optional[torch.Generator] = None
                      ) -> PBILState:
        """Every component at 0.5; the update's mutation draws from
        ``generator`` (by default one seeded with 0)."""
        if generator is None:
            generator = make_generator(0, self.device)
        check_generator(generator, self.device)
        return PBILState(prob_vector=torch.full((self.ndim,), 0.5,
                                                device=self.device),
                         generator=generator)

    def sample(self, state: PBILState, u: torch.Tensor) -> torch.Tensor:
        """Bernoulli samples of the probability vector from uniforms
        ``u [λ, ndim]``, as float32."""
        return (u < state.prob_vector).to(torch.float32)

    def generate(self, generator: torch.Generator,
                 state: PBILState) -> torch.Tensor:
        """λ samples."""
        check_generator(generator, self.device)
        u = torch.rand((self.lambda_, self.ndim), generator=generator,
                       device=self.device)
        return self.sample(state, u)

    def update_from_draws(self, state: PBILState, genomes: torch.Tensor,
                          values: torch.Tensor, do_mut: torch.Tensor,
                          bits: torch.Tensor) -> PBILState:
        """Learn toward the best sample, then shift the components where
        ``do_mut`` toward ``bits`` (float32 0/1)."""
        w = self.spec.wvalues(values if values.ndim == 2 else values[:, None])
        best = genomes[lex_sort_desc(w)[0]]
        p = state.prob_vector * (1.0 - self.learning_rate) \
            + best * self.learning_rate
        p_mut = p * (1.0 - self.mut_shift) + bits * self.mut_shift
        return dataclasses.replace(state,
                                   prob_vector=torch.where(do_mut, p_mut, p))

    def update(self, state: PBILState, genomes: torch.Tensor,
               values: torch.Tensor) -> PBILState:
        """The update, its mutation drawn from the state's generator."""
        gen = state.generator
        do_mut = torch.rand(self.ndim, generator=gen,
                            device=gen.device) < self.mut_prob
        bits = (torch.rand(self.ndim, generator=gen, device=gen.device)
                < 0.5).to(torch.float32)
        return self.update_from_draws(state, genomes, values, do_mut, bits)


@dataclasses.dataclass(frozen=True)
class EMNAState:
    centroid: torch.Tensor   # [dim]
    sigma: torch.Tensor      # scalar isotropic std


class EMNA:
    """Estimation of Multivariate Normal Algorithm, global variant
    (Teytaud & Teytaud 2009): fit an isotropic Gaussian to the µ best of
    λ samples each generation."""

    def __init__(self, centroid, sigma: float, mu: int, lambda_: int,
                 spec: FitnessSpec = FitnessSpec((-1.0,)),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._centroid0 = torch.as_tensor(centroid, dtype=torch.float32,
                                          device=self.device)
        self._sigma0 = float(sigma)
        self.dim = int(self._centroid0.shape[0])
        self.mu = mu
        self.lambda_ = lambda_
        self.spec = spec

    def initial_state(self) -> EMNAState:
        return EMNAState(centroid=self._centroid0.clone(),
                         sigma=torch.tensor(self._sigma0, device=self.device))

    def sample(self, state: EMNAState, z: torch.Tensor) -> torch.Tensor:
        """``centroid + σ·z`` for standard normals ``z [λ, dim]``."""
        return state.centroid + state.sigma * z

    def generate(self, generator: torch.Generator,
                 state: EMNAState) -> torch.Tensor:
        check_generator(generator, self.device)
        z = torch.randn((self.lambda_, self.dim), generator=generator,
                        device=self.device)
        return self.sample(state, z)

    def update(self, state: EMNAState, genomes: torch.Tensor,
               values: torch.Tensor) -> EMNAState:
        """Mean and isotropic variance re-estimated from the µ best."""
        w = self.spec.wvalues(values if values.ndim == 2 else values[:, None])
        z = genomes.index_select(0, lex_sort_desc(w)[: self.mu]) \
            - state.centroid
        avg = div_rn(z.sum(0), float(self.mu))
        dev = z - avg
        sigma = sqrt_rn(div_rn((dev * dev).sum(), float(self.mu * self.dim)))
        return EMNAState(centroid=state.centroid + avg, sigma=sigma)
