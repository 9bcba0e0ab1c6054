"""Particle Swarm Optimisation — the swarm as a state of tensors.

Port of :mod:`deap_tpu.strategies.pso`: the canonical velocity update
with personal bests and speed clamping, or Clerc's constricted update
when ``chi`` is given. :meth:`PSO.move` takes its uniforms ``u1, u2``;
:meth:`PSO.step` draws them from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from deap_tpu_torch.core.fitness import FitnessSpec, lex_gt
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device

__all__ = ["SwarmState", "PSO"]


@dataclasses.dataclass(frozen=True)
class SwarmState:
    x: torch.Tensor          # [n, d] positions
    v: torch.Tensor          # [n, d] velocities
    w: torch.Tensor          # [n, nobj] current weighted fitness
    pbest_x: torch.Tensor    # [n, d] personal best positions
    pbest_w: torch.Tensor    # [n, nobj]
    gbest_x: torch.Tensor    # [d] global best position
    gbest_w: torch.Tensor    # [nobj]

    def replace(self, **changes) -> "SwarmState":
        return dataclasses.replace(self, **changes)


class PSO:
    """Canonical PSO: ``v += U(0,φ1)·(pbest−x) + U(0,φ2)·(gbest−x)`` with
    each component's speed clamped to ``[smin, smax]`` in magnitude, or
    the constricted variant when ``chi`` is given: ``v += χ·pull −
    (1−χ)·v``. ``evaluate`` maps positions ``[n, d]`` to values ``[n]``
    or ``[n, nobj]``."""

    def __init__(self, evaluate: Callable, phi1: float = 2.0,
                 phi2: float = 2.0, smin: Optional[float] = None,
                 smax: Optional[float] = None, chi: Optional[float] = None,
                 spec: FitnessSpec = FitnessSpec((1.0,)),
                 device: DeviceLike = None):
        self.evaluate = evaluate
        self.phi1, self.phi2 = phi1, phi2
        self.smin, self.smax = smin, smax
        self.chi = chi
        self.spec = spec
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator, n: int, dim: int,
             pmin: float, pmax: float, smin: float,
             smax: float) -> SwarmState:
        """Uniform positions in ``[pmin, pmax]``, speeds in ``[smin,
        smax]``; no best yet."""
        check_generator(generator, self.device)
        x = torch.rand((n, dim), generator=generator, device=self.device)
        x = x * (pmax - pmin) + pmin
        v = torch.rand((n, dim), generator=generator, device=self.device)
        v = v * (smax - smin) + smin
        neg = torch.full((n, self.spec.nobj), -torch.inf, device=self.device)
        return SwarmState(x=x, v=v, w=neg, pbest_x=x, pbest_w=neg,
                          gbest_x=x[0], gbest_w=neg[0].clone())

    def update_bests(self, s: SwarmState) -> SwarmState:
        """Evaluate, then the personal bests on a strict lexicographic
        gain, then the global best from the best personal best."""
        values = self.evaluate(s.x)
        values = values[:, None] if values.ndim == 1 else values
        w = self.spec.wvalues(values)
        improve_p = lex_gt(w, s.pbest_w)
        pbest_x = torch.where(improve_p[:, None], s.x, s.pbest_x)
        pbest_w = torch.where(improve_p[:, None], w, s.pbest_w)
        ibest = torch.argmax(pbest_w[:, 0])
        improve_g = lex_gt(pbest_w[ibest], s.gbest_w)
        gbest_x = torch.where(improve_g, pbest_x[ibest], s.gbest_x)
        gbest_w = torch.where(improve_g, pbest_w[ibest], s.gbest_w)
        return s.replace(w=w, pbest_x=pbest_x, pbest_w=pbest_w,
                         gbest_x=gbest_x, gbest_w=gbest_w)

    def move_draws(self, generator: torch.Generator, s: SwarmState):
        """``u1 ~ U(0, φ1)``, ``u2 ~ U(0, φ2)``, each ``[n, d]``."""
        dev = s.x.device
        u1 = torch.rand(s.x.shape, generator=generator, device=dev)
        u2 = torch.rand(s.x.shape, generator=generator, device=dev)
        return u1 * self.phi1, u2 * self.phi2

    def move(self, s: SwarmState, u1: torch.Tensor,
             u2: torch.Tensor) -> SwarmState:
        """The velocity update on given uniforms, then ``x += v``. The
        clamp keeps each component's sign, 0 counted as positive."""
        pull = u1 * (s.pbest_x - s.x) + u2 * (s.gbest_x[None, :] - s.x)
        if self.chi is not None:
            v = s.v + self.chi * pull - (1.0 - self.chi) * s.v
        else:
            v = s.v + pull
        if self.smin is not None and self.smax is not None:
            sign = torch.sign(v) + (v == 0)
            v = sign * torch.clamp(v.abs(), self.smin, self.smax)
        return s.replace(v=v, x=s.x + v)

    def step(self, generator: torch.Generator, s: SwarmState) -> SwarmState:
        """Evaluate → update the bests → move."""
        s = self.update_bests(s)
        return self.move(s, *self.move_draws(generator, s))

    def run(self, generator: torch.Generator, s: SwarmState, ngen: int,
            ) -> Tuple[SwarmState, torch.Tensor]:
        """``ngen`` steps; returns the final swarm and each generation's
        ``gbest_w[0]`` (``[ngen]``, stacked on the device at the end: the
        loop never waits for the card)."""
        check_generator(generator, self.device)
        traj = []
        for _ in range(ngen):
            s = self.step(generator, s)
            traj.append(s.gbest_w[0])
        empty = torch.zeros(0, device=self.device)
        return s, torch.stack(traj) if traj else empty
