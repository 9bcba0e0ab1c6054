"""Multi-swarm and speciation PSO for dynamic optimisation.

Port of :mod:`deap_tpu.strategies.multiswarm`:

- :class:`MultiSwarmPSO` — Blackwell, Branke & Li's multi-swarm PSO:
  constricted swarms with anti-convergence (spawn a swarm when all have
  converged, kill the worst when too many roam), change detection by
  re-evaluating each swarm's best, quantum clouds around it, and
  exclusion (the worse of two close swarms starts again).
- :class:`SpeciationPSO` — particles in fitness order form species
  around seeds within radius ``rs``; species are capped at ``pmax_size``
  members and the worst species is replaced every generation.

The swarm axis has a fixed ``capacity`` and an ``active`` mask. Each
step's random parts come as a draws dataclass (``*Draws``), drawn by
``draws(generator, state)``; ``step_from_draws`` is the step on them.
The data-dependent decisions (spawn, kill, a detected change) stay
tensors chosen by ``torch.where``. Two parts are sequential by nature
and run on the host after one copy each step: the exclusion sweep over
the close pairs of swarms, and the greedy seed pass of
:func:`species_seeds` over the ``d <= rs`` matrix.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device
from deap_tpu_torch.ops.linalg import div_rn, norm_rn

__all__ = ["CHI", "C", "MultiSwarmState", "MultiSwarmDraws", "MultiSwarmPSO",
           "species_seeds", "SpeciationState", "SpeciationDraws",
           "SpeciationPSO", "NORM_ULPS", "POW_ULPS"]

CHI = 0.729843788       # Clerc's constriction
C = 2.05

#: Euclidean norms (the quantum cloud's, a swarm's diameter, the
#: distances of exclusion and speciation) add the squares left to right
#: and take a correctly rounded root; XLA's within ``NORM_ULPS`` ulps
NORM_ULPS = 2
#: ``u ** (1/dim)`` (the cloud's radius scale, the exclusion radius):
#: torch's ``pow`` and XLA's within ``POW_ULPS`` ulps
POW_ULPS = 2


def _argmax_first(mask: torch.Tensor, dim: Optional[int] = None):
    """``jnp.argmax`` of a boolean: the first True (0 if none)."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


def _quantum_cloud(pos: torch.Tensor, u: torch.Tensor, centre: torch.Tensor,
                   rcloud: float, dist: str) -> torch.Tensor:
    """A quantum particle cloud around ``centre`` on given draws:
    directions ``pos [..., dim]`` (standard normals, normalised here) and
    radius draws ``u [..., 1]`` (standard normals for ``'gaussian'`` and
    ``'nuvd'``, uniforms for ``'uvd'``)."""
    dim = pos.shape[-1]
    norm = norm_rn(pos, keepdim=True)
    norm = torch.where(norm == 0, 1.0, norm)
    if dist == "gaussian":
        u = torch.abs(div_rn(u, 3.0)) ** (1.0 / dim)
    elif dist == "uvd":
        u = u ** (1.0 / dim)
    elif dist == "nuvd":
        u = torch.abs(div_rn(u, 3.0))
    else:
        raise ValueError(dist)
    return rcloud * pos * u / norm + centre


def _cloud_draws(generator: torch.Generator, shape, dist: str):
    """The draws of :func:`_quantum_cloud` for clouds of ``shape[:-1]``
    particles in ``shape[-1]`` dimensions."""
    if dist not in ("gaussian", "uvd", "nuvd"):
        raise ValueError(dist)
    dev = generator.device
    pos = torch.randn(shape, generator=generator, device=dev)
    ushape = tuple(shape[:-1]) + (1,)
    u = (torch.rand(ushape, generator=generator, device=dev)
         if dist == "uvd" else
         torch.randn(ushape, generator=generator, device=dev))
    return pos, u


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


@dataclasses.dataclass(frozen=True)
class MultiSwarmState:
    x: torch.Tensor          # [S, P, D] positions
    v: torch.Tensor          # [S, P, D] velocities
    pbest_x: torch.Tensor    # [S, P, D]
    pbest_f: torch.Tensor    # [S, P] weighted fitness (-inf = no pbest yet)
    sbest_x: torch.Tensor    # [S, D]
    sbest_f: torch.Tensor    # [S]    (-inf = no swarm best yet)
    active: torch.Tensor     # [S] bool
    nevals: torch.Tensor     # scalar int64 running evaluation count

    def replace(self, **changes) -> "MultiSwarmState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class MultiSwarmDraws:
    """One multi-swarm step's draws, positions and velocities already in
    their ranges."""
    spawn_x: torch.Tensor    # [P, D] a spawned swarm's positions
    spawn_v: torch.Tensor    # [P, D] and velocities
    cloud_pos: torch.Tensor  # [S, P, D] standard normals
    cloud_u: torch.Tensor    # [S, P, 1] the cloud's radius draws
    ce1: torch.Tensor        # [S, P, D] c·U(0, 1), toward the swarm best
    ce2: torch.Tensor        # [S, P, D] c·U(0, 1), toward the pbest
    excl_x: torch.Tensor     # [S, P, D] an excluded swarm's positions
    excl_v: torch.Tensor     # [S, P, D] and velocities


class MultiSwarmPSO:
    """Blackwell-Branke-Li multi-swarm PSO over a dynamic landscape.

    :param evaluate: batched ``x [n, d] -> f [n]`` (maximised). For
        MovingPeaks pass a closure over the current landscape state and
        call :meth:`step` between changes.
    """

    def __init__(self, evaluate: Callable, pmin: float, pmax: float,
                 rcloud: float = 0.5, nexcess: int = 3,
                 dist: str = "nuvd", chi: float = CHI, c: float = C,
                 device: DeviceLike = None):
        self.evaluate = evaluate
        self.pmin, self.pmax = pmin, pmax
        self.rcloud = rcloud
        self.nexcess = nexcess
        self.dist = dist
        self.chi, self.c = chi, c
        self.device = resolve_device(device)

    def _fresh(self, generator, shape):
        half = (self.pmax - self.pmin) / 2.0
        return (_uniform(generator, shape, self.pmin, self.pmax),
                _uniform(generator, shape, -half, half))

    def init(self, generator: torch.Generator, nswarms: int,
             nparticles: int, dim: int,
             capacity: Optional[int] = None) -> MultiSwarmState:
        """``capacity`` swarm slots (default ``4·nswarms``), the first
        ``nswarms`` active, every slot a fresh random swarm."""
        check_generator(generator, self.device)
        S = capacity if capacity is not None else nswarms * 4
        x, v = self._fresh(generator, (S, nparticles, dim))
        neg = torch.full((S, nparticles), -torch.inf, device=self.device)
        return MultiSwarmState(
            x=x, v=v, pbest_x=x, pbest_f=neg, sbest_x=x[:, 0],
            sbest_f=torch.full((S,), -torch.inf, device=self.device),
            active=torch.arange(S, device=self.device) < nswarms,
            nevals=torch.zeros((), dtype=torch.int64, device=self.device))

    def draws(self, generator: torch.Generator,
              s: MultiSwarmState) -> MultiSwarmDraws:
        S, P, D = s.x.shape
        spawn_x, spawn_v = self._fresh(generator, (P, D))
        cloud_pos, cloud_u = _cloud_draws(generator, (S, P, D), self.dist)
        ce1 = self.c * torch.rand((S, P, D), generator=generator,
                                  device=generator.device)
        ce2 = self.c * torch.rand((S, P, D), generator=generator,
                                  device=generator.device)
        excl_x, excl_v = self._fresh(generator, (S, P, D))
        return MultiSwarmDraws(spawn_x, spawn_v, cloud_pos, cloud_u, ce1,
                               ce2, excl_x, excl_v)

    def _rexcl(self, s: MultiSwarmState) -> torch.Tensor:
        """Exclusion radius: domain range / (2 · nswarms^(1/D))."""
        n_act = torch.clamp(s.active.sum(), min=1).to(torch.float32)
        return div_rn(self.pmax - self.pmin,
                      2.0 * n_act ** (1.0 / s.x.shape[-1]))

    def step(self, generator: torch.Generator,
             s: MultiSwarmState) -> MultiSwarmState:
        return self.step_from_draws(s, self.draws(generator, s))

    def step_from_draws(self, s: MultiSwarmState,
                        dr: MultiSwarmDraws) -> MultiSwarmState:
        S, P, D = s.x.shape
        dev = s.x.device
        slots = torch.arange(S, device=dev)
        rexcl = self._rexcl(s)

        # anti-convergence: spawn when every active swarm has converged,
        # kill the worst roaming swarm when too many roam
        diam = norm_rn(s.x[:, :, None, :]
                       - s.x[:, None, :, :]).amax(dim=(1, 2))
        roaming = s.active & (diam > 2.0 * rexcl)
        n_roaming = roaming.sum()
        do_spawn = (n_roaming == 0) & ~s.active.all()
        sel_spawn = do_spawn & (slots == _argmax_first(~s.active))
        x = torch.where(sel_spawn[:, None, None], dr.spawn_x[None], s.x)
        v = torch.where(sel_spawn[:, None, None], dr.spawn_v[None], s.v)
        pbest_x = torch.where(sel_spawn[:, None, None], dr.spawn_x[None],
                              s.pbest_x)
        pbest_f = torch.where(sel_spawn[:, None], -torch.inf, s.pbest_f)
        sbest_f = torch.where(sel_spawn, -torch.inf, s.sbest_f)
        active = s.active | sel_spawn
        worst = torch.argmin(torch.where(roaming, sbest_f, torch.inf))
        do_kill = n_roaming > self.nexcess
        active = active & ~(do_kill & (slots == worst))

        # change detection: re-evaluate each swarm best; a changed swarm
        # becomes a quantum cloud around it
        has_sbest = sbest_f > -torch.inf
        refit = self.evaluate(s.sbest_x)
        changed = active & has_sbest & (refit != sbest_f)
        nevals = s.nevals + (active & has_sbest).sum()
        clouds = _quantum_cloud(dr.cloud_pos, dr.cloud_u,
                                s.sbest_x[:, None, :], self.rcloud, self.dist)
        x = torch.where(changed[:, None, None], clouds, x)
        pbest_f = torch.where(changed[:, None], -torch.inf, pbest_f)
        sbest_f = torch.where(changed, -torch.inf, sbest_f)

        # constricted move of the particles with a pbest and a swarm best
        has_p = pbest_f > -torch.inf
        has_s = (sbest_f > -torch.inf)[:, None]
        pull = dr.ce1 * (s.sbest_x[:, None, :] - x) + dr.ce2 * (pbest_x - x)
        vnew = v + self.chi * pull - (1.0 - self.chi) * v
        move = ((has_p & has_s) & active[:, None])[:, :, None]
        v = torch.where(move, vnew, v)
        x = torch.where(move, x + v, x)

        # evaluate, then the attractors
        f = self.evaluate(x.reshape(S * P, D)).reshape(S, P)
        nevals = nevals + active.sum() * P
        improve_p = f > pbest_f
        pbest_x = torch.where(improve_p[:, :, None], x, pbest_x)
        pbest_f = torch.where(improve_p, f, pbest_f)
        ibest = torch.argmax(pbest_f, dim=1)
        cand_f = pbest_f.gather(1, ibest[:, None])[:, 0]
        cand_x = pbest_x[slots, ibest]
        improve_s = cand_f > sbest_f
        sbest_x = torch.where(improve_s[:, None], cand_x, s.sbest_x)
        sbest_f = torch.where(improve_s, cand_f, sbest_f)

        # exclusion: the worse of two close swarms starts again
        has = (sbest_f > -torch.inf) & active
        close = ((norm_rn(sbest_x[:, None, :] - sbest_x[None, :, :]) < rexcl)
                 & has[:, None] & has[None, :]
                 & ~torch.eye(S, dtype=torch.bool, device=dev))
        # one copy to the host: each swarm's best value and its close row
        host = torch.cat([sbest_f[:, None], close.to(sbest_f.dtype)],
                         1).cpu().numpy()
        reinit = torch.from_numpy(_exclusion_sweep(host[:, 1:] > 0,
                                                   host[:, 0])).to(dev)
        x = torch.where(reinit[:, None, None], dr.excl_x, x)
        v = torch.where(reinit[:, None, None], dr.excl_v, v)
        pbest_f = torch.where(reinit[:, None], -torch.inf, pbest_f)
        sbest_f = torch.where(reinit, -torch.inf, sbest_f)
        return MultiSwarmState(x=x, v=v, pbest_x=pbest_x, pbest_f=pbest_f,
                               sbest_x=sbest_x, sbest_f=sbest_f,
                               active=active, nevals=nevals)

    def best(self, s: MultiSwarmState) -> Tuple[torch.Tensor, torch.Tensor]:
        i = torch.argmax(torch.where(s.active, s.sbest_f, -torch.inf))
        return s.sbest_x[i], s.sbest_f[i]


def _exclusion_sweep(close: np.ndarray, sbest_f: np.ndarray) -> np.ndarray:
    """The reference's pair sweep: pairs ``s1 < s2`` in index order,
    skipping pairs with a member already marked; the worse of a close
    pair is marked (``s1`` when ``f[s1] <= f[s2]``). Only close pairs can
    act, so the others are skipped."""
    marked = np.zeros(close.shape[0], bool)
    for s1, s2 in zip(*np.nonzero(np.triu(close, 1))):
        if not (marked[s1] or marked[s2]):
            marked[s1 if sbest_f[s1] <= sbest_f[s2] else s2] = True
    return marked


# ------------------------------------------------------------- speciation ----

def species_seeds(x: torch.Tensor, f: torch.Tensor, rs: float,
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy best-first speciation: walking the particles in fitness
    order (stable), one becomes a *seed* iff no better seed lies within
    radius ``rs``; every particle joins the best seed within ``rs``
    (itself if it is a seed).

    Returns ``(is_seed bool[n], species int64[n])``, ``species[i]`` the
    index of particle i's seed. The greedy pass runs on the host over the
    ``d <= rs`` matrix (one copy); the rest stays on the device.
    """
    n = x.shape[0]
    order = torch.argsort(-f, stable=True)
    xs = x[order]
    near = norm_rn(xs[:, None, :] - xs[None, :, :]) <= rs
    near_np = near.cpu().numpy()
    seeds = []
    for i in range(n):
        if not near_np[i, seeds].any():
            seeds.append(i)
    seed_sorted = torch.zeros(n, dtype=torch.bool, device=x.device)
    seed_sorted[torch.tensor(seeds, dtype=torch.int64, device=x.device)] = True
    first_seed_sorted = _argmax_first(near & seed_sorted[None, :], dim=1)
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=x.device)
    return seed_sorted[inv], order[first_seed_sorted][inv]


@dataclasses.dataclass(frozen=True)
class SpeciationState:
    x: torch.Tensor          # [n, d]
    v: torch.Tensor          # [n, d]
    pbest_x: torch.Tensor    # [n, d]
    pbest_f: torch.Tensor    # [n]
    nevals: torch.Tensor     # scalar int64

    def replace(self, **changes) -> "SpeciationState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class SpeciationDraws:
    """One speciation step's draws."""
    cloud_pos: torch.Tensor  # [n, d] standard normals
    cloud_u: torch.Tensor    # [n, 1] standard normals ('nuvd')
    ce1: torch.Tensor        # [n, d] c·U(0, 1), toward the seed's best
    ce2: torch.Tensor        # [n, d] c·U(0, 1), toward the pbest
    fresh_x: torch.Tensor    # [n, d] positions in [pmin, pmax]
    fresh_v: torch.Tensor    # [n, d] velocities in ±(pmax − pmin)/2


class SpeciationPSO:
    """Speciation PSO on a dynamic landscape: species form around
    best-first seeds (radius ``rs``), each particle is pulled toward its
    seed's best position, species are capped at ``pmax_size`` members
    (overflow re-initialised, when no change is detected) and the worst
    species is replaced by fresh particles every generation. A change
    (a seed's best re-evaluates differently) turns every species into a
    quantum cloud around its seed."""

    def __init__(self, evaluate: Callable, pmin: float, pmax: float,
                 rs: float, pmax_size: int = 10, rcloud: float = 1.0,
                 chi: float = CHI, c: float = C, device: DeviceLike = None):
        self.evaluate = evaluate
        self.pmin, self.pmax = pmin, pmax
        self.rs = rs
        self.pmax_size = pmax_size
        self.rcloud = rcloud
        self.chi, self.c = chi, c
        self.device = resolve_device(device)

    def init(self, generator: torch.Generator, n: int,
             dim: int) -> SpeciationState:
        check_generator(generator, self.device)
        half = (self.pmax - self.pmin) / 2.0
        x = _uniform(generator, (n, dim), self.pmin, self.pmax)
        v = _uniform(generator, (n, dim), -half, half)
        return SpeciationState(
            x=x, v=v, pbest_x=x,
            pbest_f=torch.full((n,), -torch.inf, device=self.device),
            nevals=torch.zeros((), dtype=torch.int64, device=self.device))

    def draws(self, generator: torch.Generator,
              s: SpeciationState) -> SpeciationDraws:
        n, d = s.x.shape
        half = (self.pmax - self.pmin) / 2.0
        cloud_pos, cloud_u = _cloud_draws(generator, (n, d), "nuvd")
        ce1 = self.c * torch.rand((n, d), generator=generator,
                                  device=generator.device)
        ce2 = self.c * torch.rand((n, d), generator=generator,
                                  device=generator.device)
        return SpeciationDraws(
            cloud_pos, cloud_u, ce1, ce2,
            _uniform(generator, (n, d), self.pmin, self.pmax),
            _uniform(generator, (n, d), -half, half))

    def step(self, generator: torch.Generator,
             s: SpeciationState) -> SpeciationState:
        return self.step_from_draws(s, self.draws(generator, s))

    def step_from_draws(self, s: SpeciationState,
                        dr: SpeciationDraws) -> SpeciationState:
        n, d = s.x.shape
        dev = s.x.device

        # evaluate + personal bests
        f = self.evaluate(s.x)
        improve = f > s.pbest_f
        pbest_x = torch.where(improve[:, None], s.x, s.pbest_x)
        pbest_f = torch.where(improve, f, s.pbest_f)

        # species over the personal bests
        is_seed, species = species_seeds(pbest_x, pbest_f, self.rs)
        seed_best_x = pbest_x[species]

        # change detection: every pbest re-evaluated (the JAX package's
        # static-shape batch; nevals counts it), a seed's differing
        # value marks a change
        seed_fit = self.evaluate(pbest_x)
        nevals = s.nevals + 2 * n
        changed = (is_seed & (seed_fit != pbest_f))[species].any()

        cloud = _quantum_cloud(dr.cloud_pos, dr.cloud_u,
                               torch.zeros(d, device=dev), self.rcloud,
                               "nuvd") + seed_best_x
        # rank within species by (fitness, index): ties count toward the
        # cap
        idx = torch.arange(n, device=dev)
        better = (pbest_f[None, :] > pbest_f[:, None]) | (
            (pbest_f[None, :] == pbest_f[:, None])
            & (idx[None, :] < idx[:, None]))
        same = species[None, :] == species[:, None]
        overflow = (better & same).sum(1) >= self.pmax_size
        # the worst species: the last seed in fitness order
        worst_seed = torch.argmin(torch.where(is_seed, pbest_f, torch.inf))
        in_worst = species == worst_seed

        pull = dr.ce1 * (seed_best_x - s.x) + dr.ce2 * (pbest_x - s.x)
        v = s.v + self.chi * pull - (1.0 - self.chi) * s.v
        moved_x = s.x + v

        # the worst species starts again every generation; the cap's
        # overflow only when no change was detected
        reinit = overflow | in_worst
        x_changed = torch.where(in_worst[:, None], dr.fresh_x, cloud)
        x_normal = torch.where(reinit[:, None], dr.fresh_x, moved_x)
        x = torch.where(changed, x_changed, x_normal)
        fresh_mask = torch.where(changed, in_worst, reinit)
        v = torch.where(fresh_mask[:, None], dr.fresh_v, v)
        reset = changed | reinit
        pbest_f = torch.where(reset, -torch.inf, pbest_f)
        pbest_x = torch.where(reset[:, None], x, pbest_x)
        return SpeciationState(x=x, v=v, pbest_x=pbest_x, pbest_f=pbest_f,
                               nevals=nevals)

    def best(self, s: SpeciationState) -> Tuple[torch.Tensor, torch.Tensor]:
        i = torch.argmax(s.pbest_f)
        return s.pbest_x[i], s.pbest_f[i]
