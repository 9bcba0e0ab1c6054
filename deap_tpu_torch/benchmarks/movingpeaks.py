"""Moving Peaks — a dynamic fitness landscape on the device.

Port of :mod:`deap_tpu.benchmarks.movingpeaks`: peaks of changing
position, height and width (peak functions :func:`cone`,
:func:`sphere_peak`, :func:`function1`), changes triggered by the
evaluation count, offline and current error tracking and the
SCENARIO_1/2/3 parameter sets.

The landscape is a :class:`MovingPeaksState` of tensors plus a
``torch.Generator`` (where the JAX package carries a key) and a host
``nevals``: the period checks read a Python int, so a change needs no
synchronise. :func:`change_peaks` draws a uniform shift and two normals
and hands them to :func:`change_peaks_from_draws`.

Peak functions take the population ``x [n, dim]`` and return ``[n,
npeaks]``; squared distances add the coordinates left to right, as XLA
reduces a short row on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from deap_tpu_torch.ops.linalg import div_rn, sqrt_rn

__all__ = ["cone", "sphere_peak", "function1", "MovingPeaksState",
           "MovingPeaksConfig", "SCENARIO_1", "SCENARIO_2", "SCENARIO_3",
           "mp_init", "maximums", "global_maximum", "change_peaks",
           "change_peaks_draws", "change_peaks_from_draws", "mp_evaluate",
           "offline_error", "current_error", "CHANGE_ULPS", "EXACT_ULPS",
           "SUM_RTOL"]

#: a change inside the JAX package's ``mp_evaluate`` runs under
#: ``lax.cond``, compiled as one program, where XLA contracts ``a·b + c``
#: into fused multiply-adds; the port rounds each operation alone. After
#: such a change positions, heights, widths and the last shift agree
#: within ``CHANGE_ULPS`` ulps of each field's largest magnitude (measured
#: at most 1); :func:`change_peaks_from_draws` against the JAX package's
#: ``change_peaks`` called alone agrees bitwise
CHANGE_ULPS = 2
#: ``exact=True`` evaluates a crossing batch in the JAX package's compiled
#: scan, where XLA contracts ``1 + w·d²`` and the squared distances:
#: values within ``EXACT_ULPS`` ulps of the batch's largest value
#: (measured 1.5); the batched path agrees bitwise
EXACT_ULPS = 4
#: the offline error adds a batch's running minima; XLA sums them in
#: another order: within ``SUM_RTOL`` relative (measured 1.1e-7 at 300
#: rows)
SUM_RTOL = 1e-6


def _sq_dist(x: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """``‖x_i − p_j‖²`` as ``[n, npeaks]``, coordinates added in order."""
    diff = x[:, None, :] - position[None, :, :]
    sq = diff * diff
    d2 = sq[..., 0]
    for c in range(1, sq.shape[-1]):
        d2 = d2 + sq[..., c]
    return d2


def cone(x, position, height, width):
    """``h − w·‖x − p‖``."""
    return height - width * sqrt_rn(_sq_dist(x, position))


def sphere_peak(x, position, height, width):
    """``h·‖x − p‖²``."""
    del width
    return height * _sq_dist(x, position)


def function1(x, position, height, width):
    """``h / (1 + w·‖x − p‖²)``."""
    return height / (1.0 + width * _sq_dist(x, position))


def constant_basis(value: float) -> Callable:
    """A basis function: the landscape is at least ``value`` everywhere
    (SCENARIO_3's ``bfunc``)."""
    def bfunc(x):
        return torch.full((x.shape[0],), value, dtype=x.dtype,
                          device=x.device)
    return bfunc


@dataclasses.dataclass(frozen=True)
class MovingPeaksState:
    position: torch.Tensor           # [npeaks, dim]
    height: torch.Tensor             # [npeaks]
    width: torch.Tensor              # [npeaks]
    last_change: torch.Tensor        # [npeaks, dim]
    generator: torch.Generator       # draws the changes
    nevals: int                      # evaluations so far (host)
    current_error: torch.Tensor      # f32 scalar
    offline_error_sum: torch.Tensor  # f32 scalar

    def replace(self, **changes) -> "MovingPeaksState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass(frozen=True)
class MovingPeaksConfig:
    """Static configuration (the SCENARIO dict equivalent)."""
    dim: int
    npeaks: int = 5
    pfunc: Callable = function1
    bfunc: Optional[Callable] = None
    min_coord: float = 0.0
    max_coord: float = 100.0
    min_height: float = 30.0
    max_height: float = 70.0
    uniform_height: float = 50.0
    min_width: float = 0.0001
    max_width: float = 0.2
    uniform_width: float = 0.1
    lambda_: float = 0.0
    move_severity: float = 1.0
    height_severity: float = 7.0
    width_severity: float = 0.01
    period: int = 5000


SCENARIO_1 = dict(npeaks=5, pfunc=function1, bfunc=None, min_coord=0.0,
                  max_coord=100.0, min_height=30.0, max_height=70.0,
                  uniform_height=50.0, min_width=0.0001, max_width=0.2,
                  uniform_width=0.1, lambda_=0.0, move_severity=1.0,
                  height_severity=7.0, width_severity=0.01, period=5000)
SCENARIO_2 = dict(npeaks=10, pfunc=cone, bfunc=None, min_coord=0.0,
                  max_coord=100.0, min_height=30.0, max_height=70.0,
                  uniform_height=50.0, min_width=1.0, max_width=12.0,
                  uniform_width=0.0, lambda_=0.5, move_severity=1.5,
                  height_severity=7.0, width_severity=1.0, period=5000)
SCENARIO_3 = dict(npeaks=50, pfunc=cone, bfunc=constant_basis(10.0),
                  min_coord=0.0, max_coord=100.0, min_height=30.0,
                  max_height=70.0, uniform_height=0.0, min_width=1.0,
                  max_width=12.0, uniform_width=0.0, lambda_=0.5,
                  move_severity=1.0, height_severity=1.0,
                  width_severity=0.5, period=1000)


def _uniform(generator, shape, lo, hi):
    u = torch.rand(shape, generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def mp_init(generator: torch.Generator, cfg: MovingPeaksConfig
            ) -> MovingPeaksState:
    """A fresh landscape on ``generator``'s device; the state keeps
    ``generator`` and draws its changes from it."""
    dev = generator.device
    position = _uniform(generator, (cfg.npeaks, cfg.dim), cfg.min_coord,
                        cfg.max_coord)
    if cfg.uniform_height > 0:
        height = torch.full((cfg.npeaks,), cfg.uniform_height, device=dev)
    else:
        height = _uniform(generator, (cfg.npeaks,), cfg.min_height,
                          cfg.max_height)
    if cfg.uniform_width > 0:
        width = torch.full((cfg.npeaks,), cfg.uniform_width, device=dev)
    else:
        width = _uniform(generator, (cfg.npeaks,), cfg.min_width,
                         cfg.max_width)
    last_change = torch.rand((cfg.npeaks, cfg.dim), generator=generator,
                             device=dev) - 0.5
    return MovingPeaksState(
        position=position, height=height, width=width,
        last_change=last_change, generator=generator, nevals=0,
        current_error=torch.tensor(torch.inf, device=dev),
        offline_error_sum=torch.zeros((), device=dev))


def _landscape(cfg: MovingPeaksConfig, state: MovingPeaksState,
               x: torch.Tensor) -> torch.Tensor:
    """The landscape's value at each row of ``x``: ``[n]``."""
    best = cfg.pfunc(x, state.position, state.height, state.width).amax(1)
    if cfg.bfunc is not None:
        best = torch.maximum(best, cfg.bfunc(x))
    return best


def maximums(cfg: MovingPeaksConfig, state: MovingPeaksState):
    """Per-peak ``(value, position)``: the landscape at each peak's
    centre, other peaks and the basis included."""
    return _landscape(cfg, state, state.position), state.position


def global_maximum(cfg: MovingPeaksConfig,
                   state: MovingPeaksState) -> torch.Tensor:
    """The current optimum: the best landscape value over the peak
    centres."""
    return maximums(cfg, state)[0].max()


def _bounce(new, old, delta, lo, hi):
    below = new < lo
    above = new > hi
    bounced = torch.where(below, 2.0 * lo - old - delta,
                          torch.where(above, 2.0 * hi - old - delta, new))
    flipped = torch.where(below | above, -delta, delta)
    return bounced, flipped


def _severity_norm(shift: torch.Tensor, severity: float) -> torch.Tensor:
    sq = shift * shift
    norm = sq[:, :1]
    for c in range(1, sq.shape[1]):
        norm = norm + sq[:, c:c + 1]
    norm = sqrt_rn(norm)
    return torch.where(norm > 0, severity * shift / norm, 0.0)


def change_peaks_draws(generator: torch.Generator,
                       state: MovingPeaksState):
    """The draws of one change: ``u [npeaks, dim]`` uniform and two
    standard normals ``[npeaks]`` (heights, widths)."""
    dev = generator.device
    u = torch.rand(state.position.shape, generator=generator, device=dev)
    nh = torch.randn(state.height.shape, generator=generator, device=dev)
    nw = torch.randn(state.width.shape, generator=generator, device=dev)
    return u, nh, nw


def change_peaks_from_draws(cfg: MovingPeaksConfig, state: MovingPeaksState,
                            u: torch.Tensor, nh: torch.Tensor,
                            nw: torch.Tensor) -> MovingPeaksState:
    """One landscape change on given draws: a severity-normalised random
    shift blended (λ) with the last one, bounced at the coordinate
    bounds; Gaussian height and width steps bounced at theirs."""
    shift = _severity_norm(u - 0.5, cfg.move_severity)
    shift = (1.0 - cfg.lambda_) * shift + cfg.lambda_ * state.last_change
    shift = _severity_norm(shift, cfg.move_severity)
    new_pos, final_shift = _bounce(state.position + shift, state.position,
                                   shift, cfg.min_coord, cfg.max_coord)
    dh = nh * cfg.height_severity
    new_h, _ = _bounce(state.height + dh, state.height, dh, cfg.min_height,
                       cfg.max_height)
    dw = nw * cfg.width_severity
    new_w, _ = _bounce(state.width + dw, state.width, dw, cfg.min_width,
                       cfg.max_width)
    return state.replace(position=new_pos, height=new_h, width=new_w,
                         last_change=final_shift)


def change_peaks(cfg: MovingPeaksConfig,
                 state: MovingPeaksState) -> MovingPeaksState:
    """One landscape change, its draws from the state's generator."""
    return change_peaks_from_draws(
        cfg, state, *change_peaks_draws(state.generator, state))


def _restart(cfg, state):
    """A change, then the running error starts again (the reference
    forgets its optimum after a change)."""
    state = change_peaks(cfg, state)
    return state.replace(current_error=torch.full_like(
        state.current_error, torch.inf))


def _batched(cfg, state, genomes):
    values = _landscape(cfg, state, genomes)
    errs = (values - global_maximum(cfg, state)).abs()
    run_min = torch.cummin(torch.cat([state.current_error[None], errs]),
                           0).values
    return state.replace(
        nevals=state.nevals + genomes.shape[0], current_error=run_min[-1],
        offline_error_sum=state.offline_error_sum + run_min[1:].sum()), values


def mp_evaluate(cfg: MovingPeaksConfig, state: MovingPeaksState,
                genomes: torch.Tensor, exact: bool = False):
    """Evaluate a population ``[n, dim]`` → ``(new_state, values [n,
    1])``.

    The running minimum of ``|f − optimum|`` threads through the batch
    and sums into the offline error. By default a change fires once per
    batch when ``nevals`` crosses a period boundary. ``exact=True`` is the
    reference's per-evaluation rule: individuals before a boundary see
    the old landscape, those after it the new one, as many changes as
    boundaries; only a batch that crosses one pays for it (a host loop
    over its individuals' errors, the values a batch per landscape).
    """
    if exact and cfg.period > 0 and ((state.nevals + genomes.shape[0])
                                     // cfg.period
                                     > state.nevals // cfg.period):
        return _mp_evaluate_exact(cfg, state, genomes)
    new_state, values = _batched(cfg, state, genomes)
    if (not exact and cfg.period > 0
            and new_state.nevals // cfg.period > state.nevals // cfg.period):
        new_state = _restart(cfg, new_state)
    return new_state, values[:, None]


def _mp_evaluate_exact(cfg, state, genomes):
    """A crossing batch, in the reference's order: value on the current
    landscape, count, running error against the current optimum, then a
    change when the count hits a period multiple. Each landscape's
    values are one batch; the error bookkeeping is a float32 host loop
    (one copy of a segment's errors, each running minimum added in
    turn)."""
    n = genomes.shape[0]
    cur = np.float32(state.current_error.item())
    off = np.float32(state.offline_error_sum.item())
    nevals, i, values = state.nevals, 0, []
    while i < n:
        j = min(n, i + cfg.period - nevals % cfg.period)
        seg = _landscape(cfg, state, genomes[i:j])
        errs = (seg - global_maximum(cfg, state)).abs().cpu().numpy()
        for e in errs:
            cur = np.minimum(cur, e)
            off = np.float32(off + cur)
        values.append(seg)
        nevals += j - i
        i = j
        state = state.replace(
            nevals=nevals,
            current_error=torch.tensor(cur, device=genomes.device),
            offline_error_sum=torch.tensor(off, device=genomes.device))
        if nevals % cfg.period == 0:
            state = _restart(cfg, state)
            cur = np.float32(np.inf)
    return state, torch.cat(values)[:, None]


def offline_error(state: MovingPeaksState) -> torch.Tensor:
    """Mean running error over all evaluations."""
    return div_rn(state.offline_error_sum, float(max(state.nevals, 1)))


def current_error(state: MovingPeaksState) -> torch.Tensor:
    return state.current_error
