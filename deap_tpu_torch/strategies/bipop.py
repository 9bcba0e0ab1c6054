"""BIPOP-CMA-ES: the bi-population restart regime with Hansen's stopping
criteria.

Port of :mod:`deap_tpu.strategies.bipop`. Restarts alternate a
large-population regime (λ doubling, IPOP) and a small-population one,
budgeted against each other (:func:`_restart_plan`); each inner CMA-ES run
(:class:`~deap_tpu_torch.strategies.cma.Strategy`, ``eigh_impl='lapack'``)
stops on the first of MaxIter, TolHistFun, EqualFunVals, TolX,
TolUpSigma, Stagnation, ConditionCov, NoEffectAxis and NoEffectCoor
(:func:`_stop_conditions`). The restart and stopping logic is scalar
control flow on the host: each generation reads the values, and the
state's few scalars and small arrays, back from the device, as the JAX
function does.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device
from deap_tpu_torch.strategies.cma import Strategy
from deap_tpu_torch.support.logbook import Logbook

__all__ = ["bipop_cmaes"]


def _restart_plan(i: int, nrestarts: int, nsmallpopruns: int,
                  smallbudget: Sequence[int], largebudget: Sequence[int],
                  u: Sequence[float], dim: int, sigma0: float) -> dict:
    """Restart ``i``'s regime and termination constants from the budgets
    so far and two uniforms ``u``.

    The first and the last restart are regime 1 (λ = 2^(i − small runs)
    λ0, σ0); between them regime 2 (a λ between λ0 and half of regime 1's,
    σ = 2·10^(−2 u1)) runs while its budget trails regime 1's. Returns
    ``lambda_``, ``sigma``, ``regime``, ``maxiter``, ``tolhistfun_iter``
    and ``equalfunvals_k``. ``maxiter`` of regime 2 reads the budget of
    the latest regime-1 run (``largebudget[-1]``)."""
    lambda0 = 4 + int(3 * math.log(dim))
    if (0 < i < (nrestarts + nsmallpopruns) - 1
            and sum(smallbudget) < sum(largebudget)):
        lambda_ = int(lambda0 * (
            0.5 * (2 ** (i - nsmallpopruns) * lambda0) / lambda0
        ) ** (float(u[0]) ** 2))
        sigma = 2 * 10 ** (-2 * float(u[1]))
        regime = 2
    else:
        lambda_ = 2 ** (i - nsmallpopruns) * lambda0
        sigma = sigma0
        regime = 1
    lambda_ = max(lambda_, 2)
    if regime == 1:
        maxiter = 100 + 50 * (dim + 3) ** 2 / math.sqrt(lambda_)
    else:
        maxiter = 0.5 * largebudget[-1] / lambda_
    return {"lambda_": lambda_, "sigma": sigma, "regime": regime,
            "maxiter": maxiter,
            "tolhistfun_iter": 10 + int(math.ceil(30.0 * dim / lambda_)),
            "equalfunvals_k": int(math.ceil(0.1 + lambda_ / 4.0))}


def _stop_conditions(st: Dict[str, np.ndarray], t: int, dim: int,
                     lambda_: int, sigma: float, maxiter: float,
                     mins: deque, equalfunvalues: Sequence[int],
                     bestvalues: Sequence[float],
                     medianvalues: Sequence[float], tolhistfun: float,
                     tolx: float, tolupsigma: float,
                     conditioncov: float) -> Dict[str, bool]:
    """The criteria that fire after generation ``t`` (counted from 1), on
    host arrays: ``st`` holds the CMA-ES state's ``centroid``, ``sigma``,
    ``C``, ``B``, ``diagD``, ``pc`` and ``cond`` as numpy; ``sigma`` is the
    run's initial step size; ``mins`` the window of the last best weighted
    values (its ``maxlen`` the TolHistFun window); ``bestvalues`` and
    ``medianvalues`` the best and median weighted values of every
    generation so far, ``equalfunvalues`` whether the best equalled the
    k-th best. Weighted values grow on improvement."""
    conditions: Dict[str, bool] = {}
    stagnation_iter = int(math.ceil(0.2 * t + 120 + 30.0 * dim / lambda_))
    axis = t % dim
    if t >= maxiter:
        conditions["MaxIter"] = True
    if len(mins) == mins.maxlen and max(mins) - min(mins) < tolhistfun:
        conditions["TolHistFun"] = True
    if t > dim and sum(equalfunvalues[-dim:]) / float(dim) > 1.0 / 3:
        conditions["EqualFunVals"] = True
    if np.all(st["pc"] < tolx) and np.all(np.sqrt(np.diag(st["C"])) < tolx):
        conditions["TolX"] = True
    if float(st["sigma"]) / sigma > float(st["diagD"][-1] ** 2) * tolupsigma:
        conditions["TolUpSigma"] = True
    # stagnation: the recent medians do not exceed the older window's
    if (len(bestvalues) > stagnation_iter
            and np.median(bestvalues[-20:]) <= np.median(
                bestvalues[-stagnation_iter:-stagnation_iter + 20])
            and np.median(medianvalues[-20:]) <= np.median(
                medianvalues[-stagnation_iter:-stagnation_iter + 20])):
        conditions["Stagnation"] = True
    if float(st["cond"]) > conditioncov:
        conditions["ConditionCov"] = True
    if np.all(st["centroid"] == st["centroid"] + 0.1 * st["sigma"]
              * st["diagD"][-axis] * st["B"][-axis]):
        conditions["NoEffectAxis"] = True
    if np.any(st["centroid"] == st["centroid"]
              + 0.2 * st["sigma"] * np.diag(st["C"])):
        conditions["NoEffectCoor"] = True
    return conditions


def _host_state(state) -> Dict[str, np.ndarray]:
    return {"centroid": state.centroid.cpu().numpy(),
            "sigma": state.sigma.cpu().numpy(), "C": state.C.cpu().numpy(),
            "B": state.B.cpu().numpy(), "diagD": state.diagD.cpu().numpy(),
            "pc": state.pc.cpu().numpy(), "cond": state.cond.cpu().numpy()}


def bipop_cmaes(generator: torch.Generator, evaluate: Callable, dim: int,
                sigma0: float = 2.0, nrestarts: int = 10,
                centroid_low: float = -4.0, centroid_high: float = 4.0,
                spec: FitnessSpec = FitnessSpec((-1.0,)),
                tolhistfun: float = 1e-12, tolx: float = 1e-12,
                tolupsigma: float = 1e20, conditioncov: float = 1e14,
                verbose: bool = False, device: DeviceLike = None,
                ) -> Tuple[np.ndarray, float, List[Logbook]]:
    """Run BIPOP-CMA-ES on ``device`` (the card unless ``device="cpu"``;
    ``generator`` must live there). ``evaluate`` maps ``[λ, dim]`` to raw
    objective values ``[λ]`` (or ``[λ, 1]``); minimisation by default
    (``spec``). Returns ``(best_x, best_f, logbooks)``, one logbook a
    restart with the columns gen, evals, restart, regime, min, avg, max.

    Draws from ``generator``, each restart: the regime's 2 uniforms, the
    centroid (uniform in ``[centroid_low, centroid_high)``), then each
    generation's ``Strategy.generate``."""
    dev = resolve_device(device)
    check_generator(generator, dev)
    w0 = float(spec.weights[0])
    nsmallpopruns = 0
    smallbudget: List[int] = []
    largebudget: List[int] = []
    logbooks: List[Logbook] = []
    best_x: Optional[np.ndarray] = None
    best_f = math.inf
    i = 0

    while i < (nrestarts + nsmallpopruns):
        u = torch.rand(2, generator=generator, device=dev).tolist()
        plan = _restart_plan(i, nrestarts, nsmallpopruns, smallbudget,
                             largebudget, u, dim, sigma0)
        lambda_, sigma, regime = plan["lambda_"], plan["sigma"], plan["regime"]
        if regime == 2:
            nsmallpopruns += 1
            smallbudget.append(0)
        else:
            largebudget.append(0)

        centroid = centroid_low + (centroid_high - centroid_low) * torch.rand(
            dim, generator=generator, device=dev)
        strat = Strategy(centroid, sigma=sigma, lambda_=lambda_, spec=spec,
                         device=dev)
        state = strat.initial_state()

        logbook = Logbook()
        logbooks.append(logbook)
        conditions: Dict[str, bool] = {}
        equalfunvalues: List[int] = []
        bestvalues: List[float] = []
        medianvalues: List[float] = []
        mins: deque = deque(maxlen=plan["tolhistfun_iter"])
        k = plan["equalfunvals_k"]
        t = 0

        while not conditions:
            genomes = strat.generate(generator, state)
            values = evaluate(genomes)
            state = strat.update(state, genomes, values)
            # ascending weighted values: vals[-1] the best, vals[-k] the
            # k-th best
            raw_np = values.reshape(lambda_).cpu().numpy()
            vals = np.sort(raw_np * w0)
            raw = np.sort(raw_np)
            # the best so far in the weighted direction
            gen_best_i = int(np.argmax(raw_np * w0))
            if best_x is None or raw_np[gen_best_i] * w0 > best_f * w0:
                best_f = float(raw_np[gen_best_i])
                best_x = genomes[gen_best_i].cpu().numpy()
            logbook.record(gen=t, evals=lambda_, restart=i, regime=regime,
                           min=float(raw[0]), avg=float(raw.mean()),
                           max=float(raw[-1]))
            if verbose:
                print(logbook.stream)

            equalfunvalues.append(int(vals[-1] == vals[-k]))
            bestvalues.append(float(vals[-1]))
            medianvalues.append(float(vals[int(round(len(vals) / 2.0)) - 1]))
            if regime == 1 and i > 0:
                largebudget[-1] += lambda_
            elif regime == 2:
                smallbudget[-1] += lambda_
            t += 1
            mins.append(float(vals[-1]))
            conditions = _stop_conditions(
                _host_state(state), t, dim, lambda_, sigma, plan["maxiter"],
                mins, equalfunvalues, bestvalues, medianvalues, tolhistfun,
                tolx, tolupsigma, conditioncov)

        if verbose:
            print("Stopped because of condition%s %s"
                  % (":" if len(conditions) == 1 else "s:",
                     ",".join(conditions)))
        i += 1

    return best_x, best_f, logbooks
