"""Hansen CMA-ES as an ask-tell engine over a state of tensors.

Port of :class:`deap_tpu.strategies.cma.Strategy` (and its
:class:`~deap_tpu.strategies.cma.CMAState`): a configuration object whose
``generate(generator, state)`` and ``update(state, genomes, values)``
methods are functions of an immutable state, driven by
:func:`deap_tpu_torch.algorithms.ea_generate_update`. The state lives on
the strategy's device (the card unless ``device="cpu"``).

The products stay ``torch.matmul`` and the eigendecomposition
``torch.linalg.eigh``, as the JAX package leaves them to ``jnp.matmul``
and ``jnp.linalg.eigh`` outside any Pallas kernel. Three traps:

- **Eigenvector signs.** ``torch.linalg.eigh`` and ``jnp.linalg.eigh``
  may return columns of ``B`` with opposite signs, so one ``arz`` maps to
  different samples under the two bases. ``update`` depends on ``B`` only
  through ``B diag(1/D) Bᵀ c_diff``, which is sign-invariant; the tests
  hold ``generate`` on the reference's own ``B`` and ``update``'s new
  ``B`` up to column sign.
- **TF32.** The float32 products (``arz @ BDᵀ``, the rank-μ product
  ``(w·artmpᵀ) @ artmp``) must run in full float32: PyTorch's default on
  the card. The port never changes the matmul precision; TF32 would round
  them to 10 bits.
- **Asymmetry.** The rank-μ product is symmetric only up to rounding.
  ``jnp.linalg.eigh`` symmetrises its input (``(C + Cᵀ)/2``) by default
  and ``torch.linalg.eigh`` reads one triangle, so the port symmetrises
  before the call, as the reference does; ``C`` itself stays as computed.

On the card ``torch.linalg.eigh`` runs cuSOLVER's Jacobi solver, which
checks its convergence on the host: each ``update`` waits for the card
(``port_profile.py --cmaes`` reads it; PERF.md).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from deap_tpu_torch.core.fitness import FitnessSpec, lex_sort_desc
from deap_tpu_torch.device import DeviceLike, resolve_device

__all__ = ["CMAState", "Strategy", "state_errors", "reconstruction_error"]

#: one update against a reference's from the same state and offspring:
#: ``centroid``, ``ps``, ``pc``, ``C`` and ``sigma`` within ``RTOL`` of the
#: reference plus ``ATOL_FRAC`` of its largest entry (the off-diagonals of
#: C sit near 0); ``diagD`` within ``DIAGD_RTOL``; ``B`` column for column
#: up to sign where an eigenvalue stands ``EIG_GAP`` (of the largest) apart
#: from its neighbours, each such column's dot with the reference's at
#: least ``1 - BASIS_TOL`` in magnitude; and ``B diag(D²) Bᵀ`` within
#: ``RECON_TOL`` of ``C`` (Frobenius, relative), the JAX package's check
#: of an eigendecomposition. Not bitwise: the float32 products sum in
#: another order, and the two LAPACKs (or cuSOLVER) iterate differently.
RTOL, ATOL_FRAC, DIAGD_RTOL = 1e-5, 1e-6, 1e-4
EIG_GAP, BASIS_TOL, RECON_TOL = 1e-3, 1e-4, 1e-3


@dataclasses.dataclass(frozen=True)
class CMAState:
    """The mutable part of Hansen CMA-ES (the attributes the reference
    updates in ``Strategy.update``)."""

    centroid: torch.Tensor  # [dim]
    sigma: torch.Tensor     # scalar
    C: torch.Tensor         # [dim, dim] covariance
    B: torch.Tensor         # [dim, dim] eigenbasis, columns
    diagD: torch.Tensor     # [dim] square roots of the eigenvalues, ascending
    ps: torch.Tensor        # [dim] step-size evolution path
    pc: torch.Tensor        # [dim] covariance evolution path
    count: torch.Tensor     # scalar int32, the number of updates

    @property
    def BD(self) -> torch.Tensor:
        return self.B * self.diagD

    @property
    def cond(self) -> torch.Tensor:
        """Condition number of C (ratio of the extreme axis lengths)."""
        return self.diagD[-1] / self.diagD[0]


def _eigh(C: torch.Tensor):
    """``jnp.linalg.eigh``'s default: the eigenpairs of ``(C + Cᵀ)/2``,
    eigenvalues ascending."""
    return torch.linalg.eigh((C + C.T) / 2)


class Strategy:
    """Hansen CMA-ES. Defaults follow the reference: ``lambda_ = 4 + 3 ln
    N``, ``mu = λ/2``, superlinear recombination weights, and the standard
    cs / damps / ccum / ccov1 / ccovmu learning rates (``params``
    overrides them by those names).

    Usage (ask-tell, through :func:`algorithms.ea_generate_update`)::

        strat = Strategy(torch.full((N,), 5.0), sigma=0.5, lambda_=20)
        toolbox.register("generate", strat.generate)
        toolbox.register("update", strat.update)

    ``eigen_gap`` is the lazy eigenupdate: the basis is recomputed every
    ``eigen_gap`` updates and the stale one samples in between (1, the
    default, recomputes every generation). ``eigh_impl`` is ``'lapack'``
    (``torch.linalg.eigh``); the JAX package's ``'jacobi'`` and
    ``'auto'`` are not ported.
    """

    #: gauges of the adaptation's health (:meth:`metrics`)
    metric_names = ("sigma", "cond", "ps_norm")

    def __init__(self, centroid, sigma: float, lambda_: Optional[int] = None,
                 mu: Optional[int] = None, weights: str = "superlinear",
                 cmatrix=None, spec: FitnessSpec = FitnessSpec((-1.0,)),
                 eigen_gap: int = 1, eigh_impl: str = "lapack",
                 device: DeviceLike = None, **params):
        self.device = resolve_device(device)
        self._centroid0 = torch.as_tensor(centroid, dtype=torch.float32,
                                          device=self.device)
        self.dim = int(self._centroid0.shape[0])
        self._sigma0 = float(sigma)
        self._cmatrix0 = (torch.eye(self.dim, device=self.device)
                          if cmatrix is None else torch.as_tensor(
                              cmatrix, dtype=torch.float32,
                              device=self.device))
        self.spec = spec
        self.lambda_ = int(lambda_ if lambda_ is not None
                           else 4 + 3 * math.log(self.dim))
        self.chiN = math.sqrt(self.dim) * (
            1 - 1.0 / (4.0 * self.dim) + 1.0 / (21.0 * self.dim ** 2))
        if eigen_gap != int(eigen_gap) or eigen_gap < 1:
            raise ValueError(
                f"eigen_gap must be an integer >= 1, got {eigen_gap!r}")
        self.eigen_gap = int(eigen_gap)
        if eigh_impl in ("jacobi", "auto"):
            raise NotImplementedError(
                f"eigh_impl={eigh_impl!r}: the Jacobi eigensolver "
                f"(ops/linalg.py::eigh_jacobi) and the tuner that picks "
                f"between solvers are not ported yet (ROADMAP.md A6); use "
                f"eigh_impl='lapack'")
        if eigh_impl != "lapack":
            raise ValueError(f"unknown eigh_impl {eigh_impl!r} "
                             "(expected 'lapack', 'jacobi' or 'auto')")
        self.eigh_impl = eigh_impl
        self._compute_params(mu, weights, params)

    def _compute_params(self, mu, rweights, params):
        """The λ-dependent parameters, in float64 as the reference computes
        them; the weights are float32 on the device."""
        self.mu = int(mu if mu is not None else self.lambda_ / 2)
        if rweights == "superlinear":
            w = math.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        elif rweights == "linear":
            w = self.mu + 0.5 - np.arange(1, self.mu + 1)
        elif rweights == "equal":
            w = np.ones(self.mu)
        else:
            raise RuntimeError("Unknown weights : %s" % rweights)
        w = w / w.sum()
        self.weights = torch.as_tensor(w, dtype=torch.float32,
                                       device=self.device)
        self.mueff = float(1.0 / np.sum(w ** 2))

        dim, mueff = self.dim, self.mueff
        self.cc = params.get("ccum", 4.0 / (dim + 4.0))
        self.cs = params.get("cs", (mueff + 2.0) / (dim + mueff + 3.0))
        self.ccov1 = params.get("ccov1", 2.0 / ((dim + 1.3) ** 2 + mueff))
        ccovmu = params.get(
            "ccovmu",
            2.0 * (mueff - 2.0 + 1.0 / mueff) / ((dim + 2.0) ** 2 + mueff))
        self.ccovmu = min(1 - self.ccov1, ccovmu)
        damps = 1.0 + 2.0 * max(
            0.0, math.sqrt((mueff - 1.0) / (dim + 1.0)) - 1.0) + self.cs
        self.damps = params.get("damps", damps)

    def initial_state(self, sigma: Optional[float] = None,
                      centroid=None) -> CMAState:
        """A fresh state; ``sigma`` and ``centroid`` override the
        constructor's values for this state."""
        C = self._cmatrix0
        evals, B = _eigh(C)
        c0 = (self._centroid0 if centroid is None else torch.as_tensor(
            centroid, dtype=torch.float32, device=self.device))
        if tuple(c0.shape) != (self.dim,):
            raise ValueError(
                f"centroid override shape {tuple(c0.shape)} != ({self.dim},)")
        zeros = torch.zeros(self.dim, device=self.device)
        return CMAState(
            centroid=c0.clone(),
            sigma=torch.tensor(self._sigma0 if sigma is None else sigma,
                               dtype=torch.float32, device=self.device),
            C=C.clone(), B=B, diagD=torch.sqrt(evals), ps=zeros,
            pc=zeros.clone(),
            count=torch.zeros((), dtype=torch.int32, device=self.device))

    def sample(self, state: CMAState, arz: torch.Tensor) -> torch.Tensor:
        """The samples of standard normals ``arz [λ, dim]``: ``centroid +
        σ · arz · (B·D)ᵀ``."""
        return state.centroid + state.sigma * arz @ state.BD.T

    def generate(self, generator: torch.Generator,
                 state: CMAState) -> torch.Tensor:
        """λ samples, ``arz`` drawn with ``torch.randn`` on ``generator``
        (which must live on the strategy's device)."""
        if generator.device.type != self.device.type:
            raise ValueError(f"generator lives on {generator.device}, the "
                             f"strategy on {self.device}")
        arz = torch.randn((self.lambda_, self.dim), generator=generator,
                          device=self.device)
        return self.sample(state, arz)

    def metrics(self, state: CMAState) -> dict:
        """Step size, condition number of C and the norm of the step-size
        path, as tensors."""
        return {"sigma": state.sigma, "cond": state.cond,
                "ps_norm": torch.linalg.norm(state.ps)}

    def update(self, state: CMAState, genomes: torch.Tensor,
               values: torch.Tensor) -> CMAState:
        """The covariance and step-size update from the evaluated
        offspring. ``values`` are raw objectives, ordered by their weighted
        values best first (ties by index, as the reference's stable
        sort)."""
        w = self.spec.wvalues(values if values.ndim == 2 else values[:, None])
        order = lex_sort_desc(w)
        sorted_pop = genomes[order][: self.mu]                    # [mu, dim]

        old_centroid = state.centroid
        centroid = self.weights @ sorted_pop
        c_diff = centroid - old_centroid

        # ps ← (1 − cs)·ps + √(cs(2 − cs)µeff)/σ · C^(−1/2)·Δ
        invsqrtC_cdiff = state.B @ ((1.0 / state.diagD) * (state.B.T @ c_diff))
        ps = (1 - self.cs) * state.ps + (
            math.sqrt(self.cs * (2 - self.cs) * self.mueff) / state.sigma
            * invsqrtC_cdiff)

        count = state.count + 1
        hsig = (torch.linalg.norm(ps)
                / torch.sqrt(1.0 - (1.0 - self.cs)
                             ** (2.0 * count.to(torch.float32)))
                / self.chiN) < (1.4 + 2.0 / (self.dim + 1.0))
        hsig = hsig.to(torch.float32)

        pc = (1 - self.cc) * state.pc + hsig * (
            math.sqrt(self.cc * (2 - self.cc) * self.mueff) / state.sigma
            * c_diff)

        artmp = sorted_pop - old_centroid                         # [mu, dim]
        C = ((1 - self.ccov1 - self.ccovmu
              + (1 - hsig) * self.ccov1 * self.cc * (2 - self.cc)) * state.C
             + self.ccov1 * torch.outer(pc, pc)
             + self.ccovmu * (self.weights * artmp.T) @ artmp
             / state.sigma ** 2)

        sigma = state.sigma * torch.exp(
            (torch.linalg.norm(ps) / self.chiN - 1.0) * self.cs / self.damps)

        # the lazy eigenupdate decides on the host: a Python branch where
        # the reference has lax.cond, reading the count (a synchronise)
        # only when eigen_gap > 1
        if self.eigen_gap == 1 or int(count) % self.eigen_gap == 0:
            evals, B = _eigh(C)
            diagD = torch.sqrt(torch.clamp(evals, min=1e-30))
        else:
            B, diagD = state.B, state.diagD
        return CMAState(centroid=centroid, sigma=sigma, C=C, B=B,
                        diagD=diagD, ps=ps, pc=pc, count=count)


def reconstruction_error(state: CMAState) -> float:
    """``‖B·diag(D²)·Bᵀ − C‖ / ‖C‖`` (Frobenius)."""
    B, d2 = state.B.double(), state.diagD.double() ** 2
    C = state.C.double()
    return float(torch.linalg.norm((B * d2) @ B.T - C) / torch.linalg.norm(C))


def state_errors(got: CMAState, want: CMAState) -> dict:
    """A CMA-ES state against a reference's after the same update, at the
    tolerances above; both on the same device. Returns the verdict ``ok``
    and the largest errors."""
    out, ok = {}, True
    for name in ("centroid", "ps", "pc", "C", "sigma"):
        a = getattr(got, name).double()
        b = getattr(want, name).double()
        bound = RTOL * b.abs() + ATOL_FRAC * b.abs().max()
        err = (a - b).abs()
        out[name] = float((err / bound).max())  # in units of the bound
        ok &= bool((err <= bound).all())
    d, d_ref = got.diagD.double(), want.diagD.double()
    out["diagD_rel"] = float(((d - d_ref).abs() / d_ref.abs()).max())
    ok &= out["diagD_rel"] <= DIAGD_RTOL
    ev = d_ref ** 2
    gaps = torch.diff(ev)
    inf = torch.full((1,), torch.inf, dtype=ev.dtype, device=ev.device)
    apart = torch.minimum(torch.cat([inf, gaps]), torch.cat([gaps, inf])) \
        > EIG_GAP * ev.abs().max()
    dots = (got.B.double() * want.B.double()).sum(0).abs()
    out["columns_apart"] = int(apart.sum())
    out["basis"] = float((1 - dots[apart]).max()) if bool(apart.any()) \
        else 0.0
    ok &= out["basis"] <= BASIS_TOL
    out["reconstruction"] = reconstruction_error(got)
    ok &= out["reconstruction"] <= RECON_TOL
    out["ok"] = ok
    return out
