"""The CMA-ES family as ask-tell engines over a state of tensors.

Port of :mod:`deap_tpu.strategies.cma`: Hansen CMA-ES (:class:`Strategy`,
:class:`CMAState`), the (1+λ)-CMA-ES (:class:`StrategyOnePlusLambda`,
:class:`OnePlusLambdaState`) and MO-CMA-ES (:class:`StrategyMultiObjective`,
:class:`MOState`, with :func:`hypervolume_contributions_2d`). Each is a
configuration object whose ``generate(generator, state)`` and
``update(state, genomes, values)`` methods are functions of an immutable
state, driven by :func:`deap_tpu_torch.algorithms.ea_generate_update`.
The state lives on the strategy's device (the card unless
``device="cpu"``).

The products stay ``torch.matmul``, the Cholesky factor of the (1+λ)
strategy ``torch.linalg.cholesky`` and the eigendecomposition
``torch.linalg.eigh`` (``eigh_impl='lapack'``), as the JAX package leaves
them to XLA outside any Pallas kernel; ``eigh_impl='jacobi'`` takes the
port's Jacobi kernel (:func:`deap_tpu_torch.ops.linalg.eigh_jacobi`, J1).
Three traps:

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
(``port_profile.py --cmaes`` reads it; PERF.md). J1 runs a fixed number of
sweeps in one launch and does not.

MO-CMA-ES's update reads three counts on the host in one synchronise (the
selection's fill and boundary front, the most children of one parent);
the JAX package's ``lax.while_loop`` and ``lax.scan`` become host loops of
that many device steps.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from deap_tpu_torch import tuning
from deap_tpu_torch.core.fitness import FitnessSpec, lex_ge, lex_sort_desc
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device
from deap_tpu_torch.mo.emo import nd_rank
from deap_tpu_torch.ops.linalg import eigh_jacobi
from deap_tpu_torch.telemetry import costs

__all__ = ["CMAState", "Strategy", "OnePlusLambdaState",
           "StrategyOnePlusLambda", "MOState", "StrategyMultiObjective",
           "hypervolume_contributions_2d", "field_errors", "state_errors",
           "reconstruction_error"]

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


#: the eigensolvers of ``Strategy(eigh_impl=...)``; each symmetrises C
_EIGH = {"lapack": _eigh, "jacobi": eigh_jacobi}


def _resolve_eigh_impl(dim: int, device: torch.device) -> str:
    """``eigh_impl='auto'`` through the dispatch tuner: race
    ``torch.linalg.eigh`` against J1 on a seeded SPD matrix of this
    dimension on ``device``. The two solvers are *not* bit-identical, so
    — unlike every other knob — the probe cross-checks by reconstruction
    residual (``‖B·diag(d)·Bᵀ − C‖ ≤ 1e-3·‖C‖``, both bases must
    reconstruct C) instead of bitwise equality. With no tuner the
    default is ``'lapack'``."""
    candidates = {"lapack": None, "jacobi": None}
    check: object = None
    if tuning.active_tuner() is not None and tuning.is_concrete():
        g = torch.Generator(device=device).manual_seed(0)
        A = torch.randn((dim, dim), generator=g, device=device)
        C = A @ A.T / dim + torch.eye(dim, device=device)
        candidates = {name: (lambda fn=fn: fn(C))
                      for name, fn in _EIGH.items()}

        def check(results):
            norm = float(torch.linalg.norm(C))
            for d, B in results.values():
                resid = B @ torch.diag(d) @ B.T - C
                if float(torch.linalg.norm(resid)) > 1e-3 * norm:
                    return False
            return True

    return tuning.resolve(
        "eigh_impl", bucket=(tuning.shape_bucket(dim),),
        default="lapack", candidates=candidates, check=check,
        program="cma_eigh", device=device)


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
    (``torch.linalg.eigh``), ``'jacobi'``
    (:func:`deap_tpu_torch.ops.linalg.eigh_jacobi`: J1 on the card, one
    launch an eigendecomposition) or ``'auto'``: the dispatch tuner's
    pick (:func:`_resolve_eigh_impl`), ``'lapack'`` with no tuner. The
    program observatory profiles the solver as ``cma_eigh``.
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
        if eigh_impl == "auto":
            eigh_impl = _resolve_eigh_impl(self.dim, self.device)
        if eigh_impl not in _EIGH:
            raise ValueError(f"unknown eigh_impl {eigh_impl!r} "
                             "(expected 'lapack', 'jacobi' or 'auto')")
        self.eigh_impl = eigh_impl
        self._eigh = costs.instrument(_EIGH[eigh_impl], "cma_eigh")
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
        evals, B = self._eigh(C)
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
            evals, B = self._eigh(C)
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
    out = field_errors(got, want, names=("centroid", "ps", "pc", "C",
                                         "sigma"))
    ok = out.pop("ok")
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


def field_errors(got, want, names=None, exact=(), rtol: float = RTOL,
                 frac: float = ATOL_FRAC) -> dict:
    """A strategy state against a reference's after the same update, field
    by field (dataclass states, both on the same device; ``names`` defaults
    to every field): the fields in ``exact`` equal, the others within
    ``rtol`` of the reference plus ``frac`` of its largest entry. Returns
    the verdict ``ok`` and each field's largest error in units of its
    bound."""
    out, ok = {}, True
    for name in names or [f.name for f in dataclasses.fields(got)]:
        a, b = getattr(got, name), getattr(want, name)
        if name in exact:
            same = a.shape == b.shape and bool(torch.equal(a, b))
            out[name] = 0.0 if same else math.inf
            ok &= same
            continue
        a, b = a.double(), b.double()
        bound = rtol * b.abs() + frac * b.abs().max()
        err = (a - b).abs()
        out[name] = float((err / bound).nan_to_num(0.0, math.inf).max())
        ok &= bool((err <= bound).all())
    out["ok"] = ok
    return out


# ==================================================== StrategyOnePlusLambda ==

@dataclasses.dataclass(frozen=True)
class OnePlusLambdaState:
    """State of the (1+λ)-CMA-ES."""

    parent: torch.Tensor     # [dim]
    parent_w: torch.Tensor   # [nobj] weighted fitness of the parent
    sigma: torch.Tensor      # scalar
    C: torch.Tensor          # [dim, dim]
    A: torch.Tensor          # [dim, dim] lower Cholesky factor of C
    pc: torch.Tensor         # [dim]
    psucc: torch.Tensor      # scalar, the smoothed success rate


#: one (1+λ) update against a reference's from the same state and
#: offspring: ``parent`` and ``parent_w`` equal (the improvement test
#: compares the same float32 values); the rest within ``RTOL`` plus
#: ``ATOL_FRAC`` of the largest entry (``field_errors``): the float32
#: products, the Cholesky factorisation and ``exp`` round in another order
#: or another library
ONE_PLUS_LAMBDA_EXACT = ("parent", "parent_w")


class StrategyOnePlusLambda:
    """(1+λ)-CMA-ES with success-rule step-size control (Igel, Hansen and
    Roth 2007). The parent is replaced only by an offspring at least as
    good; the covariance adapts by a rank-one update whose form depends on
    the smoothed success rate against ``pthresh``. ``params`` overrides
    ``lambda_`` (1), ``d``, ``ptarg``, ``cp``, ``cc``, ``ccov`` and
    ``pthresh`` by name."""

    #: gauges of the adaptation's health (:meth:`metrics`)
    metric_names = ("sigma", "psucc")

    def __init__(self, parent, parent_fitness, sigma: float,
                 spec: FitnessSpec = FitnessSpec((-1.0,)),
                 device: DeviceLike = None, **params):
        self.device = resolve_device(device)
        self._parent0 = torch.as_tensor(parent, dtype=torch.float32,
                                        device=self.device)
        self._parent_fitness0 = torch.as_tensor(
            parent_fitness, dtype=torch.float32,
            device=self.device).reshape(-1)
        self.dim = int(self._parent0.shape[0])
        self._sigma0 = float(sigma)
        self.spec = spec
        self.lambda_ = int(params.get("lambda_", 1))
        self.d = params.get("d", 1.0 + self.dim / (2.0 * self.lambda_))
        self.ptarg = params.get(
            "ptarg", 1.0 / (5 + math.sqrt(self.lambda_) / 2.0))
        self.cp = params.get(
            "cp", self.ptarg * self.lambda_ / (2 + self.ptarg * self.lambda_))
        self.cc = params.get("cc", 2.0 / (self.dim + 2.0))
        self.ccov = params.get("ccov", 2.0 / (self.dim ** 2 + 6.0))
        self.pthresh = params.get("pthresh", 0.44)

    def initial_state(self) -> OnePlusLambdaState:
        eye = torch.eye(self.dim, device=self.device)
        return OnePlusLambdaState(
            parent=self._parent0.clone(),
            parent_w=self.spec.wvalues(self._parent_fitness0),
            sigma=torch.tensor(self._sigma0, dtype=torch.float32,
                               device=self.device),
            C=eye, A=eye.clone(),
            pc=torch.zeros(self.dim, device=self.device),
            psucc=torch.tensor(self.ptarg, dtype=torch.float32,
                               device=self.device))

    def sample(self, state: OnePlusLambdaState,
               arz: torch.Tensor) -> torch.Tensor:
        """The samples of standard normals ``arz [λ, dim]``: ``parent + σ ·
        arz · Aᵀ``."""
        return state.parent + state.sigma * arz @ state.A.T

    def generate(self, generator: torch.Generator,
                 state: OnePlusLambdaState) -> torch.Tensor:
        """λ samples, ``arz`` drawn with ``torch.randn`` on ``generator``."""
        check_generator(generator, self.device)
        arz = torch.randn((self.lambda_, self.dim), generator=generator,
                          device=self.device)
        return self.sample(state, arz)

    def metrics(self, state: OnePlusLambdaState) -> dict:
        """Step size and the smoothed success rate."""
        return {"sigma": state.sigma, "psucc": state.psucc}

    def update(self, state: OnePlusLambdaState, genomes: torch.Tensor,
               values: torch.Tensor) -> OnePlusLambdaState:
        """The success-rate and rank-one covariance update. ``values`` are
        raw objectives; "at least as good" is the lexicographic compare of
        weighted values."""
        w = self.spec.wvalues(values if values.ndim == 2 else values[:, None])
        succ = lex_ge(w, state.parent_w[None, :])
        p_succ = succ.to(torch.float32).mean()
        psucc = (1 - self.cp) * state.psucc + self.cp * p_succ

        best_i = lex_sort_desc(w)[0]
        best, best_w = genomes[best_i], w[best_i]
        improved = lex_ge(best_w, state.parent_w)

        x_step = (best - state.parent) / state.sigma
        below = psucc < self.pthresh
        pc_lo = (1 - self.cc) * state.pc + math.sqrt(
            self.cc * (2 - self.cc)) * x_step
        C_lo = (1 - self.ccov) * state.C + self.ccov * torch.outer(pc_lo,
                                                                   pc_lo)
        pc_hi = (1 - self.cc) * state.pc
        C_hi = (1 - self.ccov) * state.C + self.ccov * (
            torch.outer(pc_hi, pc_hi) + self.cc * (2 - self.cc) * state.C)
        pc_new = torch.where(below, pc_lo, pc_hi)
        C_new = torch.where(below, C_lo, C_hi)

        parent = torch.where(improved, best, state.parent)
        parent_w = torch.where(improved, best_w, state.parent_w)
        pc = torch.where(improved, pc_new, state.pc)
        C = torch.where(improved, C_new, state.C)

        sigma = state.sigma * torch.exp(
            (psucc - self.ptarg) / (self.d * (1.0 - self.ptarg)))
        # cholesky_ex: no synchronise to check the factorisation (the JAX
        # package's cholesky returns NaNs where C is not positive definite)
        A = torch.linalg.cholesky_ex(C).L
        return OnePlusLambdaState(parent=parent, parent_w=parent_w,
                                  sigma=sigma, C=C, A=A, pc=pc, psucc=psucc)


# ==================================================== StrategyMultiObjective

@dataclasses.dataclass(frozen=True)
class MOState:
    """The µ parents of MO-CMA-ES, each a (1+1)-CMA-ES."""

    x: torch.Tensor       # [mu, dim] search points
    w: torch.Tensor       # [mu, nobj] weighted fitness
    sigmas: torch.Tensor  # [mu]
    A: torch.Tensor       # [mu, dim, dim] lower Cholesky factors
    invA: torch.Tensor    # [mu, dim, dim] their inverses
    pc: torch.Tensor      # [mu, dim]
    psucc: torch.Tensor   # [mu]


#: one MO-CMA-ES update against a reference's from the same state and
#: offspring: ``x`` and ``w`` equal (the selection is discrete and its
#: contributions are the same float32 operations); the rest within
#: ``RTOL`` plus ``ATOL_FRAC`` of the largest entry (``field_errors``;
#: measured 0.013 of that bound): the rank-one factor updates chain float32
#: products that XLA contracts
MO_EXACT = ("x", "w")


def _rank_one_update(invA, A, alpha: float, beta: float, v):
    """The Cholesky factor and its inverse after ``C' = αC + β v vᵀ``,
    batched over leading axes, in O(dim²) a member; an update whose
    ``A⁻¹v`` is below 1e-20 everywhere is skipped."""
    w = torch.einsum("...ij,...j->...i", invA, v)
    norm_w2 = (w * w).sum(-1, keepdim=True)[..., None]           # [.., 1, 1]
    a = math.sqrt(alpha)
    root = torch.sqrt(1.0 + beta / alpha * norm_w2)
    b = torch.where(norm_w2 > 0,
                    a / torch.clamp(norm_w2, min=1e-30) * (root - 1.0), 0.0)
    w_inv = torch.einsum("...i,...ij->...j", w, invA)
    A_new = a * A + b * v[..., :, None] * w[..., None, :]
    invA_new = (1.0 / a) * invA - (
        b / (a ** 2 + a * b * norm_w2)) * w[..., :, None] * w_inv[..., None, :]
    skip = (w.abs().amax(-1) <= 1e-20)[..., None, None]
    return torch.where(skip, invA, invA_new), torch.where(skip, A, A_new)


#: the 2-D contributions' sentinel, float32's 3.4e38 (exact as a Python
#: float, so no tensor is made from host data on the card)
_BIG = float(np.float32(3.4e38))


def hypervolume_contributions_2d(w: torch.Tensor, mask: torch.Tensor,
                                 ref: torch.Tensor) -> torch.Tensor:
    """The exclusive hypervolume contribution of each masked point of a
    2-objective set, exact; dominated and unmasked points contribute 0.

    ``w`` holds weighted (maximisation) values and ``ref`` the (smaller)
    reference point. Sorted by descending first objective (stable), the
    non-dominated staircase has strictly increasing second objective, and
    an active point's contribution is ``(x_i − x_next_active) · (y_i −
    y_prev_active)``, the reference point closing both ends.
    """
    n = w.shape[0]
    low = -_BIG
    x = torch.where(mask, w[:, 0], low)
    y = torch.where(mask, w[:, 1], low)
    order = torch.argsort(-x, stable=True)            # descending x
    xs, ys = x[order], y[order]
    end = torch.full((1,), low, device=w.device)
    # y of the previous active point: the running max of y before i
    ymax_before = torch.cat([end, torch.cummax(ys, 0).values[:-1]])
    active = (ys > ymax_before) & (xs > low)
    # x of the next active point: the max x among actives after i
    ax_rev = torch.where(active, xs, low).flip(0)
    next_active_x = torch.cat([torch.cummax(ax_rev, 0).values.flip(0)[1:],
                               end])
    x_low = torch.where(next_active_x <= low, ref[0], next_active_x)
    y_low = torch.maximum(ymax_before, ref[1])
    contrib = torch.where(active, (xs - x_low) * (ys - y_low), 0.0)
    contrib = torch.clamp(contrib, min=0.0)
    out = torch.zeros(n, device=w.device).index_put((order,), contrib)
    return out * mask


def _child_order(parent: torch.Tensor) -> torch.Tensor:
    """Each offspring's place among its parent's children, in offspring
    order (0 for the first child of a parent)."""
    lam = parent.shape[0]
    order = torch.sort(parent, stable=True).indices
    sp = parent[order]
    pos = torch.arange(lam, device=parent.device)
    start = torch.ones(lam, dtype=torch.bool, device=parent.device)
    start[1:] = sp[1:] != sp[:-1]
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    return torch.empty_like(pos).index_put((order,), pos - first)


class StrategyMultiObjective:
    """MO-CMA-ES (Voss, Hansen and Igel 2010): µ independent (1+1)
    strategies and indicator-based environmental selection.

    ``generate`` returns ``{"x": [λ, dim], "parent": int64[λ]}`` so that
    ``update`` knows each offspring's parent; evaluators read
    ``genomes["x"]``. Selection keeps the best µ of offspring and parents
    by non-domination rank, then trims the boundary front by removing its
    least hypervolume contributor one at a time (exact in 2 objectives; a
    negated-crowding proxy above). ``params`` overrides ``d``, ``ptarg``,
    ``cp``, ``cc``, ``ccov`` and ``pthresh`` by name.
    """

    #: gauges of the adaptation's health (:meth:`metrics`)
    metric_names = ("sigma_mean", "sigma_min", "psucc_mean")

    def __init__(self, population, fitnesses, sigma: float,
                 mu: Optional[int] = None, lambda_: int = 1,
                 spec: FitnessSpec = FitnessSpec((-1.0, -1.0)),
                 device: DeviceLike = None, **params):
        self.device = resolve_device(device)
        x0 = torch.as_tensor(population, dtype=torch.float32,
                             device=self.device)
        self.mu = int(mu if mu is not None else x0.shape[0])
        self.lambda_ = int(lambda_)
        self.dim = int(x0.shape[1])
        self.spec = spec
        self._x0 = x0
        self._f0 = torch.as_tensor(fitnesses, dtype=torch.float32,
                                   device=self.device)
        self._sigma0 = float(sigma)
        self.d = params.get("d", 1.0 + self.dim / 2.0)
        self.ptarg = params.get("ptarg", 1.0 / (5.0 + 0.5))
        self.cp = params.get("cp", self.ptarg / (2.0 + self.ptarg))
        self.cc = params.get("cc", 2.0 / (self.dim + 2.0))
        self.ccov = params.get("ccov", 2.0 / (self.dim ** 2 + 6.0))
        self.pthresh = params.get("pthresh", 0.44)

    def initial_state(self) -> MOState:
        mu, dim, dev = self.mu, self.dim, self.device
        eye = torch.eye(dim, device=dev).expand(mu, dim, dim)
        return MOState(
            x=self._x0[:mu].clone(), w=self.spec.wvalues(self._f0[:mu]),
            sigmas=torch.full((mu,), self._sigma0, dtype=torch.float32,
                              device=dev),
            A=eye.clone(), invA=eye.clone(),
            pc=torch.zeros((mu, dim), device=dev),
            psucc=torch.full((mu,), self.ptarg, dtype=torch.float32,
                             device=dev))

    def sample(self, state: MOState, arz: torch.Tensor,
               scores: Optional[torch.Tensor] = None) -> dict:
        """The offspring of standard normals ``arz [λ, dim]``, each from a
        parent: its own index when λ == µ, else the first-front parent
        with the largest of its row of ``scores [λ, µ]`` (uniform draws;
        the first index on a tie)."""
        if self.lambda_ == self.mu:
            parent = torch.arange(self.mu, device=arz.device)
        else:
            front = nd_rank(state.w) == 0
            parent = torch.argmax(torch.where(front[None, :], scores, -1.0),
                                  dim=1)
        x = state.x[parent] + state.sigmas[parent, None] * torch.einsum(
            "pij,pj->pi", state.A[parent], arz)
        return {"x": x, "parent": parent}

    def generate(self, generator: torch.Generator, state: MOState) -> dict:
        """λ offspring: ``arz`` with ``torch.randn`` on ``generator``, then,
        for λ != µ, the parents' scores with ``torch.rand``."""
        check_generator(generator, self.device)
        arz = torch.randn((self.lambda_, self.dim), generator=generator,
                          device=self.device)
        scores = None if self.lambda_ == self.mu else torch.rand(
            (self.lambda_, self.mu), generator=generator, device=self.device)
        return self.sample(state, arz, scores)

    def metrics(self, state: MOState) -> dict:
        """The mean and least step size and the mean success rate of the µ
        strategies."""
        return {"sigma_mean": state.sigmas.mean(),
                "sigma_min": state.sigmas.min(),
                "psucc_mean": state.psucc.mean()}

    # ------------------------------------------------------------ update ----

    def _select_plan(self, w_all: torch.Tensor):
        """Whole fronts in rank order: ``(ahead, mid, k_fill, n_mid)``, the
        rows ranked before the boundary front, the boundary front, how
        many of it to keep and its size (the last two on the device)."""
        ranks = nd_rank(w_all)
        cut = torch.sort(ranks).values[self.mu - 1]
        ahead, mid = ranks < cut, ranks == cut
        return ahead, mid, self.mu - ahead.sum(), mid.sum()

    def _trim(self, w_all: torch.Tensor, mask: torch.Tensor,
              drops: int) -> torch.Tensor:
        """``mask`` less its ``drops`` least contributors, removed one at a
        time (the first on a tie); the reference point is the worst of
        each objective less 1."""
        n, nobj = w_all.shape
        ref = w_all.min(0).values - 1.0
        idx = torch.arange(n, device=w_all.device)
        if nobj != 2 and drops > 0:
            d2 = ((w_all[:, None, :] - w_all[None, :, :]) ** 2).sum(-1)
            d2 = torch.where(torch.eye(n, dtype=torch.bool,
                                       device=w_all.device), torch.inf, d2)
        for _ in range(drops):
            if nobj == 2:
                contrib = hypervolume_contributions_2d(w_all, mask, ref)
            else:
                # a density proxy, the negated crowding of the JAX package
                both = mask[None, :] & mask[:, None]
                contrib = torch.where(both, d2, torch.inf).min(1).values
            contrib = torch.where(mask, contrib, torch.inf)
            mask = mask & (idx != torch.argmin(contrib))
        return mask

    def _select_mask(self, w_all: torch.Tensor) -> torch.Tensor:
        """The µ of the λ + µ candidates that survive: whole fronts in
        rank order, the boundary front trimmed. One synchronise reads the
        number of drops."""
        ahead, mid, k_fill, n_mid = self._select_plan(w_all)
        k_fill, n_mid = torch.stack([k_fill, n_mid]).tolist()
        return ahead | self._trim(w_all, mid, n_mid - k_fill)

    def update(self, state: MOState, genomes: dict,
               values: torch.Tensor) -> MOState:
        """Environmental selection, then each parent's success and step
        size and each offspring's new entry. Candidates are ordered
        [offspring, parents]. One synchronise reads the selection's number
        of drops and the most children of one parent."""
        mu, lam = self.mu, self.lambda_
        off_x, parent_idx = genomes["x"], genomes["parent"]
        off_w = self.spec.wvalues(values)
        w_all = torch.cat([off_w, state.w], dim=0)          # [λ+µ, nobj]

        ahead, mid, k_fill, n_mid = self._select_plan(w_all)
        occ = _child_order(parent_idx)
        k_fill, n_mid, rounds = torch.stack(
            [k_fill, n_mid, occ.max() + 1]).tolist()
        chosen = ahead | self._trim(w_all, mid, n_mid - k_fill)

        # each parent's success rate and step size after its children, in
        # offspring order: round j applies every parent's j-th child at
        # once (several children of one parent compound)
        slot = torch.full((rounds, mu), lam, device=parent_idx.device)
        slot[occ, parent_idx] = torch.arange(lam, device=parent_idx.device)
        par_psucc, par_sigmas = state.psucc, state.sigmas
        for j in range(rounds):
            child = slot[j]
            has = child < lam
            succ = chosen[torch.clamp(child, max=lam - 1)]
            kept = (1 - self.cp) * par_psucc
            new_p = torch.where(succ, kept + self.cp, kept)
            new_s = par_sigmas * torch.exp(
                (new_p - self.ptarg) / (self.d * (1.0 - self.ptarg)))
            par_psucc = torch.where(has, new_p, par_psucc)
            par_sigmas = torch.where(has, new_s, par_sigmas)

        # each offspring's entry: its parent's at the update's start,
        # updated as a success
        p = parent_idx
        last_steps = state.sigmas[p]
        o_psucc = (1 - self.cp) * state.psucc[p] + self.cp
        o_sigmas = state.sigmas[p] * torch.exp(
            (o_psucc - self.ptarg) / (self.d * (1.0 - self.ptarg)))
        x_step = (off_x - state.x[p]) / last_steps[:, None]
        below = (o_psucc < self.pthresh)[:, None]
        pc_lo = (1 - self.cc) * state.pc[p] + math.sqrt(
            self.cc * (2 - self.cc)) * x_step
        pc_hi = (1 - self.cc) * state.pc[p]
        o_pc = torch.where(below, pc_lo, pc_hi)
        alpha_lo = 1 - self.ccov
        alpha_hi = 1 - self.ccov + self.cc * (2.0 - self.cc)
        inv_lo, A_lo = _rank_one_update(state.invA[p], state.A[p], alpha_lo,
                                        self.ccov, pc_lo)
        inv_hi, A_hi = _rank_one_update(state.invA[p], state.A[p], alpha_hi,
                                        self.ccov, pc_hi)
        o_A = torch.where(below[:, :, None], A_lo, A_hi)
        o_invA = torch.where(below[:, :, None], inv_lo, inv_hi)

        # the next parents: the µ chosen candidates in candidate order; an
        # offspring brings its new entry, a parent its updated own one
        n = lam + mu
        idx = torch.arange(n, device=w_all.device)
        sel_idx = torch.sort(torch.where(chosen, idx, n),
                             stable=True).indices[:mu]
        off_sel = sel_idx < lam
        oi = torch.clamp(sel_idx, max=lam - 1)
        pi = torch.clamp(sel_idx - lam, 0, mu - 1)

        def pick(off_arr, par_arr):
            o, q = off_arr[oi], par_arr[pi]
            return torch.where(off_sel.reshape((-1,) + (1,) * (o.ndim - 1)),
                               o, q)

        x_all = torch.cat([off_x, state.x], dim=0)
        return MOState(x=x_all[sel_idx], w=w_all[sel_idx],
                       sigmas=pick(o_sigmas, par_sigmas),
                       A=pick(o_A, state.A), invA=pick(o_invA, state.invA),
                       pc=pick(o_pc, state.pc),
                       psucc=pick(o_psucc, par_psucc))
