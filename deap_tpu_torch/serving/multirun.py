"""The run axis — N independent runs advanced together, a batched pass a
generation.

Port of :mod:`deap_tpu.serving.multirun`. The JAX engine vmaps each
family's step across lanes inside one ``lax.scan``; the port runs one
Python loop over generations in which every active lane

- **draws from its own generator**, the same calls in the same order as
  its solo step (``ea_simple``: the tournament aspirants, then
  :func:`~deap_tpu_torch.ops.variation.var_and_masks`; (μ ± λ):
  :func:`~deap_tpu_torch.ops.variation.var_or_masks`, then the
  survivors' selection; CMA-ES: ``toolbox.generate``), with its own
  ``cxpb``/``mutpb``;
- then **one variation plane runs over the stacked rows of all active
  lanes** (``var_and_apply``/``var_or_apply`` with lane-offset parents
  and partners: K1 on the card, one launch a generation, as the island
  pass does), followed by the evaluation (:func:`evaluate_lanes`: one
  call over the stacked rows when the fitness is integer-valued, each
  lane's own rows otherwise);
- and each lane's tail of the generation (the (μ ± λ) survivors'
  selection, hall of fame, record and meter row) is its solo step's
  ``told``, on its own slice, in its own shape.

Correctness contract — **per-lane bit identity with the solo loops**: a
lane's population, logbook, hall of fame and meter rows equal those of
:func:`~deap_tpu_torch.algorithms.ea_simple` (and the other three loops)
run from a generator in the state the lane started with. Generators are
independent, so the order in which lanes draw does not matter; only
the order within a lane does, and it is the solo step's. What batches
is row-independent work (tournament winners, the variation plane, an
integer-valued evaluation); what may round with its operand's shape (a
float-valued evaluation, statistics, the hall of fame, the meter, CMA's
products) runs on each lane's own slice, copied out so its shape and
alignment are the solo loop's.

A lane's randomness is a ``torch.Generator`` on the bucket's device, in
place of the JAX lane's pre-split keys. A lane dict holds its
``get_state()`` (``"rng"``), so it is part of the swap unit and the
checkpoint; :meth:`MultiRunEngine.pack` builds the batch's generators
from those states and :meth:`MultiRunEngine.unpack` reads them back.

A finished lane (``gen >= ngen``) draws nothing and is left out of the
plane: its state stays as it was. The JAX engine's shadow-carry latch
(a vmapped step always advances every lane, so a finished lane's state
must be latched aside) has nothing to guard here.

Toolboxes the batched pass cannot take (a selection other than
tournaments for ``ea_simple``, a (mate, mutate) pair that is not
fused-capable, multi-leaf genomes, ``fused=False``) step lane by lane
through the solo step. CMA-ES buckets generate, evaluate and update lane
by lane (each lane's matrix products in its own shape); with
``Strategy(eigh_impl='jacobi')`` the lanes' covariance matrices are
decomposed by **one J1 launch over** ``[R, d, d]``, with ``'lapack'``
by ``torch.linalg.eigh`` lane by lane (journaled
``serving_eigh_hint``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch import algorithms as algos
from deap_tpu_torch.core.population import Population, concat
from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.ops import selection as _sel
from deap_tpu_torch.ops import variation as _variation
from deap_tpu_torch.ops.kernels import KERNEL_DTYPES
from deap_tpu_torch.support.hof import hof_init, hof_update
from deap_tpu_torch.telemetry import costs
from deap_tpu_torch.telemetry.journal import broadcast

__all__ = ["MultiRunEngine", "FAMILIES", "evaluate_lanes", "multirun"]

#: the loop families THIS engine's run axis covers; the GP loop and the
#: island epoch driver ride the same lane/batch/segment protocol through
#: :mod:`deap_tpu_torch.serving.gp_multirun` ("gp" / "island" families)
FAMILIES = ("ea_simple", "ea_mu_plus_lambda", "ea_mu_comma_lambda",
            "ea_generate_update")

#: per-family hyperparameters that may vary per run (everything else —
#: mu/lambda/population shape/operators — is static per bucket)
_HYPER_NAMES = {
    "ea_simple": ("cxpb", "mutpb"),
    "ea_mu_plus_lambda": ("cxpb", "mutpb"),
    "ea_mu_comma_lambda": ("cxpb", "mutpb"),
    "ea_generate_update": (),
}


# ------------------------------------------------------------ the draws ----

def simple_lane_draws(generator: torch.Generator, n: int, length: int,
                      tournsize: int, cxpb: float, mutpb: float, vplan,
                      dtype):
    """One ``ea_simple`` lane's draws of a generation, in its solo step's
    order: the tournament aspirants ``int64[n, tournsize]``, then
    :func:`~deap_tpu_torch.ops.variation.var_and_masks`."""
    aspirants = _sel.tournament_aspirants(generator, n, n, tournsize)
    masks = _variation.var_and_masks(generator, n, length, cxpb, mutpb,
                                     vplan, dtype)
    return aspirants, masks


def or_lane_draws(generator: torch.Generator, n: int, lambda_: int,
                  length: int, cxpb: float, mutpb: float, vplan, dtype):
    """One (μ ± λ) lane's variation draws of a generation:
    :func:`~deap_tpu_torch.ops.variation.var_or_masks` (the survivors'
    selection draws after the plane, as in the solo step)."""
    return _variation.var_or_masks(generator, n, lambda_, length, cxpb,
                                   mutpb, vplan, dtype)


# --------------------------------------------------------------- helpers ----

def _rows(pop: Population, lo: int, hi: int) -> Population:
    """Rows ``[lo, hi)`` of ``pop`` as a population of their own, every
    leaf copied: a lane's slice then has the solo loop's shape, memory
    order and alignment, so what reduces over it rounds as there."""
    take = lambda a: a[lo:hi].clone()
    return pop.replace(genomes=pytree.tree_map(take, pop.genomes),
                       fitness=take(pop.fitness), valid=take(pop.valid),
                       extras=pytree.tree_map(take, pop.extras))


def evaluate_lanes(off: Population, evaluate: Callable,
                   n: int) -> List[Population]:
    """Each lane's rows of ``off`` (stacked lanes of ``n`` rows), copied
    out and evaluated as the lane's solo step evaluates its own
    (:func:`~deap_tpu_torch.algorithms.evaluate_invalid`).

    The first lane's rows are evaluated alone. When that evaluation
    returns integer values (OneMax's count), the fitness is exact at any
    row count, and the other lanes' rows go through one call. A
    float-valued evaluation may round with its row count (another
    reduction configuration, another cuBLAS kernel), so every lane's
    rows are then evaluated in the lane's own shape."""
    R = off.size // n
    first = _rows(off, 0, n)
    values = algos._as2d(evaluate(first.genomes))
    lanes = [first.with_fitness(values, mask=~first.valid)]
    if R == 1:
        return lanes
    if values.dtype.is_floating_point:
        return lanes + [
            algos.evaluate_invalid(_rows(off, r * n, (r + 1) * n), evaluate)
            for r in range(1, R)]
    rest = algos.evaluate_invalid(_rows(off, n, R * n), evaluate)
    return lanes + [_rows(rest, r * n, (r + 1) * n) for r in range(R - 1)]


def _cat_masks(parts: Sequence[tuple]) -> tuple:
    return tuple(None if parts[0][j] is None
                 else torch.cat([p[j] for p in parts])
                 for j in range(len(parts[0])))


def _generator_from(state: torch.Tensor, device: torch.device
                    ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.set_state(state.cpu())  # a restore may have placed it on the card
    return g


def _strategy_of(toolbox):
    """The strategy whose bound ``update`` the toolbox registers, or
    None."""
    upd = getattr(toolbox, "update", None)
    return getattr(getattr(upd, "func", upd), "__self__", None)


class MultiRunEngine:
    """The run axis of one *bucket* of jobs.

    A bucket fixes everything shape- or program-relevant: the loop
    ``family``, the ``toolbox`` (operators and evaluate: tenants of a
    bucket share the problem), the population shape and dtype, mu/lambda,
    statistics, probes, telemetry and the hall of fame's size. Per run:
    the generator's state, the initial population or strategy state,
    ``ngen`` and the family's hyperparameters (``cxpb``/``mutpb``;
    CMA-ES's sigma and centroid through the initial state).

    Lifecycle::

        eng = MultiRunEngine("ea_simple", toolbox, stats=stats,
                             device="cuda")
        lanes = [eng.lane_init(gen_r, pop_r, ngen_r,
                               {"cxpb": 0.5, "mutpb": 0.2}) for ...]
        batch = eng.pack(lanes)
        batch, seg = eng.advance(batch, k=10)      # one segment
        lane = eng.unpack(batch, i)                # the swap unit
        pop, logbook, hof = eng.lane_result(
            lane, eng.lane_records([seg], i))

    ``lane_init`` reads the generator's state and never draws from it:
    a lane's result is the solo run from that state. ``telemetry`` (a
    :class:`~deap_tpu_torch.telemetry.RunTelemetry`) keeps one meter
    state a lane, whose rows :meth:`lane_meter_rows` decodes at segment
    boundaries; live streaming (``stream=True``) is refused, as in the
    JAX engine.
    """

    def __init__(self, family: str, toolbox, *, mu: Optional[int] = None,
                 lambda_: Optional[int] = None, spec=None,
                 state_template=None, stats=None, telemetry=None,
                 probes=(), halloffame_size: int = 0, fused="auto",
                 device: DeviceLike = None):
        if family not in FAMILIES:
            raise ValueError(f"unknown loop family {family!r} "
                             f"(known: {FAMILIES})")
        self.family = family
        self.toolbox = toolbox
        self.mu = mu
        self.lambda_ = lambda_
        self.spec = spec
        self.stats = stats
        self.tel = telemetry
        self.probes = tuple(probes or ())
        self.halloffame_size = int(halloffame_size)
        self.fused = fused
        self.device = resolve_device(device)
        self.gen_offset = 0 if family == "ea_generate_update" else 1
        self.hyper_names = _HYPER_NAMES[family]
        self._steps: Dict[tuple, Callable] = {}
        self._journaled = False
        self.strategy = None
        algos._check_probes(self.probes, self.tel)
        if self.tel is not None:
            if getattr(self.tel, "stream", False):
                raise ValueError(
                    "multirun: telemetry stream=True is unsupported "
                    "(per-lane live rows interleave); decode rows at "
                    "segment boundaries instead")
            self.tel.begin_run(
                f"multirun/{family}", toolbox,
                declare=algos._tel_declare, probes=self.probes,
                serving=True)
        if family == "ea_generate_update":
            if spec is None or state_template is None:
                raise ValueError(
                    "ea_generate_update needs spec= (FitnessSpec) and "
                    "state_template= (one strategy state, the shape "
                    "template for λ and the hall of fame)")
            self.lam, self._hof0 = self._learn_lambda(state_template)
            strat = _strategy_of(toolbox)
            if strat is not None and hasattr(strat, "update_moments"):
                self.strategy = strat
            if getattr(strat, "eigh_impl", None) == "lapack":
                broadcast(
                    "serving_eigh_hint", family=family,
                    dim=getattr(strat, "dim", None),
                    hint="CMA bucket uses eigh_impl='lapack': "
                         "torch.linalg.eigh runs lane by lane; "
                         "Strategy(eigh_impl='jacobi') decomposes every "
                         "lane's matrix in one J1 launch")
        elif family != "ea_simple" and (mu is None or lambda_ is None):
            raise ValueError(f"{family} needs mu= and lambda_=")
        # the observatory profiles a segment under the bucket's label, as
        # the JAX engine instruments its segment program
        self._advance = costs.instrument(
            self._segment, label=f"serving/{family}/advance",
            signature=lambda batch, k: (k, len(batch["lanes"])))

    # ------------------------------------------------------------ setup ----

    def _learn_lambda(self, state_template):
        """λ and the empty hall of fame from one ``generate`` on a scratch
        generator: no lane's generator draws for it (the JAX engine traces
        the shapes with ``jax.eval_shape``)."""
        scratch = torch.Generator(device=self.device).manual_seed(0)
        genomes = self.toolbox.generate(scratch, state_template)
        values = algos._as2d(self.toolbox.evaluate(genomes))
        return algos._generate_update_init(genomes, values, self.spec,
                                           self.halloffame_size)

    def _check_hyper(self, hyper) -> Dict[str, float]:
        hyper = dict(hyper or {})
        missing = [h for h in self.hyper_names if h not in hyper]
        if missing:
            raise ValueError(f"{self.family} lane needs hyper {missing}")
        extra = [h for h in hyper if h not in self.hyper_names]
        if extra:
            raise ValueError(f"{self.family} takes no hyper {extra}")
        out = {h: float(hyper[h]) for h in self.hyper_names}
        if self.family in ("ea_mu_plus_lambda", "ea_mu_comma_lambda"):
            algos._check_cx_mut(out["cxpb"], out["mutpb"])
        return out

    def _check_generator(self, generator: torch.Generator) -> None:
        if generator.device.type != self.device.type:
            raise ValueError(f"lane generator lives on {generator.device}, "
                             f"the bucket on {self.device}")

    def _solo_step(self, hyper: Dict[str, float]) -> Callable:
        """The family's solo step for one lane's hyperparameters — the
        step the solo loop calls (cached per value)."""
        key = tuple(hyper[h] for h in self.hyper_names)
        step = self._steps.get(key)
        if step is not None:
            return step
        tb, stats, tel = self.toolbox, self.stats, self.tel
        if self.family == "ea_simple":
            step = algos.make_ea_simple_step(tb, hyper["cxpb"],
                                             hyper["mutpb"], stats, tel,
                                             fused=self.fused)
        elif self.family == "ea_mu_plus_lambda":
            step = algos.make_ea_mu_plus_lambda_step(
                tb, self.mu, self.lambda_, hyper["cxpb"], hyper["mutpb"],
                stats, tel, fused=self.fused)
        elif self.family == "ea_mu_comma_lambda":
            step = algos.make_ea_mu_comma_lambda_step(
                tb, self.mu, self.lambda_, hyper["cxpb"], hyper["mutpb"],
                stats, tel, fused=self.fused)
        else:
            step = algos.make_ea_generate_update_step(tb, self.spec,
                                                      self.lam, stats, tel)
        self._steps[key] = step
        return step

    # ------------------------------------------------------------ lanes ----

    def lane_init(self, generator: torch.Generator, init, ngen: int,
                  hyper: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Any]:
        """One lane from a solo job: ``init`` is the founder
        :class:`Population` (population families) or the initial strategy
        state (ask-tell). Runs the solo loop's gen-0 protocol (founder
        evaluation, hall of fame, gen-0 record and meter row) and
        snapshots ``generator``'s state without drawing from it; returns
        the checkpointable lane dict — the scheduler's swap unit."""
        ngen = int(ngen)
        if ngen < 1:
            raise ValueError("ngen must be >= 1")
        hyper = self._check_hyper(hyper)
        self._check_generator(generator)
        lane: Dict[str, Any] = {"gen": 0, "ngen": ngen,
                                "rng": generator.get_state(),
                                "hyper": hyper, "record0": None,
                                "mstate0": None}
        if self.family == "ea_generate_update":
            carry = {"state": init, "hof": self._hof0}
            if self.tel is not None:
                carry["mstate"] = self.tel.meter.init(device=self.device)
            lane["carry"] = carry
            return lane
        if not isinstance(init, Population):
            raise TypeError(f"{self.family} lane init must be a "
                            f"Population, got {type(init).__name__}")
        pop, hof, record0 = algos._pop_loop_init(
            init.to(self.device), self.toolbox, self.halloffame_size,
            self.stats)
        lane["carry"] = self._carry0(pop, hof, record0)
        lane["record0"] = record0
        lane["mstate0"] = lane["carry"].get("mstate")
        return lane

    def _carry0(self, pop, hof, record0) -> Dict[str, Any]:
        carry = {"pop": pop, "hof": hof}
        if self.tel is not None:
            carry["mstate"] = algos._tel_measure(
                self.tel, self.tel.meter.init(device=self.device),
                record0["nevals"], pop, 0)
        return carry

    def pack_fresh(self, generators, inits, ngen: int,
                   hyper: Optional[Dict[str, Any]] = None, *,
                   n_lanes: Optional[int] = None,
                   horizon: Optional[int] = None) -> Dict[str, Any]:
        """:meth:`lane_init` + :meth:`pack` for a batch of fresh
        same-``ngen`` jobs, with the founders of every lane evaluated in
        one call (the JAX engine's one vmapped admission program). ``hyper``
        values may be scalars (every lane) or per-lane sequences. Each
        lane equals its :meth:`lane_init`."""
        ngen = int(ngen)
        if ngen < 1:
            raise ValueError("ngen must be >= 1")
        generators, inits = list(generators), list(inits)
        R = len(generators)
        if len(inits) != R:
            raise ValueError("len(inits) != len(generators)")
        if n_lanes is not None and R > int(n_lanes):
            raise ValueError("batch exceeds n_lanes")
        hyper = dict(hyper or {})
        hypers = [self._check_hyper(
            {h: (v[r] if isinstance(v, (list, tuple, np.ndarray,
                                        torch.Tensor)) else v)
             for h, v in hyper.items()}) for r in range(R)]
        for g in generators:
            self._check_generator(g)
        if self.family == "ea_generate_update" or R == 0:
            return self.pack([self.lane_init(g, p, ngen, h) for g, p, h in
                              zip(generators, inits, hypers)])
        pops = [p.to(self.device) for p in inits]
        n = pops[0].size
        if any(p.size != n for p in pops):
            raise ValueError("fresh lanes of a bucket share one size")
        nevals = [(~p.valid).sum() for p in pops]
        founders = evaluate_lanes(concat(pops), self.toolbox.evaluate, n)
        lanes = []
        for r, pop in enumerate(founders):
            hof = (hof_update(hof_init(self.halloffame_size, pop), pop)
                   if self.halloffame_size else None)
            record0 = {"nevals": nevals[r],
                       **algos._maybe_stats(self.stats, pop)}
            carry = self._carry0(pop, hof, record0)
            lanes.append({"gen": 0, "ngen": ngen,
                          "rng": generators[r].get_state(),
                          "hyper": hypers[r], "record0": record0,
                          "mstate0": carry.get("mstate"), "carry": carry})
        return self.pack(lanes)

    def pack(self, lanes: Sequence[Dict[str, Any]],
             n_lanes: Optional[int] = None,
             horizon: Optional[int] = None) -> Dict[str, Any]:
        """Lane dicts into one batch: each lane's generator is rebuilt on
        the bucket's device from its state. ``n_lanes`` and ``horizon``
        are the JAX engine's lattice: accepted and checked, never padded
        to (no program here is compiled per shape)."""
        if not lanes:
            raise ValueError("pack needs at least one lane")
        if n_lanes is not None and len(lanes) > int(n_lanes):
            raise ValueError(f"{len(lanes)} lanes > {n_lanes} slots")
        if horizon is not None and \
                max(int(l["ngen"]) for l in lanes) > int(horizon):
            raise ValueError("a lane's ngen exceeds the horizon")
        out = []
        for lane in lanes:
            lane = self._on_pack_lane(dict(lane))
            rng = lane.pop("rng")
            lane["generator"] = _generator_from(rng, self.device)
            out.append(lane)
        return {"lanes": out, "n_real": len(out)}

    def _on_pack_lane(self, lane: Dict[str, Any]) -> Dict[str, Any]:
        return lane

    def unpack(self, batch: Dict[str, Any], i: int) -> Dict[str, Any]:
        """Lane ``i`` out of a batch — the swap unit the scheduler
        checkpoints, its generator as ``get_state()``."""
        lane = dict(batch["lanes"][i])
        lane["rng"] = lane.pop("generator").get_state()
        return lane

    def gens(self, batch: Dict[str, Any]) -> List[int]:
        """Each lane's completed-generation count."""
        return [int(l["gen"]) for l in batch["lanes"]]

    def done(self, batch: Dict[str, Any]) -> np.ndarray:
        """Host bool per lane: the lane finished its budget."""
        return np.array([l["gen"] >= l["ngen"] for l in batch["lanes"]],
                        bool)

    def advance(self, batch: Dict[str, Any], k: int
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Run one segment of ``k`` generations for every lane; returns
        ``(batch, seg)``: ``seg["records"][i]`` and ``seg["mrows"][i]``
        hold lane ``i``'s records and meter states of the generations it
        ran, ``seg["active"]`` the ``[k, lanes]`` activity mask."""
        return self._advance(batch, int(k))

    def _segment(self, batch: Dict[str, Any], k: int):
        lanes = batch["lanes"]
        R = len(lanes)
        records: List[List[Any]] = [[] for _ in range(R)]
        mrows: List[List[Any]] = [[] for _ in range(R)]
        active = np.zeros((k, R), bool)
        for t in range(k):
            act = [i for i, l in enumerate(lanes) if l["gen"] < l["ngen"]]
            if not act:
                break
            active[t, act] = True
            out = self._generation([lanes[i] for i in act])
            for i, (rec, ms) in zip(act, out):
                records[i].append(rec)
                if ms is not None:
                    mrows[i].append(ms)
                lanes[i]["gen"] += 1
        return batch, {"records": records, "mrows": mrows,
                       "active": active}

    # -------------------------------------------------- one generation ----

    def _generation(self, lanes: List[Dict[str, Any]]) -> List[tuple]:
        """One generation of every lane in ``lanes`` (all active); returns
        each lane's ``(record, meter state or None)`` and updates its
        carry in place."""
        if self.family == "ea_generate_update":
            return self._gu_generation(lanes)
        batched = self._batched_mode(lanes[0]["carry"]["pop"])
        if batched is None:
            return [self._solo_generation(lane) for lane in lanes]
        if self.family == "ea_simple":
            return self._simple_generation(lanes, *batched)
        return self._or_generation(lanes, *batched)

    def _batched_mode(self, pop: Population):
        """``(mode, variation plan, tournament size)`` of the batched pass
        for this bucket, or None when lanes step through the solo step.
        The first call journals the dispatch."""
        if self.fused in (False, None, "off"):
            return None
        vplan = _variation.resolve_plan(self.toolbox)
        leaf = _variation.single_genome_leaf(pop.genomes)
        tournsize = None
        if self.family == "ea_simple":
            from deap_tpu_torch.parallel.island import _tournsize
            tournsize = _tournsize(self.toolbox)
            if tournsize is None:
                return None
        if vplan is None or leaf is None:
            if self.fused in ("plain", "kernel"):
                raise ValueError(f"fused={self.fused!r} requested but the "
                                 "configuration is not fused-capable")
            return None
        mode = self.fused
        if mode in ("auto", True):
            mode = ("kernel" if leaf.device.type == "cuda"
                    and leaf.dtype in KERNEL_DTYPES else "plain")
        op = "var_and" if self.family == "ea_simple" else "var_or"
        algos._resolve_fused(mode, self.toolbox, leaf, op,
                             journal=not self._journaled)
        self._journaled = True
        return mode, vplan, tournsize

    def _tel_args(self, lane: Dict[str, Any]) -> tuple:
        """The meter state and generation a telemetry step takes last."""
        if self.tel is None:
            return ()
        return lane["carry"]["mstate"], lane["gen"] + self.gen_offset

    def _store(self, lane: Dict[str, Any], out: tuple) -> tuple:
        """A solo step's (or its ``told``'s) return into the lane's
        carry; returns ``(record, meter state or None)``."""
        pop, hof, rec = out[:3]
        lane["carry"] = {"pop": pop, "hof": hof}
        ms = None
        if self.tel is not None:
            ms = lane["carry"]["mstate"] = out[3]
        return rec, ms

    def _solo_generation(self, lane: Dict[str, Any]) -> tuple:
        step = self._solo_step(lane["hyper"])
        c = lane["carry"]
        return self._store(lane, step(lane["generator"], c["pop"], c["hof"],
                                      *self._tel_args(lane)))

    def _simple_generation(self, lanes, mode, vplan, tournsize) -> list:
        pops = [l["carry"]["pop"] for l in lanes]
        n = pops[0].size
        g = _variation.single_genome_leaf(pops[0].genomes)
        L, dtype = g.shape[1], g.dtype
        R = len(lanes)
        draws = [simple_lane_draws(l["generator"], n, L, tournsize,
                                   l["hyper"]["cxpb"], l["hyper"]["mutpb"],
                                   vplan, dtype) for l in lanes]
        flat = concat(pops)
        dev = flat.device
        offset = torch.arange(R, device=dev) * n
        aspirants = torch.stack([a for a, _ in draws]) + offset[:, None,
                                                                None]
        idx = _sel._tournament_winners(flat.wvalues,
                                       aspirants.reshape(R * n, -1))
        masks = _cat_masks([m for _, m in draws])
        pos = (_variation.pair_partner_positions(n, dev).long()[None, :]
               + offset[:, None]).reshape(-1)
        off = algos.var_and_apply(flat, masks, vplan.mut_kind, mode,
                                  sel_idx=idx, partner=idx[pos])
        nevals = (~off.valid).reshape(R, n).sum(1)
        offs = evaluate_lanes(off, self.toolbox.evaluate, n)
        local = idx.reshape(R, n) - offset[:, None]
        return [self._store(lane, self._solo_step(lane["hyper"]).told(
                    offs[r], lane["carry"]["hof"], nevals[r],
                    local[r].clone(), *self._tel_args(lane)))
                for r, lane in enumerate(lanes)]

    def _or_generation(self, lanes, mode, vplan, _tournsize) -> list:
        pops = [l["carry"]["pop"] for l in lanes]
        N = pops[0].size
        lam = int(self.lambda_)
        g = _variation.single_genome_leaf(pops[0].genomes)
        L, dtype = g.shape[1], g.dtype
        R = len(lanes)
        draws = [or_lane_draws(l["generator"], N, lam, L,
                               l["hyper"]["cxpb"], l["hyper"]["mutpb"],
                               vplan, dtype) for l in lanes]
        shifted = []
        for r, m in enumerate(draws):
            # parents and partners index the lane's rows of the stack
            shifted.append((m[0] + r * N, m[1] + r * N) + tuple(m[2:]))
        masks = _cat_masks(shifted)
        off = algos.var_or_apply(concat(pops), masks, vplan.mut_kind, mode)
        nevals = (~off.valid).reshape(R, lam).sum(1)
        offs = evaluate_lanes(off, self.toolbox.evaluate, lam)
        # the survivors' selection draws from the lane's generator after
        # its variation draws, as in the solo step
        return [self._store(lane, self._solo_step(lane["hyper"]).told(
                    lane["generator"], pops[r], offs[r],
                    lane["carry"]["hof"], nevals[r], *self._tel_args(lane)))
                for r, lane in enumerate(lanes)]

    def _gu_generation(self, lanes) -> list:
        """The ask-tell generation: generate, evaluate and update lane by
        lane (each lane's products in its own shape); a ``'jacobi'``
        CMA-ES bucket decomposes every lane's matrix in one J1 launch."""
        tb = self.toolbox
        step = self._solo_step({})
        genomes = [tb.generate(l["generator"], l["carry"]["state"])
                   for l in lanes]
        values = [algos._as2d(tb.evaluate(g)) for g in genomes]
        strat = self.strategy
        if strat is not None and getattr(strat, "eigh_impl", None) == \
                "jacobi":
            moved = [strat.update_moments(l["carry"]["state"], g, v)
                     for l, g, v in zip(lanes, genomes, values)]
            need = [i for i, m in enumerate(moved) if strat.needs_eigen(m)]
            if need:
                evals, B = strat._eigh(torch.stack([moved[i].C
                                                    for i in need]))
                for j, i in enumerate(need):
                    # copies: each lane's state owns its own storage
                    moved[i] = strat.update_eigen(moved[i], evals[j].clone(),
                                                  B[j].clone())
            new_states = moved
        else:
            new_states = [tb.update(l["carry"]["state"], g, v)
                          for l, g, v in zip(lanes, genomes, values)]
        out = []
        for lane, st, g, v in zip(lanes, new_states, genomes, values):
            c = lane["carry"]
            if self.tel is None:
                st, hof, rec = step.told(st, c["hof"], g, v)
                lane["carry"] = {"state": st, "hof": hof}
                out.append((rec, None))
            else:
                st, hof, rec, ms = step.told(st, c["hof"], g, v,
                                             c["mstate"], lane["gen"])
                lane["carry"] = {"state": st, "hof": hof, "mstate": ms}
                out.append((rec, ms))
        return out

    # ---------------------------------------------------- result decode ----

    @staticmethod
    def _lane_rows(segs: Sequence[Dict[str, Any]], i: int, part: str):
        rows = []
        for seg in segs:
            rows.extend(seg[part][i])
        return rows or None

    def lane_records(self, segs: Sequence[Dict[str, Any]], i: int):
        """Lane ``i``'s records of the generations it ran in ``segs``
        (a list, as the solo loop collects them), or None."""
        return self._lane_rows(segs, i, "records")

    def lane_meter_rows(self, segs: Sequence[Dict[str, Any]], i: int,
                        lane: Optional[Dict[str, Any]] = None,
                        gen_start: int = 0) -> List[dict]:
        """Lane ``i``'s decoded meter rows (telemetry engines only): the
        gen-0 row (from the lane's ``mstate0``, when given and
        ``gen_start == 0``) and one a generation it ran in ``segs`` — the
        solo run's journal rows. ``gen_start`` is the lane's
        completed-generation count before ``segs``."""
        if self.tel is None:
            return []
        rows: List[dict] = []
        if gen_start == 0 and lane is not None \
                and lane.get("mstate0") is not None:
            rows.append({"gen": 0, **self.tel.meter.row(lane["mstate0"])})
        states = self._lane_rows(segs, i, "mrows")
        if states:
            for g, row in enumerate(self.tel.meter.rows(
                    self.tel.meter.stack(states))):
                rows.append({"gen": gen_start + g + self.gen_offset, **row})
        return rows

    @staticmethod
    def concat_records(chunks: Sequence[Any]):
        """Per-segment :meth:`lane_records` chunks joined along the
        generation axis (``None`` chunks skipped)."""
        out: List[Any] = []
        for c in chunks:
            if c:
                out.extend(c)
        return out or None

    def lane_result(self, lane: Dict[str, Any], records: Any):
        """A lane's solo-format result from its state and its records:
        ``(pop, logbook, hof)`` for the population families, ``(state,
        logbook, hof)`` for ask-tell — the solo loop's return."""
        carry = lane["carry"]
        records = list(records or [])
        if self.family == "ea_generate_update":
            return (carry["state"], algos._build_gu_logbook(records,
                                                            self.stats),
                    carry["hof"])
        return (carry["pop"], algos._build_logbook(lane["record0"], records,
                                                   self.stats),
                carry["hof"])


def multirun(family: str, toolbox, generators, inits, ngen, hyper=None, *,
             segment_len: Optional[int] = None, **engine_kwargs
             ) -> List[tuple]:
    """Run N independent jobs to completion through the run axis and
    return each job's solo-format result::

        results = multirun(
            "ea_simple", toolbox,
            generators=[make_generator(s) for s in range(32)],
            inits=[pop] * 32, ngen=100,
            hyper=[{"cxpb": c, "mutpb": 0.2} for c in cx_grid])

    ``ngen`` and ``hyper`` broadcast (a scalar / one dict applies to every
    run). The generators are read, never advanced. ``segment_len`` chunks
    the run (default one segment covering the largest ``ngen``)."""
    n = len(generators)
    if len(inits) != n:
        raise ValueError("len(inits) != len(generators)")
    ngens = [int(g) for g in (ngen if isinstance(ngen, (list, tuple))
                              else [ngen] * n)]
    hypers = (hyper if isinstance(hyper, (list, tuple)) else [hyper] * n)
    eng = MultiRunEngine(family, toolbox, **engine_kwargs)
    lanes = [eng.lane_init(g, p, k, h)
             for g, p, k, h in zip(generators, inits, ngens, hypers)]
    horizon = max(ngens)
    batch = eng.pack(lanes)
    k = int(segment_len) if segment_len else horizon
    segs = []
    while not eng.done(batch).all():
        batch, seg = eng.advance(batch, k)
        segs.append(seg)
    return [eng.lane_result(eng.unpack(batch, i), eng.lane_records(segs, i))
            for i in range(n)]
