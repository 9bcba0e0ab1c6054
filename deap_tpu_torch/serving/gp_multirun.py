"""The run axis for the two host-driven families: GP runs and island runs.

Port of :mod:`deap_tpu.serving.gp_multirun`. Both engines speak the
lane/batch/segment protocol of :class:`~deap_tpu_torch.serving.multirun.
MultiRunEngine`, so the scheduler serves them alike.

- :class:`GpMultiRunEngine` — N GP runs of one :class:`GpJobSpec`. Each
  lane runs the solo loop's first half of a generation
  (:func:`~deap_tpu_torch.gp.loop.make_gp_loop`'s ``run.vary_rows``:
  tournament selection, the flags, the compacted crossover and mutation,
  every draw from the lane's own generator through a
  :class:`~deap_tpu_torch.gp.loop.GpDraws` with its own ``cxpb``/
  ``mutpb``); the padded rows every lane must evaluate then go through
  **one evaluation** (in symbolic-regression mode one batch-interpreter
  call: one K9 launch on the card), and each lane finishes its generation
  (``run.finish``) with its share of the values. A tree's value does not
  depend on the trees beside it, so each lane equals its solo loop bit
  for bit.

  The JAX engine keeps a union opcode mask and replays a segment whose
  variation escaped it (its XLA programs are specialised by vocabulary).
  The port's grouped evaluator dispatches every opcode of the set with
  no mask (K9's grouped dispatch), so nothing is ever replayed; the
  ``gp_dispatch`` journal row keeps ``n_lanes``.
- :class:`IslandMultiRunEngine` — N island runs of one
  :class:`IslandJobSpec`. A generation of every lane's demes is one
  batched pass: each lane draws its demes' tournaments and masks
  (:func:`~deap_tpu_torch.parallel.island.island_draws`), and one
  :func:`~deap_tpu_torch.parallel.island.island_generation` runs over
  the lanes × demes stack (one K1 launch for all lanes; the evaluation
  as :func:`~deap_tpu_torch.serving.multirun.evaluate_lanes` takes it);
  migration and the meter run lane by lane through the solo step's own
  tail (``step.told``).

Correctness contract: per-lane bit identity with the solo drivers (the
GP loop's result dict; the island step's stacked demes and meter rows)
run from a generator in the lane's starting state.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from deap_tpu_torch import algorithms as algos
from deap_tpu_torch.core.population import Population, concat
from deap_tpu_torch.device import DeviceLike, resolve_device
from deap_tpu_torch.gp.loop import (GpDraws, _best_index, _take,
                                    make_gp_loop, make_symbreg_loop,
                                    measure_builtins)
from deap_tpu_torch.gp.pset import PrimitiveSet
from deap_tpu_torch.ops import variation as _variation
from deap_tpu_torch.ops.kernels import KERNEL_DTYPES
from deap_tpu_torch.parallel import island as _island
from deap_tpu_torch.parallel.migration import _deme_map
from deap_tpu_torch.serving.multirun import MultiRunEngine, evaluate_lanes
from deap_tpu_torch.telemetry import costs
from deap_tpu_torch.telemetry.journal import broadcast

__all__ = ["GpJobSpec", "GpMultiRunEngine", "IslandJobSpec",
           "IslandMultiRunEngine"]


@dataclasses.dataclass(frozen=True, eq=False)
class GpJobSpec:
    """Everything program-relevant about one GP serving bucket.

    Two evaluation modes:

    - **symbreg** (``evaluate=None``): negative-MSE fitness of each
      genome on ``(X, y)`` through the batch interpreter, as
      :func:`deap_tpu_torch.gp.loop.make_symbreg_loop` computes it;
    - **custom** (``evaluate`` given): ``evaluate(genomes) -> f32[rows]``
      over a batch of rows, which must be **row-independent** (each row's
      value may not depend on the other rows): the engine evaluates every
      lane's rows in one call, where the solo loop evaluates one run's.
    """

    pset: PrimitiveSet
    max_len: int
    X: Any = None
    y: Any = None
    tournsize: int = 3
    height_limit: int = 17
    mut_min: int = 0
    mut_max: int = 2
    mut_width: Optional[int] = None
    evaluate: Optional[Callable] = None
    name: str = "symbreg"

    def __post_init__(self):
        if self.evaluate is None and (self.X is None or self.y is None):
            raise ValueError("GpJobSpec needs X= and y= (symbreg mode) "
                             "or a custom evaluate=")

    def static_key(self) -> Tuple:
        """The shape/program-static tuple that joins the bucket key."""
        return (self.name, int(self.max_len), int(self.tournsize),
                int(self.height_limit), int(self.mut_min),
                int(self.mut_max),
                None if self.mut_width is None else int(self.mut_width),
                self.pset.n_ops, self.pset.vocab,
                self.evaluate is not None)

    def fingerprint(self) -> str:
        """Content digest over the primitive roster, the loop statics and
        the dataset — the GP counterpart of ``toolbox_fingerprint`` for
        :func:`deap_tpu_torch.serving.tenant.bucket_key`."""
        h = hashlib.sha1()
        for p in self.pset.primitives:
            h.update(f"{p.name}/{p.arity};".encode())
        h.update(repr((self.pset.n_args, self.pset.n_consts,
                       self.pset.has_erc, self.pset.vocab)
                      + self.static_key()).encode())
        if self.evaluate is not None:
            h.update(repr(getattr(self.evaluate, "__qualname__",
                                  repr(self.evaluate))).encode())
        if self.X is not None:
            for a in (self.X, self.y):
                a = a.detach().cpu() if isinstance(a, torch.Tensor) else a
                h.update(np.ascontiguousarray(
                    np.asarray(a, np.float32)).tobytes())
        return h.hexdigest()


@dataclasses.dataclass(frozen=True)
class IslandJobSpec:
    """One island serving bucket's topology — everything that shapes the
    epoch besides the toolbox (which rides the Job)."""

    n_islands: int
    island_size: int
    freq: int
    mig_k: int

    def static_key(self) -> Tuple:
        return (int(self.n_islands), int(self.island_size),
                int(self.freq), int(self.mig_k))


class _RunAxisEngine(MultiRunEngine):
    """Shared plumbing of the two engines: the lane protocol of
    :class:`MultiRunEngine` (``pack``/``unpack``/``done``/``gens`` and the
    segment-boundary decode helpers) with each engine's own generation."""

    hyper_names: Tuple[str, ...] = ("cxpb", "mutpb")

    def _init_common(self, family: str, toolbox, telemetry,
                     device: DeviceLike) -> None:
        self.family = family
        self.toolbox = toolbox
        self.mu = self.lambda_ = None
        self.stats = None
        self.tel = telemetry
        self.probes = ()
        self.halloffame_size = 0
        self.device = resolve_device(device)
        self._journaled = False
        if self.tel is not None and getattr(self.tel, "stream", False):
            raise ValueError(
                "multirun: telemetry stream=True is unsupported (per-lane "
                "live rows interleave); decode rows at segment boundaries "
                "instead")
        self._advance = costs.instrument(
            self._segment, label=f"serving/{family}/advance",
            signature=lambda batch, k: (k, len(batch["lanes"])))

    def _check_hyper(self, hyper) -> Dict[str, float]:
        hyper = dict(hyper or {})
        missing = [h for h in self.hyper_names if h not in hyper]
        if missing:
            raise ValueError(f"{self.family} lane needs hyper {missing}")
        extra = [h for h in hyper if h not in self.hyper_names]
        if extra:
            raise ValueError(f"{self.family} takes no hyper {extra}")
        return {h: float(hyper[h]) for h in self.hyper_names}

    def _new_lane(self, generator, ngen: int, hyper) -> Dict[str, Any]:
        ngen = int(ngen)
        if ngen < 1:
            raise ValueError("ngen must be >= 1")
        hyper = self._check_hyper(hyper)
        self._check_generator(generator)
        return {"gen": 0, "ngen": ngen, "rng": generator.get_state(),
                "hyper": hyper, "record0": None, "mstate0": None}


# ------------------------------------------------------------------- GP ----


class GpMultiRunEngine(_RunAxisEngine):
    """N GP runs of one :class:`GpJobSpec`, each lane bit for bit its solo
    loop (:func:`~deap_tpu_torch.gp.loop.make_symbreg_loop`, or
    :func:`~deap_tpu_torch.gp.loop.make_gp_loop` with the spec's
    ``evaluate``). Lifecycle as :class:`MultiRunEngine`'s; ``init`` is
    a lane's founder genomes ``{"nodes", "consts", "length"}``, and
    ``lane_result`` returns the solo loop's result dict (genomes, depths,
    fitness, best_genome, best_fitness, nevals, stopped_at).

    With ``telemetry`` each lane's meter carries the loop's built-ins
    (nevals, best, mean, evaluated_frac); GP lanes take no probes,
    statistics or hall of fame (the JAX engine's refusals)."""

    def __init__(self, spec: GpJobSpec, *, telemetry=None, probes=(),
                 stats=None, halloffame_size: int = 0,
                 device: DeviceLike = None):
        if probes:
            raise ValueError("GP batched lanes take no probes= (probe "
                             "context needs a Population; GP lanes carry "
                             "raw genome tensors)")
        if stats is not None or halloffame_size:
            raise ValueError("GP lanes carry their own best-individual "
                             "tracking; stats=/halloffame_size= do not "
                             "apply")
        self._init_common("gp", None, telemetry, device)
        self.spec = spec
        self.gen_offset = 1
        loop_kwargs = dict(tournsize=spec.tournsize,
                           height_limit=spec.height_limit,
                           mut_min=spec.mut_min, mut_max=spec.mut_max,
                           mut_width=spec.mut_width, device=self.device)
        if spec.evaluate is None:
            self.run = make_symbreg_loop(spec.pset, spec.max_len, spec.X,
                                         spec.y, cxpb=0.5, mutpb=0.1,
                                         **loop_kwargs)
        else:
            self.run = make_gp_loop(spec.pset, spec.max_len, spec.evaluate,
                                    cxpb=0.5, mutpb=0.1, **loop_kwargs)
        self._n: Optional[int] = None
        self._journaled_lanes: Any = None
        if self.tel is not None:
            self.tel.begin_run("multirun/gp", None,
                               declare=algos._tel_declare, serving=True)

    def _journal_dispatch(self, n_lanes: int) -> None:
        """``gp_dispatch`` with the batching dimension (once per lane
        count): no mask, since the port's evaluator dispatches every
        opcode."""
        if self._journaled_lanes == n_lanes:
            return
        self._journaled_lanes = n_lanes
        broadcast("gp_dispatch", mode="batched",
                  mask=[p.name for p in self.spec.pset.primitives],
                  mask_popcount=self.spec.pset.n_ops, n_lanes=n_lanes)

    def _learn_n(self, genomes) -> int:
        n = int(genomes["length"].shape[-1])
        if self._n is None:
            self._n = n
        elif n != self._n:
            raise ValueError(f"lane population size {n} != bucket size "
                             f"{self._n}")
        return n

    def _state0(self, genomes, fit) -> Dict[str, Any]:
        """The solo loop's ``init_state`` on evaluated founders."""
        n = int(fit.shape[0])
        best_i = _best_index(fit)
        state = {"gen": 0, "genomes": genomes,
                 "depths": self.run.parts.depths(genomes), "fit": fit,
                 "nevals": [n], "stopped_at": None, "mstate": None,
                 "best_genome": _take(genomes, best_i),
                 "best_fitness": float(fit[best_i])}
        if self.tel is not None:
            state["mstate"] = measure_builtins(
                self.tel.meter, self.tel.meter.init(device=self.device), n,
                fit)
        return state

    def _on_genomes(self, init) -> Dict[str, torch.Tensor]:
        genomes = {k: torch.as_tensor(v).to(self.device)
                   for k, v in init.items()}
        self._learn_n(genomes)
        return genomes

    def lane_init(self, generator: torch.Generator, init, ngen: int,
                  hyper: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Any]:
        """One lane: ``init`` is the founder genome batch; runs the solo
        loop's gen 0 (founder evaluation, the best) and snapshots the
        generator's state."""
        lane = self._new_lane(generator, ngen, hyper)
        genomes = self._on_genomes(init)
        fit = self.run.evaluate(genomes)
        lane["carry"] = self._state0(genomes, fit)
        lane["record0"] = {"nevals": int(fit.shape[0])}
        lane["mstate0"] = lane["carry"]["mstate"]
        return lane

    def pack_fresh(self, generators, inits, ngen: int,
                   hyper: Optional[Dict[str, Any]] = None, *,
                   n_lanes: Optional[int] = None,
                   horizon: Optional[int] = None) -> Dict[str, Any]:
        """Fresh same-``ngen`` lanes with every lane's founders evaluated
        in one call (one K9 launch on the card); each lane equals its
        :meth:`lane_init`."""
        generators, inits = list(generators), list(inits)
        if n_lanes is not None and len(generators) > int(n_lanes):
            raise ValueError("batch exceeds n_lanes")
        hyper = dict(hyper or {})
        lanes = [self._new_lane(g, ngen, {h: (v[r] if isinstance(
            v, (list, tuple)) else v) for h, v in hyper.items()})
            for r, g in enumerate(generators)]
        genomes = [self._on_genomes(p) for p in inits]
        n = self._n
        fit = self.run.evaluate({k: torch.cat([g[k] for g in genomes])
                                 for k in genomes[0]})
        for r, lane in enumerate(lanes):
            lane["carry"] = self._state0(genomes[r],
                                         fit[r * n:(r + 1) * n].clone())
            lane["record0"] = {"nevals": n}
            lane["mstate0"] = lane["carry"]["mstate"]
        return self.pack(lanes)

    def _on_pack_lane(self, lane: Dict[str, Any]) -> Dict[str, Any]:
        self._learn_n(lane["carry"]["genomes"])
        return lane

    def pack(self, lanes, n_lanes=None, horizon=None):
        batch = super().pack(lanes, n_lanes, horizon)
        self._journal_dispatch(len(lanes))
        return batch

    def _generation(self, lanes: List[Dict[str, Any]]) -> List[tuple]:
        run = self.run
        pend = []
        for lane in lanes:
            # the lane's gp state is updated in place by finish(): a copy,
            # so a lane unpacked earlier keeps its own
            lane["carry"] = dict(lane["carry"],
                                 nevals=list(lane["carry"]["nevals"]))
            draws = GpDraws(lane["generator"], run.parts,
                            lane["hyper"]["cxpb"], lane["hyper"]["mutpb"])
            pend.append(run.vary_rows(None, lane["carry"], draws))
        rows = [p["rows"] for p in pend if p["rows"] is not None]
        values: List[Optional[torch.Tensor]] = [None] * len(lanes)
        if rows:
            # one evaluation of every lane's touched rows
            w = run.evaluate({k: torch.cat([r[k] for r in rows])
                              for k in rows[0]})
            at = 0
            for i, p in enumerate(pend):
                if p["rows"] is None:
                    continue
                P = int(p["padded"].shape[0])
                values[i] = w[at:at + P]
                at += P
        out = []
        for lane, p, w_i in zip(lanes, pend, values):
            state = run.finish(lane["carry"], p, w_i)
            ms = None
            if self.tel is not None:
                ms = measure_builtins(self.tel.meter, state["mstate"],
                                      p["ne"], state["fit"])
                state["mstate"] = ms
            out.append(({"nevals": p["ne"]}, ms))
        return out

    def lane_result(self, lane: Dict[str, Any], records: Any):
        """The solo loop's result dict for the lane."""
        s = lane["carry"]
        return {"genomes": s["genomes"], "depths": s["depths"],
                "fitness": s["fit"], "best_genome": s["best_genome"],
                "best_fitness": s["best_fitness"],
                "nevals": list(s["nevals"]), "stopped_at": None}


# -------------------------------------------------------------- islands ----


class IslandMultiRunEngine(_RunAxisEngine):
    """N island runs of one :class:`IslandJobSpec`, each lane bit for bit
    the solo :func:`~deap_tpu_torch.parallel.make_island_step` driven
    epoch after epoch from the lane's generator. ``init`` is a lane's
    stacked demes (``[n_islands, island_size, ...]``, e.g. from
    :func:`~deap_tpu_torch.parallel.island_init`); ``ngen`` counts
    epochs; ``lane_result`` returns the final stacked population.

    The batched pass needs tournament selection and a fused-capable
    (mate, mutate) pair, as the solo step's; other toolboxes run the
    solo step lane by lane. With ``telemetry`` each lane's meter carries
    the step's counters and gauges (epochs, generations, migrants, best,
    mean); no probes."""

    def __init__(self, toolbox, spec: IslandJobSpec, *, telemetry=None,
                 probes=(), device: DeviceLike = None):
        if probes:
            raise ValueError("island batched lanes take no probes= "
                             "(per-lane probe rows are the Meter "
                             "built-ins)")
        self._init_common("island", toolbox, telemetry, device)
        self.spec = spec
        self.gen_offset = 0  # epoch rows are 0-indexed, no gen-0 row
        self._solo: Dict[tuple, Callable] = {}
        if self.tel is not None:
            self.tel.begin_run("multirun/island", toolbox, serving=True)
        # the epoch's tail (migration, instrumentation) takes no
        # hyperparameter; building the step declares its meter metrics
        # before any meter.init()
        self._told = _island.make_island_step(
            toolbox, 0.5, 0.2, spec.freq, spec.mig_k,
            telemetry=self.tel).told

    def lane_init(self, generator: torch.Generator, init, ngen: int,
                  hyper: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Any]:
        lane = self._new_lane(generator, ngen, hyper)
        if not isinstance(init, Population):
            raise TypeError("island lane init must be a stacked "
                            f"Population, got {type(init).__name__}")
        shape = tuple(init.valid.shape[:2])
        want = (self.spec.n_islands, self.spec.island_size)
        if shape != want:
            raise ValueError(f"island lane shape {shape} != bucket "
                             f"topology {want}")
        carry: Dict[str, Any] = {"pops": init.to(self.device)}
        if self.tel is not None:
            carry["mstate"] = self.tel.meter.init(device=self.device)
        lane["carry"] = carry
        return lane

    def pack_fresh(self, generators, inits, ngen: int,
                   hyper: Optional[Dict[str, Any]] = None, *,
                   n_lanes: Optional[int] = None,
                   horizon: Optional[int] = None) -> Dict[str, Any]:
        """Fresh same-``ngen`` island lanes: an island run's gen 0 has no
        protocol (founders are evaluated inside the first generation), so
        this is :meth:`lane_init` for each and one :meth:`pack`."""
        hyper = dict(hyper or {})
        lanes = [self.lane_init(g, p, ngen, {h: (v[r] if isinstance(
            v, (list, tuple)) else v) for h, v in hyper.items()})
            for r, (g, p) in enumerate(zip(generators, inits))]
        return self.pack(lanes, n_lanes=n_lanes)

    def _solo_step(self, hyper: Dict[str, float]) -> Callable:
        key = (hyper["cxpb"], hyper["mutpb"])
        step = self._solo.get(key)
        if step is None:
            step = _island.make_island_step(
                self.toolbox, hyper["cxpb"], hyper["mutpb"], self.spec.freq,
                self.spec.mig_k, telemetry=self.tel)
            self._solo[key] = step
        return step

    def _batched(self, pops: Population):
        tournsize = _island._tournsize(self.toolbox)
        vplan = _variation.resolve_plan(self.toolbox)
        leaf = _variation.single_genome_leaf(
            _island._flatten_demes(pops).genomes)
        if tournsize is None or vplan is None or leaf is None:
            return None
        mode = ("kernel" if leaf.device.type == "cuda"
                and leaf.dtype in KERNEL_DTYPES else "plain")
        algos._resolve_fused(mode, self.toolbox, leaf, "var_and",
                             journal=not self._journaled)
        self._journaled = True
        return mode, vplan, tournsize

    def _generation(self, lanes: List[Dict[str, Any]]) -> List[tuple]:
        spec = self.spec
        batched = self._batched(lanes[0]["carry"]["pops"])
        if batched is None:
            out = []
            for lane in lanes:
                step = self._solo_step(lane["hyper"])
                c = lane["carry"]
                if self.tel is None:
                    lane["carry"] = {"pops": step(lane["generator"],
                                                  c["pops"])}
                    out.append(({}, None))
                else:
                    pops, ms = step(lane["generator"], c["pops"],
                                    c["mstate"])
                    lane["carry"] = {"pops": pops, "mstate": ms}
                    out.append(({}, ms))
            return out
        mode, vplan, tournsize = batched
        m, S = spec.n_islands, spec.island_size
        pops = [l["carry"]["pops"] for l in lanes]
        g = _variation.single_genome_leaf(
            _island._flatten_demes(pops[0]).genomes)
        evaluate_rows = lambda off: concat(
            evaluate_lanes(off, self.toolbox.evaluate, m * S))
        for _ in range(spec.freq):
            draws = [_island.island_draws(
                l["generator"], m, S, g.shape[-1], tournsize,
                l["hyper"]["cxpb"], l["hyper"]["mutpb"], vplan, g.dtype)
                for l in lanes]
            stack = concat(pops)
            aspirants = torch.cat([a for a, _ in draws])
            masks = tuple(None if draws[0][1][j] is None else
                          torch.cat([d[1][j] for d in draws])
                          for j in range(len(draws[0][1])))
            out = _island.island_generation(stack, aspirants, masks,
                                            self.toolbox, vplan.mut_kind,
                                            mode, evaluate_rows)
            pops = [_deme_map(lambda a, r=r: a[r * m:(r + 1) * m].clone(),
                              out) for r in range(len(lanes))]
        res = []
        for lane, p in zip(lanes, pops):
            if self.tel is None:
                lane["carry"] = {"pops": self._told(lane["generator"], p)}
                res.append(({}, None))
                continue
            p, ms = self._told(lane["generator"], p,
                               lane["carry"]["mstate"])
            lane["carry"] = {"pops": p, "mstate": ms}
            res.append(({}, ms))
        return res

    def lane_result(self, lane: Dict[str, Any], records: Any):
        """The final stacked demes — what the solo epoch driver holds
        after its last epoch."""
        return lane["carry"]["pops"]
