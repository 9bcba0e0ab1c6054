"""Host-dispatch GP generation engine.

Port of :mod:`deap_tpu.gp.loop`: an eaSimple-shaped GP loop driven one
generation at a time from the host — tournament selection, adjacent-pair
one-point crossover at ``cxpb``, uniform subtree mutation at ``mutpb``
with a fresh genFull(mut_min, mut_max) donor, the Koza height limit with
keep-parent, and evaluation of the touched rows only, through the
concrete-genome batch interpreter (live-vocab masks, dedup, the grouped
evaluator and its kernel K9 on the card).

- **Invalid-only evaluation.** The touched/crossover/mutation index sets
  are compacted either on the device (``compaction='device'``: a
  prefix-sum pack into cycle-padded index arrays, ``np.resize`` pad
  semantics, and the host reads three counts) or on the host
  (``'host'``: the flags cross to the host for ``np.nonzero``). Both give
  the same arrays. Sizes are rounded up on the JAX package's lattice and
  padded by cycling, so a row can appear more than once; every random
  draw of a crossover or mutation belongs to the pair or row id, not to
  the padded position, so duplicates compute the same offspring.
- **Algebraic height limits.** Per-tree depth arrays are carried through
  every splice (:func:`_splice_depths`): a splice re-depths only the
  donor segment, so a child's height is a masked max, no tree walk.

Randomness: one ``torch.Generator`` drives the run. Each generation's
draws go through a :class:`GpDraws` (aspirants, flags, cut points per
pair id, mutation points and donors per row id); the tests hand
``advance`` the JAX package's draws in one instead.

Telemetry (``telemetry=``, ``probes=``): the loop has a host in it, so
one decoded ``meter`` row a generation lands in the journal as it
happens, probes get the selection indices and the interpreter's exact
dedup count (``host_clone_rate``), and a
:class:`~deap_tpu_torch.telemetry.probes.HealthMonitor` with
``early_stop`` stops the run (``result["stopped_at"]``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch.profiler import record_function

from deap_tpu_torch import tuning
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import Population
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device
from deap_tpu_torch.gp.interpreter import (DEFAULT_CHUNK, MODES, _dedup_rows,
                                           _round_size, compact_indices,
                                           make_batch_interpreter)
from deap_tpu_torch.gp.pset import PrimitiveSet
from deap_tpu_torch.gp.tree import (_f32, _splice, draw_cut_points,
                                    make_generator, prefix_depths,
                                    randint_below, subtree_end, tree_where)
from deap_tpu_torch.ops.selection import (_tournament_winners,
                                          tournament_aspirants)
from deap_tpu_torch.support.profiling import span
from deap_tpu_torch.telemetry import costs
from deap_tpu_torch.telemetry.journal import broadcast
from deap_tpu_torch.telemetry.meter import mean_f32


def _rows(d: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``d[t, i[t]]`` for every row ``t``."""
    return d.gather(1, i.to(torch.int64)[:, None])[:, 0]


def _splice_depths(dep, i, e, donor_dep, di, donor_len, shift, ok):
    """Depth arrays of ``_splice(g, i, e, donor, di, donor_len)``, per
    row: head and tail keep their depths (a splice cannot re-depth
    anything outside the replaced subtree), the donor segment shifts by
    ``shift = dep[i] − donor_dep[di]``. ``ok`` mirrors _splice's overflow
    keep-parent."""
    n, L = dep.shape
    k = torch.arange(L, device=dep.device)
    i, e = i.to(torch.int64)[:, None], e.to(torch.int64)[:, None]
    di = di.to(torch.int64)[:, None]
    donor_len = donor_len.to(torch.int64)[:, None]
    seg = e - i
    in_head = k < i
    in_donor = (k >= i) & (k < i + donor_len)
    src_tail = (k - donor_len + seg).clamp(0, L - 1)
    src_donor = (di + k - i).clamp(0, min(L, donor_dep.shape[1]) - 1)
    mixed = torch.where(in_head, dep, torch.where(
        in_donor, donor_dep.gather(1, src_donor) + shift[:, None],
        dep.gather(1, src_tail)))
    return torch.where(ok[:, None], mixed, dep)


def _height(dep, length):
    live = torch.arange(dep.shape[1], device=dep.device) < length[:, None]
    return torch.where(live, dep, 0).amax(1)


def _best_index(fit: torch.Tensor) -> int:
    """``jnp.argmax``'s pick: the first NaN if there is one, else the first
    maximum."""
    nan = torch.isnan(fit)
    return int(torch.where(nan.any(), nan.to(torch.uint8).argmax(),
                           fit.argmax()))


def _take(genomes, idx):
    return {k: v[idx] for k, v in genomes.items()}


def _put(genomes, idx, values):
    for k, v in genomes.items():
        v[idx] = values[k]


# ------------------------------------------------------- flag compaction ----

def draw_flags(generator: torch.Generator, n: int, cxpb: float,
               mutpb: float):
    """var_and's flags: ``(do_cx bool[n // 2], do_mut bool[n])``."""
    dev = generator.device
    do_cx = torch.rand(n // 2, generator=generator, device=dev) < _f32(cxpb)
    do_mut = torch.rand(n, generator=generator, device=dev) < _f32(mutpb)
    return do_cx, do_mut


def compact_flags(do_cx: torch.Tensor, do_mut: torch.Tensor, n: int):
    """The device half of the variation plane: the flags compacted into
    cycle-padded index arrays (:func:`compact_indices`) — ``(cx_idx
    [max(n // 2, 1)], mut_idx [n], touched_idx [n], counts int32[3])``."""
    cx_idx, n_cx = compact_indices(do_cx, max(n // 2, 1))
    mut_idx, n_mut = compact_indices(do_mut, n)
    touched = do_mut.clone()
    touched[:2 * (n // 2)] |= do_cx.repeat_interleave(2)
    t_idx, n_t = compact_indices(touched, n)
    return cx_idx, mut_idx, t_idx, torch.stack([n_cx, n_mut, n_t])


def make_flag_compactor(cxpb: float, mutpb: float) -> Callable:
    """``flags_compact(generator, n) -> (cx_idx, mut_idx, touched_idx,
    counts)``: draw the generation's flags and compact them on the
    generator's device, so the host reads back only the three counts."""

    def flags_compact(generator: torch.Generator, n: int):
        return compact_flags(*draw_flags(generator, n, cxpb, mutpb), n)

    return flags_compact


def make_compaction_pipelines(cxpb: float, mutpb: float):
    """The two compaction pipelines alone, each ``(generator, n) ->
    ((cx_idx, mut_idx, touched_idx), (n_cx, n_mut, n_t))`` with the index
    arrays cut at their lattice sizes; both give the same values for the
    same generator state.

    - ``host_fn``: the flags cross to the host for ``np.nonzero`` /
      ``np.resize`` and the index arrays go back.
    - ``device_fn``: :func:`make_flag_compactor`, then a 12-byte count
      fetch and slices of the device arrays.
    """
    flags_compact = make_flag_compactor(cxpb, mutpb)

    def lattice(count: int, cap: int) -> int:
        return min(_round_size(max(count, 1)), cap)

    def host_fn(generator: torch.Generator, n: int):
        do_cx, do_mut = (f.cpu().numpy() for f in
                         draw_flags(generator, n, cxpb, mutpb))
        pidx, midx = np.nonzero(do_cx)[0], np.nonzero(do_mut)[0]
        touched = np.zeros(n, bool)
        touched[pidx * 2] = True
        touched[pidx * 2 + 1] = True
        touched[midx] = True
        tidx = np.nonzero(touched)[0]
        out = []
        for idx, cap in ((pidx, max(n // 2, 1)), (midx, n), (tidx, n)):
            P = lattice(len(idx), cap)
            padded = np.resize(idx, P) if len(idx) else np.zeros(P)
            out.append(torch.from_numpy(padded.astype(np.int32)).to(
                generator.device))
        return tuple(out), (len(pidx), len(midx), len(tidx))

    def device_fn(generator: torch.Generator, n: int):
        cx_idx, mut_idx, t_idx, counts = flags_compact(generator, n)
        n_cx, n_mut, n_t = counts.tolist()
        out = tuple(idx[:lattice(c, cap)] for idx, c, cap in (
            (cx_idx, n_cx, max(n // 2, 1)), (mut_idx, n_mut, n),
            (t_idx, n_t, n)))
        return out, (n_cx, n_mut, n_t)

    return host_fn, device_fn


def resolve_compaction(mode: str, device: torch.device) -> str:
    """``'auto'`` → ``'host'`` on the CPU (there the flags are already on
    the host), ``'device'`` on the card (the flags stay there and three
    counts cross). Both give the same results.

    The static split is the default rung of the dispatch tuner's ladder
    (:func:`deap_tpu_torch.tuning.resolve`), which is read from the env
    (``DEAP_TPU_TORCH_TUNE_COMPACTION=host|device``) and the cache alone:
    no probe stands in for a generation's variation, so a winner is
    recorded out of band (:meth:`~deap_tpu_torch.tuning.DispatchTuner.
    record`) from generations timed both ways."""
    if mode == "auto":
        device = torch.device(device)
        static = "host" if device.type == "cpu" else "device"
        return tuning.resolve("compaction", bucket=(), default=static,
                              candidates={"host": None, "device": None},
                              check="bitwise", program="gp_loop",
                              device=device)
    if mode not in ("device", "host"):
        raise ValueError(f"unknown compaction mode {mode!r}")
    return mode


# ------------------------------------------------------------ step parts ----

class GpStepParts:
    """The batched variation/selection machinery of the GP loop, each a
    draw-taking core:

    - ``pair_cx(g1, d1, g2, d2, i1, i2)`` — one-point crossover of pairs
      at cut points ``i1``/``i2``, with carried depth arrays and the Koza
      keep-parent height limit;
    - ``one_mut(g, d, i, donor)`` — uniform subtree mutation at points
      ``i`` with donor trees, same depth carry and limit;
    - ``select_idx(fit, aspirants)`` — tournament winners;
    - ``depths(g)`` — ``prefix_depths`` recomputed;
    - ``expr(generator, n)`` — the mutation donors' generator.
    """

    def __init__(self, pair_cx, one_mut, select_idx, depths, expr,
                 height_limit, tournsize):
        self.pair_cx = pair_cx
        self.one_mut = one_mut
        self.select_idx = select_idx
        self.depths = depths
        self.expr = expr
        self.height_limit = height_limit
        self.tournsize = tournsize


def make_gp_step_parts(pset: PrimitiveSet, max_len: int, *,
                       tournsize: int = 3, height_limit: int = 17,
                       mut_min: int = 0, mut_max: int = 2,
                       mut_width: Optional[int] = None) -> GpStepParts:
    """Build the :class:`GpStepParts` of one configuration."""
    mut_width = mut_width or min(max_len, 32)
    expr = make_generator(pset, mut_width, mut_min, mut_max, "full")
    ML = max_len

    def arity_on(g):
        return pset.arity_table(g["nodes"].device)

    def pair_cx(g1, d1, g2, d2, i1, i2):
        arity = arity_on(g1)
        len1, len2 = g1["length"], g2["length"]
        ok = (len1 >= 2) & (len2 >= 2)
        e1 = subtree_end(g1["nodes"], arity, i1)
        e2 = subtree_end(g2["nodes"], arity, i2)
        c1 = _splice(g1, i1, e1, g2["nodes"], g2["consts"], i2, e2 - i2)
        c2 = _splice(g2, i2, e2, g1["nodes"], g1["consts"], i1, e1 - i1)
        # _splice keeps the parent on overflow; mirror its predicate so
        # the depth arrays revert in lockstep
        ok1 = ok & (len1 - (e1 - i1) + (e2 - i2) <= ML)
        ok2 = ok & (len2 - (e2 - i2) + (e1 - i1) <= ML)
        dd1 = _splice_depths(d1, i1, e1, d2, i2, e2 - i2,
                             _rows(d1, i1) - _rows(d2, i2), ok1)
        dd2 = _splice_depths(d2, i2, e2, d1, i1, e1 - i1,
                             _rows(d2, i2) - _rows(d1, i1), ok2)
        bad1 = ~ok | (_height(dd1, c1["length"]) > height_limit)
        bad2 = ~ok | (_height(dd2, c2["length"]) > height_limit)
        return (tree_where(bad1, g1, c1), torch.where(bad1[:, None], d1, dd1),
                tree_where(bad2, g2, c2), torch.where(bad2[:, None], d2, dd2))

    def one_mut(g, d, i, donor):
        arity = arity_on(g)
        e = subtree_end(g["nodes"], arity, i)
        new_dep = prefix_depths(donor["nodes"], donor["length"], arity)
        zero = torch.zeros_like(e)
        c = _splice(g, i, e, donor["nodes"], donor["consts"], zero,
                    donor["length"])
        ok = g["length"] - (e - i.to(torch.int64)) + donor["length"] <= ML
        dd = _splice_depths(d, i, e, new_dep, zero, donor["length"],
                            _rows(d, i), ok)
        bad = _height(dd, c["length"]) > height_limit
        return tree_where(bad, g, c), torch.where(bad[:, None], d, dd)

    def select_idx(fit, aspirants):
        return _tournament_winners(fit[:, None], aspirants)

    def depths(g):
        return prefix_depths(g["nodes"], g["length"], arity_on(g))

    return GpStepParts(pair_cx, one_mut, select_idx, depths, expr,
                       height_limit, tournsize)


class GpDraws:
    """The random draws of one GP generation, made from ``generator`` in
    the order the loop asks for them. Cut points, mutation points and
    donors are drawn for every pair or row id, and the loop picks the ids
    it needs, so padded duplicates get the same draws."""

    def __init__(self, generator: torch.Generator, parts: GpStepParts,
                 cxpb: float, mutpb: float):
        self.generator, self.parts = generator, parts
        self.cxpb, self.mutpb = cxpb, mutpb

    def aspirants(self, n: int) -> torch.Tensor:
        """``int64[n, tournsize]``: the n tournaments' aspirants."""
        return tournament_aspirants(self.generator, n, n,
                                    self.parts.tournsize)

    def flags(self, n: int):
        """``(do_cx bool[n // 2], do_mut bool[n])``."""
        return draw_flags(self.generator, n, self.cxpb, self.mutpb)

    def cut_points(self, len_even: torch.Tensor, len_odd: torch.Tensor):
        """Cut points of every pair's two trees, given their lengths."""
        return (draw_cut_points(self.generator, len_even),
                draw_cut_points(self.generator, len_odd))

    def mut_points(self, length: torch.Tensor) -> torch.Tensor:
        """A mutation point of every row, uniform in ``[0, len)``."""
        return randint_below(self.generator,
                             length.to(torch.int64).clamp_min(1))

    def donors(self, n: int) -> dict:
        """A donor tree of every row."""
        return self.parts.expr(self.generator, n)


# ------------------------------------------------------------------ loop ----

def _check_not_ported(plan) -> None:
    if plan is not None:
        raise NotImplementedError(
            "plan= (sharding) is not ported yet (ROADMAP A12)")


def make_gp_loop(pset: PrimitiveSet, max_len: int, evaluate: Callable, *,
                 cxpb: float, mutpb: float, tournsize: int = 3,
                 height_limit: int = 17, mut_min: int = 0, mut_max: int = 2,
                 mut_width: Optional[int] = None, compaction: str = "auto",
                 device: DeviceLike = None, telemetry=None, probes=(),
                 plan=None) -> Callable:
    """Build ``run(generator, genomes, ngen) -> result`` — the
    host-dispatch eaSimple-shaped GP loop on ``device`` (the card unless
    ``device='cpu'``).

    ``evaluate(genomes) -> f32[n]`` is the maximisation fitness, called
    with the touched sub-population each generation (pair it with a
    :func:`make_batch_interpreter` evaluator). ``compaction``: ``'auto'``
    (``'host'`` on the CPU, ``'device'`` on the card, or the dispatch
    tuner's pick, :func:`resolve_compaction`), ``'device'`` or ``'host'``
    (module docstring). The result dict holds the final
    population and depth arrays, fitness, the best individual ever seen
    and ``nevals`` per generation.

    ``run.init_state(genomes, ngen)``, ``run.advance(generator, state,
    draws=None)`` and ``run.finalize(state, ngen)`` drive it a
    generation at a time; ``draws`` replaces the generator's draws of
    that generation (a :class:`GpDraws`-shaped object).

    ``telemetry``/``probes`` (module docstring): a ``meter`` row each
    generation as it happens; telemetry changes no computed result and
    draws nothing.
    """
    _check_not_ported(plan)
    tel = telemetry
    if probes and tel is None:
        raise ValueError("probes= requires telemetry= (a RunTelemetry):"
                         " probe state rides the telemetry Meter")
    dev = resolve_device(device)
    parts = make_gp_step_parts(
        pset, max_len, tournsize=tournsize, height_limit=height_limit,
        mut_min=mut_min, mut_max=mut_max, mut_width=mut_width)
    compaction = resolve_compaction(compaction, dev)

    def select(draws, genomes, depths, fit):
        idx = parts.select_idx(fit, draws.aspirants(fit.shape[0]))
        return _take(genomes, idx), depths[idx], fit[idx], idx

    def cx_apply(draws, genomes, depths, pp):
        """Cross the pairs ``pp`` (padded pair ids) in place. Cut points
        are drawn per pair id, from the lengths at this point."""
        n2 = 2 * (genomes["length"].shape[0] // 2)
        i1, i2 = draws.cut_points(genomes["length"][0:n2:2],
                                  genomes["length"][1:n2:2])
        pp = pp.to(torch.int64)
        rows_e, rows_o = pp * 2, pp * 2 + 1
        c1, dd1, c2, dd2 = parts.pair_cx(
            _take(genomes, rows_e), depths[rows_e], _take(genomes, rows_o),
            depths[rows_o], i1[pp], i2[pp])
        _put(genomes, rows_e, c1)
        _put(genomes, rows_o, c2)
        depths[rows_e] = dd1
        depths[rows_o] = dd2

    def mut_apply(draws, genomes, depths, mp):
        """Mutate the rows ``mp`` (padded row ids) in place; points and
        donors per row id."""
        points = draws.mut_points(genomes["length"])
        donors = draws.donors(genomes["length"].shape[0])
        mp = mp.to(torch.int64)
        m_g, m_d = parts.one_mut(_take(genomes, mp), depths[mp], points[mp],
                                 _take(donors, mp))
        _put(genomes, mp, m_g)
        depths[mp] = m_d

    def vary_host(draws, genomes, depths, n):
        """Host-compacted var_and: the flags cross to the host, which runs
        ``np.nonzero``/``np.resize`` and sends the padded indices back."""
        do_cx, do_mut = draws.flags(n)
        with span("gp_loop/host_compaction_fetch"):
            do_cx, do_mut = do_cx.cpu().numpy(), do_mut.cpu().numpy()
        pidx, midx = np.nonzero(do_cx)[0], np.nonzero(do_mut)[0]
        if len(pidx):
            pp = np.resize(pidx, min(_round_size(len(pidx)),
                                     max(n // 2, 1)))
            cx_apply(draws, genomes, depths, torch.from_numpy(pp).to(dev))
        if len(midx):
            mp = np.resize(midx, min(_round_size(len(midx)), n))
            mut_apply(draws, genomes, depths, torch.from_numpy(mp).to(dev))
        touched = np.zeros(n, bool)
        touched[pidx * 2] = True
        touched[pidx * 2 + 1] = True
        touched[midx] = True
        tidx = np.nonzero(touched)[0]
        return tidx, len(tidx)

    def vary_device(draws, genomes, depths, n):
        """Device-compacted var_and: the flags are compacted where they
        were drawn and the host reads back the three counts."""
        cx_idx, mut_idx, t_idx, counts = compact_flags(*draws.flags(n), n)
        with span("gp_loop/compaction_count_fetch"):
            n_cx, n_mut, n_t = counts.tolist()
        if n_cx:
            cx_apply(draws, genomes, depths,
                     cx_idx[:min(_round_size(n_cx), max(n // 2, 1))])
        if n_mut:
            mut_apply(draws, genomes, depths,
                      mut_idx[:min(_round_size(n_mut), n)])
        return t_idx, n_t

    # the program observatory profiles it under the compaction knob's
    # program label
    vary = costs.instrument(
        vary_device if compaction == "device" else vary_host, "gp_loop",
        signature=lambda draws, genomes, depths, n: (
            costs.signature_of(genomes), n))

    if tel is not None:
        from deap_tpu_torch.telemetry.probes import TreeDiversityProbe
        # the exact interpreter-style dedup costs an O(nL) host pass:
        # only pay it for a probe that publishes it
        host_dedup = any(isinstance(p, TreeDiversityProbe)
                         for p in tuple(probes) + (tel.probe,)
                         if p is not None)

    def _measure(mstate, ne, genomes, fit, gen, sel_idx=None):
        """One generation's instrumentation, journaled at once: the
        built-ins, then the probes with the exact dedup count."""
        n = fit.shape[0]
        m = tel.meter
        mstate = m.inc(mstate, "nevals", ne)
        mstate = m.set(mstate, "best", fit.max())
        mstate = m.set(mstate, "mean", mean_f32(fit))
        mstate = m.set(mstate, "evaluated_frac", ne / n)
        clone = None
        if host_dedup:
            first, _ = _dedup_rows(genomes["nodes"].cpu().numpy(),
                                   genomes["consts"].cpu().numpy(),
                                   genomes["length"].cpu().numpy())
            clone = 1.0 - len(first) / n
        pv = Population(genomes=genomes, fitness=fit[:, None],
                        valid=torch.ones(n, dtype=torch.bool,
                                         device=fit.device),
                        spec=FitnessSpec((1.0,)))
        mstate = tel.apply_probe(
            mstate, pop=pv, gen=gen, sel_idx=sel_idx, sel_pool=n,
            parent_idx=sel_idx, host_clone_rate=clone)
        tel.record_row(mstate, gen)
        return mstate

    def begin_telemetry(ngen: int, n: int) -> None:
        """Declare this loop's telemetry (the built-ins and the probes)
        and journal the run start. ``init_state`` calls it; a resumed
        run, whose gen 0 ran in an earlier process, calls it directly so
        the fresh Meter knows the metrics of the checkpointed state."""
        from deap_tpu_torch.algorithms import _tel_declare
        tel.begin_run("gp_loop", None, declare=_tel_declare, probes=probes,
                      ngen=ngen, n=n, cxpb=cxpb, mutpb=mutpb)

    def init_state(genomes, ngen: int) -> dict:
        for k, v in genomes.items():
            if v.device.type != dev.type:
                raise ValueError(f"genomes[{k!r}] lives on {v.device}, the "
                                 f"run on {dev}")
        n = genomes["length"].shape[0]
        # what the variation plane reads back a generation: three counts
        # (device) or both flag arrays (host, a byte a flag)
        broadcast("variation_dispatch", op="gp_loop", path=compaction, n=n,
                  host_fetch_bytes_per_gen=(
                      12 if compaction == "device" else n // 2 + n))
        depths = parts.depths(genomes)
        with record_function("gp/evaluate"):
            fit = evaluate(genomes)
        best_i = _best_index(fit)
        state = {"gen": 0, "genomes": genomes, "depths": depths, "fit": fit,
                 "nevals": [n], "stopped_at": None, "mstate": None,
                 "best_genome": _take(genomes, best_i),
                 "best_fitness": float(fit[best_i])}
        if tel is not None:
            begin_telemetry(ngen, n)
            state["mstate"] = _measure(tel.meter.init(device=dev), n,
                                       genomes, fit, 0)
        return state

    def advance(generator: Optional[torch.Generator], state: dict,
                draws=None) -> dict:
        """One generation, in place on ``state``."""
        if draws is None:
            check_generator(generator, dev)
            draws = GpDraws(generator, parts, cxpb, mutpb)
        n = state["fit"].shape[0]
        with record_function("gp/select"):
            genomes, depths, fit, sel_idx = select(
                draws, state["genomes"], state["depths"], state["fit"])
        with record_function("gp/vary"):
            t_idx, ne = vary(draws, genomes, depths, n)
        state["nevals"].append(ne)
        if ne:
            P = min(_round_size(ne), n)
            padded = (t_idx[:P] if compaction == "device"
                      else torch.from_numpy(np.resize(t_idx, P)).to(dev))
            padded = padded.to(torch.int64)
            with record_function("gp/evaluate"):
                w = evaluate(_take(genomes, padded))
            # cycled duplicates carry the same value
            fit[padded] = w
        # a NaN never compares greater: a NaN best is kept, never replaced,
        # as in the JAX package
        best_i = _best_index(fit)
        if float(fit[best_i]) > state["best_fitness"]:
            state["best_genome"] = _take(genomes, best_i)
            state["best_fitness"] = float(fit[best_i])
        gen = state["gen"] + 1
        state.update(gen=gen, genomes=genomes, depths=depths, fit=fit)
        if tel is not None:
            state["mstate"] = _measure(state["mstate"], ne, genomes, fit,
                                       gen, sel_idx)
            # the host is in the loop, so a tripwire can stop the run
            if tel.health is not None and tel.health.stop_requested:
                state["stopped_at"] = gen
        return state

    def finalize(state: dict, ngen: int) -> dict:
        if tel is not None:
            tel.end_run("gp_loop", ngen=ngen,
                        stopped_at=state["stopped_at"])
        return {"genomes": state["genomes"], "depths": state["depths"],
                "fitness": state["fit"],
                "best_genome": state["best_genome"],
                "best_fitness": state["best_fitness"],
                "nevals": state["nevals"],
                "stopped_at": state["stopped_at"]}

    def run(generator: torch.Generator, genomes, ngen: int):
        check_generator(generator, dev)
        state = init_state(genomes, ngen)
        while state["gen"] < ngen and state["stopped_at"] is None:
            advance(generator, state)
        return finalize(state, ngen)

    run.compaction = compaction
    run.begin_telemetry = begin_telemetry if tel is not None else None
    run.telemetry = tel
    run.init_state = init_state
    run.advance = advance
    run.finalize = finalize
    return run


def _gp_mode_probe_fns(pset: PrimitiveSet, max_len: int, X: torch.Tensor,
                       probe_pop: int):
    """Race the three batch-interpreter modes on a small seeded
    population over the actual training points ``X``. All modes are
    bit-identical, so the probe compares the prediction matrices bitwise
    before trusting a timing."""
    g = torch.Generator(device=X.device).manual_seed(0)
    genomes = make_generator(pset, max_len, 1, 2, "half_and_half")(
        g, probe_pop)

    def make(m):
        def fn():
            return make_batch_interpreter(pset, max_len, mode=m)(genomes, X)
        return fn

    return {m: make(m) for m in MODES}


def resolve_gp_mode(pset: PrimitiveSet, max_len: int, X, *,
                    default: str = "grouped",
                    probe_pop: int = 64) -> str:
    """``mode='auto'`` for the GP batch interpreter, resolved through the
    dispatch tuner's env / cache / probe / static ladder
    (:func:`deap_tpu_torch.tuning.resolve`) on ``X``'s device. This is
    the call site with a training set in hand, so it is where the probe
    runs; :func:`make_batch_interpreter` resolves the same knob
    cache-only."""
    X = torch.as_tensor(X, dtype=torch.float32)
    candidates = dict.fromkeys(MODES)
    if tuning.active_tuner() is not None and tuning.is_concrete(X):
        candidates = _gp_mode_probe_fns(pset, max_len, X, probe_pop)
    return tuning.resolve(
        "gp_mode", bucket=(tuning.shape_bucket(max_len),),
        default=default, candidates=candidates, check="bitwise",
        program="gp_interpreter", device=X.device)


def make_symbreg_loop(pset: PrimitiveSet, max_len: int, X, y, *,
                      cxpb: float = 0.5, mutpb: float = 0.1,
                      mode: str = "grouped", chunk: int = DEFAULT_CHUNK,
                      dedup: Optional[bool] = None,
                      points_tile: Optional[int] = None,
                      device: DeviceLike = None, **loop_kwargs) -> Callable:
    """The canonical symbolic-regression configuration of
    :func:`make_gp_loop`: negative-MSE fitness of ``X f32[points,
    n_args]`` against ``y f32[points]`` through the batch interpreter
    (``mode='grouped'`` with dedup by default, K9 on the card;
    ``mode='auto'`` probes scan/sweep/grouped through the dispatch tuner,
    :func:`resolve_gp_mode`, and keeps ``'grouped'`` with no tuner).
    ``run.interpreter`` is that interpreter."""
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32).to(dev)
    y = torch.as_tensor(y, dtype=torch.float32).to(dev)
    if mode == "auto":
        mode = resolve_gp_mode(pset, max_len, X, default="grouped")
    interp = make_batch_interpreter(pset, max_len, mode=mode, chunk=chunk,
                                    dedup=dedup, points_tile=points_tile)

    def evaluate(genomes):
        # fitness reduces on the unique rows; only the scalars expand
        preds, inv = interp.unique(genomes, X)
        vals = -((preds - y[None, :]) ** 2).mean(1)
        return vals if inv is None else vals[inv]

    run = make_gp_loop(pset, max_len, evaluate, cxpb=cxpb, mutpb=mutpb,
                       device=dev, **loop_kwargs)
    run.interpreter = interp
    return run
