"""Algorithms — the generational loops as Python loops over tensor steps.

Port of the ``ea_simple``, ``ea_mu_plus_lambda``, ``ea_mu_comma_lambda``
and ``ea_generate_update`` paths of :mod:`deap_tpu.algorithms`. An
``ea_simple`` generation is select → var_and → evaluate invalid →
archive/stats on the device; a (μ + λ) or (μ, λ) generation is var_or →
evaluate invalid → select μ from the parents and offspring, or from the
offspring alone. ``lax.scan`` becomes a loop over generations. The
toolbox convention, batched:

- ``toolbox.evaluate``: ``genomes -> values [n] | [n, nobj]``
- ``toolbox.mate``:     ``(generator, g1[m, L], g2[m, L]) -> (c1, c2)``
- ``toolbox.mutate``:   ``(generator, g[n, L]) -> g``
- ``toolbox.select``:   ``(generator, wvalues, k) -> int64[k]``

Variation deletes fitness through the population's ``valid`` mask; every
row is re-evaluated by the batched evaluate but only invalid rows are
written, and ``nevals`` counts exactly those.

:func:`ea_simple_packed` is the OneMax generation on bit-packed genomes
that the JAX package's ``bench.py`` races (``make_run_selgather``,
``make_run_packed``), as a user-facing loop.

:func:`ea_generate_update` is the ask-tell loop of the strategies
(:mod:`deap_tpu_torch.strategies`): ``toolbox.generate(generator, state)
-> genomes``, ``toolbox.update(state, genomes, values) -> state``.

Every loop takes ``telemetry=`` (a :class:`~deap_tpu_torch.telemetry.
RunTelemetry`) and ``probes=``: a Meter state joins each generation,
stays on the device, and is journaled, one ``meter`` row a generation,
when the loop ends; results are bit-identical with or without it.

Every loop and step factory takes ``plan=`` (a
:class:`~deap_tpu_torch.parallel.ShardingPlan`): the loop places its
state on the plan, each rank varies and evaluates its block of rows
(the draws made whole on every rank and sliced) and the rows are
gathered back, so selection, statistics, the hall of fame and a
strategy's update read the whole population on every rank. The results
are the same bits on any number of ranks.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from deap_tpu_torch import tuning
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import Population, concat, gather
from deap_tpu_torch.device import DeviceLike, check_generator, resolve_device
from deap_tpu_torch.ops import packed as _packed
from deap_tpu_torch.ops import variation as _variation
from deap_tpu_torch.ops.kernels import (
    KERNEL_DTYPES,
    _resolve_prng,
    fused_variation,
    philox_key,
)
from deap_tpu_torch.ops.selection import (
    sel_tournament_binned,
    sel_tournament_sorted,
)
from deap_tpu_torch.support.hof import HallOfFame, hof_init, hof_update
from deap_tpu_torch.support.logbook import Logbook
from deap_tpu_torch.support.stats import Statistics
from deap_tpu_torch.telemetry import costs
from deap_tpu_torch.telemetry.journal import broadcast
from deap_tpu_torch.telemetry.meter import mean_f32


def _check_cx_mut(cxpb: float, mutpb: float) -> None:
    """The reference's ``cxpb + mutpb <= 1.0`` guard of varOr and the
    (μ + λ) / (μ, λ) loops, on Python floats."""
    if not float(cxpb) + float(mutpb) <= 1.0:
        raise ValueError("The sum of the crossover and mutation "
                         "probabilities must be smaller or equal to 1.0.")


def _tree_where(mask: torch.Tensor, a, b):
    def w(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)
    return pytree.tree_map(w, a, b)


def _as2d(values: torch.Tensor) -> torch.Tensor:
    return values[:, None] if values.ndim == 1 else values


def evaluate_invalid(pop: Population, evaluate: Callable) -> Population:
    """Batch-evaluate and write back only the invalid rows."""
    values = _as2d(evaluate(pop.genomes))
    return pop.with_fitness(values, mask=~pop.valid)


# ------------------------------------------------- fused variation plane ----
#
# var_and and var_or accept a ``fused`` mode: when the toolbox's (mate,
# mutate) pair is fused-capable (ops.variation.resolve_plan) and the
# genomes are one [n, L] tensor, the variation plane runs as one pass —
# masks drawn in the unfused operators' order, then one apply: the CUDA
# kernel (ops.kernels.fused_variation) on the card for bool/float32
# genomes, the plain apply (ops.variation.apply_variation) otherwise. Both
# give the children of the unfused composition for the same generator
# state.

def _resolve_fused(fused, toolbox, genomes, op: str = "var_and",
                   journal: bool = True,
                   probe_fns: Optional[Callable] = None
                   ) -> Tuple[Optional[str], object]:
    """``fused=`` → ``(mode, plan)``, mode ``None`` (unfused), ``'plain'``
    or ``'kernel'``. ``'auto'`` takes the kernel for CUDA bool/float32
    genomes, the plain apply otherwise, and the unfused composition when
    the configuration is not fused-capable; an explicit ``'plain'`` or
    ``'kernel'`` raises instead of computing something else. With
    ``journal`` the decision goes to the open journals as a
    ``variation_dispatch`` event (the loops journal their first
    generation's, as the JAX package journals its scan's one trace).

    ``'auto'`` also routes through the dispatch tuner
    (:func:`deap_tpu_torch.tuning.resolve`, knob ``fused``): its
    candidates are ``unfused`` and the static pick (``fused_kernel`` on
    the card, ``fused_plain`` elsewhere — never the kernel's plain
    version on the card). ``probe_fns`` — a zero-arg builder of
    candidate probe closures, supplied by var_and/var_or — lets the
    tuner race the real variation pass and persist the winner; without
    a tuner the static pick is unchanged."""
    def note(**payload):
        if journal:
            broadcast("variation_dispatch", op=op, **payload)

    if fused in (False, None, "off"):
        note(path="unfused", reason="disabled")
        return None, None
    if fused is True:
        fused = "auto"
    if fused not in ("auto", "plain", "kernel"):
        raise ValueError(f"unknown fused mode {fused!r}")
    plan = _variation.resolve_plan(toolbox)
    leaf = _variation.single_genome_leaf(genomes)
    reason = None
    if plan is None:
        reason = "operators not fused-capable"
    elif leaf is None:
        reason = "genomes are not a single [n, L] tensor"
    if reason is not None:
        if fused != "auto":
            raise ValueError(f"fused={fused!r} requested but {reason}")
        note(path="unfused", reason=reason)
        return None, None
    mode, reason = fused, "requested"
    if fused == "auto":
        on_card = leaf.device.type == "cuda" and leaf.dtype in KERNEL_DTYPES
        mode = "kernel" if on_card else "plain"
        reason = (f"{leaf.device.type} device, {leaf.dtype}"
                  + ("" if on_card or leaf.device.type != "cuda"
                     else " outside the kernel's set"))
        names = ("unfused", f"fused_{mode}")
        built = probe_fns() if probe_fns is not None else {}
        n, L = leaf.shape
        choice = tuning.resolve(
            "fused",
            bucket=(op, tuning.shape_bucket(n), tuning.shape_bucket(L),
                    str(leaf.dtype).replace("torch.", "")),
            default=f"fused_{mode}",
            candidates={name: built.get(name) for name in names},
            check="bitwise", program=op, device=leaf.device)
        if choice == "unfused":
            note(path="unfused", reason="tuned")
            return None, None
    elif fused == "kernel" and leaf.dtype not in KERNEL_DTYPES:
        raise ValueError(f"fused='kernel' requested but genome dtype "
                         f"{leaf.dtype} is outside the kernel's set")
    note(path=f"fused_{mode}", reason=reason, mate=plan.mate_name,
         mutate=plan.mut_name, mut_kind=plan.mut_kind)
    return mode, plan


def _variation_probe_fns(fused, generator: torch.Generator, pop, run):
    """Candidate probe-closure builder for the tuner's ``fused`` knob:
    each candidate re-runs the whole variation pass with that path
    forced (``run(g, f)`` calls var_and/var_or with an explicit
    ``fused=f``, which bypasses the tuner) on a copy of ``generator``,
    so the probe draws nothing from the caller's. A candidate's result
    is the offspring's tensors and its copy's final state. None when
    probing is impossible: explicit ``fused=``, no tuner, or a CUDA graph
    being captured."""
    if fused not in ("auto", True) or tuning.active_tuner() is None \
            or not tuning.is_concrete(pop):
        return None

    def path(f):
        def fn():
            g = torch.Generator(device=generator.device)
            g.set_state(generator.get_state())
            off = run(g, f)
            return (pytree.tree_leaves(off.genomes), off.fitness, off.valid,
                    pytree.tree_leaves(off.extras), g.get_state())
        return fn

    return lambda: {"unfused": path(False), "fused_plain": path("plain"),
                    "fused_kernel": path("kernel")}


def _rebuild_genomes(template, children):
    _, spec = pytree.tree_flatten(template)
    return pytree.tree_unflatten([children], spec)


def _rows_of(masks, rows):
    return tuple(None if m is None else m[rows[0]:rows[1]] for m in masks)


def var_and_apply(pop: Population, masks, mut_kind: str, mode: str,
                  sel_idx: Optional[torch.Tensor] = None,
                  rows: Optional[Tuple[int, int]] = None,
                  partner: Optional[torch.Tensor] = None) -> Population:
    """The apply half of the fused :func:`var_and`: children of
    ``gather(pop, sel_idx)`` (``pop`` when ``None``) under ``masks`` from
    :func:`ops.variation.var_and_masks`, through the kernel
    (``mode='kernel'``) or the plain apply (``'plain'``). Each child reads
    its partner row of ``pop`` by explicit index: ``partner`` (default
    the adjacent-pair mate's source row; the island pass gives mates
    within each deme). ``rows=(lo, hi)`` computes only those children (a
    rank's block under a plan)."""
    n = masks[0].shape[0]
    lo, hi = rows if rows is not None else (0, n)
    g = _variation.single_genome_leaf(pop.genomes)
    src = (torch.arange(n, device=g.device) if sel_idx is None
           else sel_idx.long())
    if partner is None:
        partner = src[_variation.pair_partner_positions(n, g.device).long()]
    src, partner = src[lo:hi], partner[lo:hi]
    cx_row, cx_lo, cx_hi, do_mut, mask, arg = _rows_of(masks, (lo, hi))
    if mode == "kernel":
        children = fused_variation(g, src.to(torch.int32),
                                   partner.to(torch.int32), cx_row, cx_lo,
                                   cx_hi, do_mut, mask, arg,
                                   mut_kind=mut_kind)
    else:
        children = _variation.apply_variation(g, src, partner, cx_row, cx_lo,
                                              cx_hi, do_mut, mask, arg,
                                              mut_kind)
    # fitness/valid/extras row-select only: the genome gather happens
    # inside the apply
    base = gather(pop.replace(genomes=()), src)
    genomes = _rebuild_genomes(pop.genomes, children)
    return base.replace(genomes=genomes).invalidate(cx_row | do_mut)


def var_and(generator: torch.Generator, pop: Population, toolbox,
            cxpb: float, mutpb: float, fused="auto",
            sel_idx: Optional[torch.Tensor] = None,
            rows: Optional[Tuple[int, int]] = None,
            _journal: bool = True) -> Population:
    """Crossover AND mutation variation (the reference's varAnd).

    Adjacent pairs (0,1), (2,3), ... mate with probability ``cxpb``; each
    individual then mutates with probability ``mutpb``; every touched row
    is invalidated. An odd last individual never mates. ``fused`` picks
    the execution (see :func:`_resolve_fused`); every mode gives the same
    children for the same generator state. ``sel_idx`` composes a
    selection gather into the plane: ``var_and(g, pop, tb, ...,
    sel_idx=idx)`` == ``var_and(g, gather(pop, idx), tb, ...)``. The
    execution picked is journaled (``variation_dispatch``). ``rows=(lo,
    hi)`` returns only those children, for the same draws (a rank's block
    under a plan; the unfused composition computes them all and keeps
    those, journaled ``sharding_fallback``).
    """
    probe = _variation_probe_fns(
        fused, generator, pop,
        lambda g, f: var_and(g, pop, toolbox, cxpb, mutpb, fused=f,
                             sel_idx=sel_idx, _journal=False))
    mode, plan = _resolve_fused(fused, toolbox, pop.genomes, "var_and",
                                _journal, probe)
    if mode is None:
        if sel_idx is not None:
            pop = gather(pop, sel_idx)
        off = _var_and_unfused(generator, pop, toolbox, cxpb, mutpb)
        return off if rows is None else _replicated_rows(off, rows,
                                                         "var_and")
    g = _variation.single_genome_leaf(pop.genomes)
    n = int(sel_idx.shape[0]) if sel_idx is not None else pop.size
    masks = _variation.var_and_masks(generator, n, g.shape[1], cxpb, mutpb,
                                     plan, g.dtype)
    return var_and_apply(pop, masks, plan.mut_kind, mode, sel_idx, rows)


def _replicated_rows(off: Population, rows: Tuple[int, int],
                     where: str) -> Population:
    """Rows ``[lo, hi)`` of children an unfused composition computed
    whole: that work ran replicated on every rank, which is journaled."""
    from deap_tpu_torch.parallel.mesh import sharding_fallback
    sharding_fallback(where, "unfused variation runs whole on every rank")
    return gather(off, torch.arange(rows[0], rows[1], device=off.device))


# the observatory profiles each under its tuner knob's program label, so a
# drift of what it launches evicts the knob's measured winner
var_and = costs.instrument(var_and, "var_and")


def _var_and_unfused(generator: torch.Generator, pop: Population, toolbox,
                     cxpb: float, mutpb: float) -> Population:
    """The compute-both-then-select composition — the oracle the fused
    plane is held against. Draw order: mate, pair Bernoullis, mutate, row
    Bernoullis."""
    n = pop.size
    npairs = n // 2
    dev = generator.device
    genomes = pop.genomes
    cx_touched = torch.zeros(n, dtype=torch.bool, device=dev)
    if npairs:
        even = pytree.tree_map(lambda a: a[0: 2 * npairs: 2], genomes)
        odd = pytree.tree_map(lambda a: a[1: 2 * npairs: 2], genomes)
        c1, c2 = toolbox.mate(generator, even, odd)
        do_cx = torch.rand(npairs, generator=generator, device=dev) < cxpb
        even = _tree_where(do_cx, c1, even)
        odd = _tree_where(do_cx, c2, odd)

        def interleave(e, o, orig):
            pair = torch.stack([e, o], dim=1).reshape(
                (2 * npairs,) + tuple(e.shape[1:]))
            return torch.cat([pair.to(orig.dtype), orig[2 * npairs:]], dim=0)

        genomes = pytree.tree_map(interleave, even, odd, genomes)
        cx_touched[: 2 * npairs] = do_cx.repeat_interleave(2)
    mutated = toolbox.mutate(generator, genomes)
    do_mut = torch.rand(n, generator=generator, device=dev) < mutpb
    genomes = _tree_where(do_mut, mutated, genomes)
    return pop.replace(genomes=genomes).invalidate(cx_touched | do_mut)


def var_or_apply(pop: Population, masks, mut_kind: str, mode: str,
                 rows: Optional[Tuple[int, int]] = None) -> Population:
    """The apply half of the fused :func:`var_or`: λ children of the
    N-row ``pop`` under ``masks`` from :func:`ops.variation.var_or_masks`,
    through the kernel (``mode='kernel'``) or the plain apply
    (``'plain'``). Each child carries its base row's fitness, ``valid``
    and extras; only mated and mutated children are invalidated.
    ``rows=(lo, hi)`` computes only those children."""
    if rows is not None:
        masks = _rows_of(masks, rows)
    base_idx, partner_idx, choice_cx, lo, hi, choice_mut, mask, arg = masks
    g = _variation.single_genome_leaf(pop.genomes)
    if mode == "kernel":
        children = fused_variation(g, base_idx.to(torch.int32),
                                   partner_idx.to(torch.int32), choice_cx,
                                   lo, hi, choice_mut, mask, arg,
                                   mut_kind=mut_kind)
    else:
        children = _variation.apply_variation(g, base_idx, partner_idx,
                                              choice_cx, lo, hi, choice_mut,
                                              mask, arg, mut_kind)
    base = gather(pop.replace(genomes=()), base_idx.long())
    genomes = _rebuild_genomes(pop.genomes, children)
    return base.replace(genomes=genomes).invalidate(choice_cx | choice_mut)


def var_or(generator: torch.Generator, pop: Population, toolbox,
           lambda_: int, cxpb: float, mutpb: float,
           fused="auto", rows: Optional[Tuple[int, int]] = None,
           _journal: bool = True) -> Population:
    """Crossover OR mutation OR reproduction (the reference's varOr).

    Each of the ``lambda_`` children independently: with probability
    ``cxpb`` the first child of a mating of two distinct random parents;
    else with probability ``mutpb`` a mutant of a random parent; else an
    unchanged copy of a random parent that keeps its valid fitness.
    ``fused`` picks the execution (see :func:`_resolve_fused`): the fused
    plane reads the λ children's parents from the N rows directly (K1 on
    the card). Every mode gives the same children for the same generator
    state. The execution picked is journaled (``variation_dispatch``).
    ``rows`` as in :func:`var_and`."""
    _check_cx_mut(cxpb, mutpb)
    probe = _variation_probe_fns(
        fused, generator, pop,
        lambda g, f: var_or(g, pop, toolbox, lambda_, cxpb, mutpb, fused=f,
                            _journal=False))
    mode, plan = _resolve_fused(fused, toolbox, pop.genomes, "var_or",
                                _journal, probe)
    if mode is None:
        off = _var_or_unfused(generator, pop, toolbox, lambda_, cxpb, mutpb)
        return off if rows is None else _replicated_rows(off, rows, "var_or")
    g = _variation.single_genome_leaf(pop.genomes)
    masks = _variation.var_or_masks(generator, pop.size, lambda_, g.shape[1],
                                    cxpb, mutpb, plan, g.dtype)
    return var_or_apply(pop, masks, plan.mut_kind, mode, rows)


var_or = costs.instrument(var_or, "var_or")


def _var_or_unfused(generator: torch.Generator, pop: Population, toolbox,
                    lambda_: int, cxpb: float, mutpb: float) -> Population:
    """The compute-both-then-select composition of var_or, the oracle of
    its fused plane: ``mate`` on all λ parent pairs (the first child
    kept) and ``mutate`` on all λ mutant parents, then a row select. Draw
    order: :func:`ops.variation.var_or_parents`, mate, mutate."""
    choice_cx, choice_mut, i, j, m = _variation.var_or_parents(
        generator, pop.size, lambda_, cxpb, mutpb)
    children = gather(pop, torch.where(choice_cx, i, m).long())

    def parents(idx):
        return pytree.tree_map(lambda a: a[idx.long()], pop.genomes)

    c1, _ = toolbox.mate(generator, parents(i), parents(j))
    mutants = toolbox.mutate(generator, parents(m))
    genomes = _tree_where(choice_cx, c1, children.genomes)
    genomes = _tree_where(choice_mut, mutants, genomes)
    return children.replace(genomes=genomes).invalidate(choice_cx | choice_mut)


# ------------------------------------------------------------------ loops ----

def _maybe_stats(stats: Optional[Statistics], pop: Population):
    return stats.compile(pop) if stats is not None else {}


# ------------------------------------------------------------- telemetry ----
#
# Every loop takes an optional ``telemetry`` (a RunTelemetry): a Meter
# state dict is updated each generation by tensor operations that read
# nothing back, each generation's state is kept on the device, and the
# journal receives header/run_start, one meter row per generation (one
# host transfer when the loop ends) and run_end. The meter draws nothing
# and feeds nothing back, so the results and the generator's state are
# bit-identical with and without it.

def _tel_declare(meter) -> None:
    """The built-in metric set every population loop maintains."""
    meter.counter("nevals")
    meter.gauge("best")
    meter.gauge("mean")
    meter.gauge("evaluated_frac")


def _frac(count, n: int, like: torch.Tensor) -> torch.Tensor:
    """``count / n`` in float32 as the JAX loops compute it: their scan is
    compiled, and XLA multiplies by the constant's float32 reciprocal (a
    float32 Python number, which a kernel multiplies by exactly)."""
    if not isinstance(count, torch.Tensor):
        count = torch.full((), count, dtype=torch.float32, device=like.device)
    return count.to(torch.float32) * float(np.float32(1) / np.float32(n))


def _tel_measure(tel, mstate, nevals, pop: Population, gen: int,
                 sel_idx=None, sel_pool=None, parent_idx=None):
    """A generation's built-in instrumentation, then the probes and the
    live stream. ``sel_idx``/``sel_pool``/``parent_idx`` hand the probes
    the selection indices the loop already holds."""
    m = tel.meter
    w0 = pop.wvalues[:, 0]
    mstate = m.inc(mstate, "nevals", nevals)
    mstate = m.set(mstate, "best", w0.max())
    mstate = m.set(mstate, "mean", mean_f32(w0))
    mstate = m.set(mstate, "evaluated_frac", _frac(nevals, pop.size, w0))
    mstate = tel.apply_probe(mstate, pop=pop, gen=gen, sel_idx=sel_idx,
                             sel_pool=sel_pool, parent_idx=parent_idx)
    tel.live(mstate, gen)
    return mstate


def _check_probes(probes, telemetry):
    if probes and telemetry is None:
        raise ValueError(
            "probes= requires telemetry= (a RunTelemetry): probe state "
            "rides the telemetry Meter")


# ------------------------------------------------------------ the plan ----

def _plan_rows(plan, n: int) -> Optional[Tuple[int, int]]:
    """This rank's block of ``n`` rows under ``plan``, or None when the
    rows are not split (no plan, one rank, or ``n`` not dividing)."""
    if plan is None or not plan.is_split(n):
        return None
    return plan.rows(n)


def _evaluate_planned(pop: Population, evaluate: Callable,
                      plan) -> Population:
    """:func:`evaluate_invalid`, each rank evaluating its block of rows
    under ``plan``, the rows gathered back."""
    if plan is None:
        return evaluate_invalid(pop, evaluate)
    return plan.map_rows(lambda p: evaluate_invalid(p, evaluate), pop,
                         pop.size)


def _evaluate_children(off: Population, evaluate: Callable, plan,
                       rows: Optional[Tuple[int, int]], n: int):
    """``(children evaluated, nevals)``; with ``rows`` the children are
    this rank's block of ``n``, gathered after evaluation."""
    invalid = ~off.valid
    off = evaluate_invalid(off, evaluate)
    if rows is not None:
        off, invalid = plan.gather_rows((off, invalid), n)
    return off, invalid.sum()


def _pop_loop_init(pop: Population, toolbox, halloffame_size: int,
                   stats: Optional[Statistics], plan=None):
    """Gen 0: evaluate the invalid founders, seed the hall of fame, build
    the gen-0 record."""
    nevals0 = (~pop.valid).sum()
    pop = _evaluate_planned(pop, toolbox.evaluate, plan)
    hof = hof_init(halloffame_size, pop) if halloffame_size else None
    if hof is not None:
        hof = hof_update(hof, pop)
    return pop, hof, {"nevals": nevals0, **_maybe_stats(stats, pop)}


def make_ea_simple_step(toolbox, cxpb: float, mutpb: float,
                        stats: Optional[Statistics] = None,
                        telemetry=None, fused="auto", plan=None) -> Callable:
    """The eaSimple generation step ``(generator, pop, hof) -> (pop, hof,
    record)``: select n → var_and → evaluate invalid → replace. With
    ``telemetry`` the step is ``(generator, pop, hof, mstate, gen) ->
    (pop, hof, record, mstate)``. With ``plan`` each rank varies and
    evaluates its block of the children. ``step.told(off, hof, nevals,
    sel_idx)`` is what follows the evaluation (the hall of fame, the
    record, the meter), for children already evaluated; with
    ``telemetry`` it takes ``mstate, gen`` after them."""
    tel = telemetry
    first = [True]  # the dispatch is journaled once, at the first call

    def step(generator, pop, hof, mstate=None, gen=None):
        idx = toolbox.select(generator, pop.wvalues, pop.size)
        rows = _plan_rows(plan, pop.size)
        off = var_and(generator, pop, toolbox, cxpb, mutpb, fused=fused,
                      sel_idx=idx, rows=rows, _journal=first[0])
        first[0] = False
        off, nevals = _evaluate_children(off, toolbox.evaluate, plan, rows,
                                         pop.size)
        return told(off, hof, nevals, idx, mstate, gen)

    def told(off, hof, nevals, sel_idx, mstate=None, gen=None):
        if plan is not None:
            off = plan.constrain(off)
        if hof is not None:
            hof = hof_update(hof, off)
        rec = {"nevals": nevals, **_maybe_stats(stats, off)}
        if tel is None:
            return off, hof, rec
        # the selection doubles as parentage: child i descends from
        # pop[idx[i]]
        mstate = _tel_measure(tel, mstate, nevals, off, gen,
                              sel_idx=sel_idx, sel_pool=off.size,
                              parent_idx=sel_idx)
        return off, hof, rec, mstate

    step.told = told
    return step


def _run_pop_loop(algorithm, generator, pop, toolbox, step, ngen, stats,
                  halloffame_size, verbose, device, tel=None, probes=(),
                  plan=None, **params):
    """Gen 0, then ``ngen`` calls of ``step`` on ``device``; the records
    (and the meter's states) stay on the device until the loop ends."""
    _check_probes(probes, tel)
    dev = resolve_device(device)
    check_generator(generator, dev)
    pop = pop.to(dev) if plan is None else plan.place(pop)
    pop, hof, record0 = _pop_loop_init(pop, toolbox, halloffame_size, stats,
                                       plan)
    records = []
    if tel is None:
        for _ in range(ngen):
            pop, hof, rec = step(generator, pop, hof)
            records.append(rec)
    else:
        tel.begin_run(algorithm, toolbox, declare=_tel_declare,
                      probes=probes, ngen=ngen, **params)
        mstate0 = mstate = _tel_measure(tel, tel.meter.init(device=dev),
                                        record0["nevals"], pop, 0)
        mstates = []
        for gen in range(1, ngen + 1):
            pop, hof, rec, mstate = step(generator, pop, hof, mstate, gen)
            records.append(rec)
            mstates.append(mstate)
        tel.end_run(algorithm, stacked_meter=tel.meter.stack(mstates),
                    initial=mstate0, ngen=ngen)
    logbook = _build_logbook(record0, records, stats)
    if verbose:
        print(logbook.stream)
    return pop, logbook, hof


def ea_simple(generator: torch.Generator, pop: Population, toolbox,
              cxpb: float, mutpb: float, ngen: int,
              stats: Optional[Statistics] = None, halloffame_size: int = 0,
              verbose: bool = False, telemetry=None, probes=(),
              fused="auto", plan=None, device: DeviceLike = None,
              ) -> Tuple[Population, Logbook, Optional[HallOfFame]]:
    """The canonical generational GA: select n → varAnd → evaluate
    invalid → replace, for ``ngen`` generations, on ``device`` (the card
    unless ``device="cpu"``; ``generator`` must live there too).
    ``telemetry`` (a :class:`deap_tpu_torch.telemetry.RunTelemetry`)
    meters and journals the run, ``probes`` add population probes
    (:mod:`deap_tpu_torch.telemetry.probes`) to its meter; results are
    unchanged either way. ``fused`` as in :func:`var_and`. ``plan`` (a
    :class:`deap_tpu_torch.parallel.ShardingPlan`) places the population
    on the plan and splits the generations' per-row work over its ranks;
    the same bits on any rank count, the whole result on every rank."""
    step = make_ea_simple_step(toolbox, cxpb, mutpb, stats, telemetry,
                               fused=fused, plan=plan)
    return _run_pop_loop("ea_simple", generator, pop, toolbox, step, ngen,
                         stats, halloffame_size, verbose, device, telemetry,
                         probes, plan, n=pop.size, cxpb=cxpb, mutpb=mutpb)


def _make_mu_lambda_step(toolbox, mu: int, lambda_: int, cxpb: float,
                         mutpb: float, stats: Optional[Statistics],
                         tel, fused, plus: bool, plan=None) -> Callable:
    first = [True]  # the dispatch is journaled once, at the first call

    def step(generator, pop, hof, mstate=None, gen=None):
        rows = _plan_rows(plan, lambda_)
        off = var_or(generator, pop, toolbox, lambda_, cxpb, mutpb,
                     fused=fused, rows=rows, _journal=first[0])
        first[0] = False
        off, nevals = _evaluate_children(off, toolbox.evaluate, plan, rows,
                                         lambda_)
        return told(generator, pop, off, hof, nevals, mstate, gen)

    def told(generator, pop, off, hof, nevals, mstate=None, gen=None):
        pool = concat([pop, off]) if plus else off
        idx = toolbox.select(generator, pool.wvalues, mu)
        new_pop = gather(pool, idx)
        if plan is not None:
            new_pop = plan.constrain(new_pop)
        if hof is not None:
            hof = hof_update(hof, off)
        rec = {"nevals": nevals, **_maybe_stats(stats, new_pop)}
        if tel is None:
            return new_pop, hof, rec
        # environmental selection over the pool: probes see which rows
        # survived, not parentage (var_or's parents are internal draws)
        mstate = _tel_measure(tel, mstate, nevals, new_pop, gen,
                              sel_idx=idx, sel_pool=pool.size)
        return new_pop, hof, rec, mstate

    step.told = told
    return step


def make_ea_mu_plus_lambda_step(toolbox, mu: int, lambda_: int, cxpb: float,
                                mutpb: float,
                                stats: Optional[Statistics] = None,
                                telemetry=None, fused="auto",
                                plan=None) -> Callable:
    """The (μ + λ) generation step ``(generator, pop, hof) -> (pop, hof,
    record)``: var_or λ children → evaluate invalid → select μ from the
    parents and children together. The hall of fame sees the children;
    the record is taken on the new population. With ``telemetry`` the
    step carries the meter state as :func:`make_ea_simple_step`'s; with
    ``plan`` each rank varies and evaluates its block of the children.
    ``step.told(generator, pop, off, hof, nevals)`` is what follows the
    evaluation of the children ``off`` of ``pop`` (the survivors'
    selection, the hall of fame, the record, the meter); with
    ``telemetry`` it takes ``mstate, gen`` after them."""
    return _make_mu_lambda_step(toolbox, mu, lambda_, cxpb, mutpb, stats,
                                telemetry, fused, plus=True, plan=plan)


def make_ea_mu_comma_lambda_step(toolbox, mu: int, lambda_: int,
                                 cxpb: float, mutpb: float,
                                 stats: Optional[Statistics] = None,
                                 telemetry=None, fused="auto",
                                 plan=None) -> Callable:
    """The (μ, λ) generation step: as :func:`make_ea_mu_plus_lambda_step`,
    with μ selected from the children alone."""
    return _make_mu_lambda_step(toolbox, mu, lambda_, cxpb, mutpb, stats,
                                telemetry, fused, plus=False, plan=plan)


def ea_mu_plus_lambda(generator: torch.Generator, pop: Population, toolbox,
                      mu: int, lambda_: int, cxpb: float, mutpb: float,
                      ngen: int, stats: Optional[Statistics] = None,
                      halloffame_size: int = 0, verbose: bool = False,
                      telemetry=None, probes=(), fused="auto", plan=None,
                      device: DeviceLike = None,
                      ) -> Tuple[Population, Logbook, Optional[HallOfFame]]:
    """(μ + λ) evolution (the reference's eaMuPlusLambda): the parents
    compete with their children for the μ places. ``device``,
    ``telemetry``, ``probes``, ``fused`` and ``plan`` as in
    :func:`ea_simple` (``fused`` as in :func:`var_or`)."""
    _check_cx_mut(cxpb, mutpb)
    step = make_ea_mu_plus_lambda_step(toolbox, mu, lambda_, cxpb, mutpb,
                                       stats, telemetry, fused=fused,
                                       plan=plan)
    return _run_pop_loop("ea_mu_plus_lambda", generator, pop, toolbox, step,
                         ngen, stats, halloffame_size, verbose, device,
                         telemetry, probes, plan, mu=mu, lambda_=lambda_,
                         cxpb=cxpb, mutpb=mutpb)


def ea_mu_comma_lambda(generator: torch.Generator, pop: Population, toolbox,
                       mu: int, lambda_: int, cxpb: float, mutpb: float,
                       ngen: int, stats: Optional[Statistics] = None,
                       halloffame_size: int = 0, verbose: bool = False,
                       telemetry=None, probes=(), fused="auto", plan=None,
                       device: DeviceLike = None,
                       ) -> Tuple[Population, Logbook, Optional[HallOfFame]]:
    """(μ, λ) evolution (the reference's eaMuCommaLambda): only the
    children survive, so ``lambda_ >= mu``. ``device``, ``telemetry``,
    ``probes``, ``fused`` and ``plan`` as in :func:`ea_mu_plus_lambda`."""
    if lambda_ < mu:
        raise ValueError("lambda must be greater or equal to mu.")
    _check_cx_mut(cxpb, mutpb)
    step = make_ea_mu_comma_lambda_step(toolbox, mu, lambda_, cxpb, mutpb,
                                        stats, telemetry, fused=fused,
                                        plan=plan)
    return _run_pop_loop("ea_mu_comma_lambda", generator, pop, toolbox,
                         step, ngen, stats, halloffame_size, verbose, device,
                         telemetry, probes, plan, mu=mu, lambda_=lambda_,
                         cxpb=cxpb, mutpb=mutpb)


def _host(record):
    return pytree.tree_map(lambda v: v.cpu() if isinstance(v, torch.Tensor)
                           else v, record)


def _build_logbook(record0, records, stats) -> Logbook:
    logbook = Logbook()
    logbook.header = ["gen", "nevals"] + (list(stats.fields) if stats
                                          else [])
    for gen, rec in enumerate([record0] + records):
        logbook.record(gen=gen, **_host(rec))
    return logbook


# ------------------------------------------------------ packed OneMax ----

def ea_simple_packed(generator: torch.Generator, packed: torch.Tensor,
                     fit: torch.Tensor, length: int, ngen: int, *,
                     cxpb: float, mutpb: float, indpb: float,
                     tournsize: int = 3, select: str = "gather",
                     prng: str = "input", device: DeviceLike = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ngen`` OneMax eaSimple generations on bit-packed genomes:
    tournament selection, then :func:`ops.packed.fused_variation_eval_packed`
    (two-point crossover, flip-bit mutation, popcount fitness) — the
    generations of the JAX package's ``bench.py`` candidates
    ``make_run_selgather`` (``select='gather'``) and ``make_run_packed``
    (``'sorted'``, and ``'binned'`` for ``packed_binned``).

    ``select='gather'`` selects and gathers the parents in one kernel
    (:func:`ops.packed.sel_tournament_gather_packed`); ``select='sorted'``
    uses the rank-based :func:`ops.selection.sel_tournament_sorted` and an
    index gather; ``select='binned'`` is ``'sorted'`` with the counting
    sort (:func:`ops.selection.sel_tournament_binned` over the integer
    fitness range ``[0, length]``), the same winners.

    ``prng='input'`` draws each generation's bits with ``generator`` and
    streams them into the kernels (draw order: aspirant bits or ranks,
    then variation bits); ``prng='hw'`` draws one Philox key per
    generation (then the ranks of ``'sorted'``/``'binned'``), which the
    generation's kernels share: the select-and-gather kernel, then the
    variation kernel. ``'auto'`` is ``'hw'`` on the card, ``'input'`` on
    the CPU.

    :param packed: ``uint32[n, W]`` rows (:func:`ops.packed.pack_genomes`).
    :param fit: ``f32[n]`` fitness (:func:`ops.packed.packed_fitness`).
    :returns: ``(packed, fit)`` after ``ngen`` generations.
    """
    if select not in ("gather", "sorted", "binned"):
        raise ValueError(f"unknown select {select!r}")
    dev = resolve_device(device)
    mode = _resolve_prng(prng, dev)
    check_generator(generator, dev)
    packed, fit = packed.to(dev), fit.to(dev)
    n, W = packed.shape
    probs = dict(cxpb=cxpb, mutpb=mutpb, indpb=indpb)
    for _ in range(ngen):
        key = philox_key(generator) if mode == "hw" else None
        if select == "gather" and key is not None:
            parents = _packed.sel_tournament_gather_packed(
                packed, fit, tournsize=tournsize, prng="hw", key=key)
        elif select == "gather":
            parents = _packed.sel_tournament_gather_packed(
                packed, fit, _packed.tournament_bits(generator, tournsize, n))
        else:
            if select == "sorted":
                idx = sel_tournament_sorted(generator, fit[:, None], n,
                                            tournsize)
            else:
                idx = sel_tournament_binned(generator, fit[:, None], n,
                                            tournsize, 0, length)
            parents = packed.view(torch.int32)[idx].view(torch.uint32)
        if key is not None:
            packed, fit = _packed.fused_variation_eval_packed(
                parents, length, key=key, prng="hw", **probs)
        else:
            packed, fit = _packed.fused_variation_eval_packed(
                parents, length, *_packed.variation_bits(generator, n, W),
                **probs)
    return packed, fit


# ------------------------------------------------- ask-tell (strategies) ----

def _generate_update_init(genomes, values: torch.Tensor, spec: FitnessSpec,
                          halloffame_size: int):
    """``(lam, hof)`` from the first generation's genomes and values: λ is
    their leading size and the hall of fame is shaped on them, so learning
    them spends no draw and no evaluation (the JAX package traces the
    shapes with ``jax.eval_shape``)."""
    lam = pytree.tree_leaves(genomes)[0].shape[0]
    template = Population(genomes=genomes, fitness=values.to(torch.float32),
                          valid=torch.ones(lam, dtype=torch.bool,
                                           device=values.device), spec=spec)
    hof = hof_init(halloffame_size, template) if halloffame_size else None
    return lam, hof


def _evaluate_genomes(evaluate: Callable, genomes, plan) -> torch.Tensor:
    """``evaluate(genomes)`` as ``[n, nobj]``, each rank evaluating its
    block of the rows under ``plan``."""
    if plan is None:
        return _as2d(evaluate(genomes))
    return plan.map_rows(lambda g: _as2d(evaluate(g)), genomes,
                         pytree.tree_leaves(genomes)[0].shape[0])


def make_ea_generate_update_step(toolbox, spec: FitnessSpec, lam: int,
                                 stats: Optional[Statistics] = None,
                                 telemetry=None, plan=None) -> Callable:
    """The ask-tell generation step ``(generator, state, hof) -> (state,
    hof, record)``: generate → evaluate → update. ``step.tell(state, hof,
    genomes, values)`` is its second half, for genomes already generated
    and evaluated; ``step.told(new_state, hof, genomes, values)`` is what
    follows the update (the hall of fame, the record, the meter), for a
    state already updated. With ``telemetry`` all take ``mstate, gen``
    after their arguments and return the meter state after the record. With
    ``plan`` each rank evaluates its block of the λ genomes; the update
    reads them all."""
    tel = telemetry

    def tell(state, hof, genomes, values, mstate=None, gen=None):
        return told(toolbox.update(state, genomes, values), hof, genomes,
                    values, mstate, gen)

    def told(new_state, hof, genomes, values, mstate=None, gen=None):
        pop = Population(genomes=genomes, fitness=values.to(torch.float32),
                         valid=torch.ones(lam, dtype=torch.bool,
                                          device=values.device), spec=spec)
        if plan is not None:
            new_state = plan.constrain(new_state)
        if hof is not None:
            hof = hof_update(hof, pop)
        rec = {"nevals": lam, **_maybe_stats(stats, pop)}
        if tel is None:
            return new_state, hof, rec
        m = tel.meter
        w0 = pop.wvalues[:, 0]
        mstate = m.inc(mstate, "nevals", lam)
        mstate = m.set(mstate, "best", w0.max())
        mstate = m.set(mstate, "mean", mean_f32(w0))
        mstate = m.set(mstate, "evaluated_frac", 1.0)
        mstate = tel.apply_probe(mstate, pop=pop, state=new_state, gen=gen)
        tel.live(mstate, gen)
        return new_state, hof, rec, mstate

    def step(generator, state, hof, mstate=None, gen=None):
        genomes = toolbox.generate(generator, state)
        args = (mstate, gen) if tel is not None else ()
        return tell(state, hof, genomes,
                    _evaluate_genomes(toolbox.evaluate, genomes, plan),
                    *args)

    step.tell = tell
    step.told = told
    return step


def _build_gu_logbook(records, stats) -> Logbook:
    """The ask-tell loop's logbook: one row per generation from gen 0 (no
    separate founder record), moved to the host at the end."""
    logbook = Logbook()
    logbook.header = ["gen", "nevals"] + (list(stats.fields) if stats
                                          else [])
    for gen, rec in enumerate(records):
        logbook.record(gen=gen, **_host(rec))
    return logbook


def ea_generate_update(generator: torch.Generator, state: Any, toolbox,
                       ngen: int, spec: FitnessSpec,
                       stats: Optional[Statistics] = None,
                       halloffame_size: int = 0, verbose: bool = False,
                       telemetry=None, probes=(), fused="auto", plan=None,
                       device: DeviceLike = None,
                       ) -> Tuple[Any, Logbook, Optional[HallOfFame]]:
    """The ask-tell loop (the reference's eaGenerateUpdate) driving
    CMA-ES-style strategies on ``device`` (the card unless
    ``device="cpu"``; ``generator`` and the state must live there):

    - ``toolbox.generate``: ``(generator, state) -> genomes``
    - ``toolbox.evaluate``: ``genomes -> values [λ] | [λ, nobj]``
    - ``toolbox.update``:   ``(state, genomes, values) -> state``

    Each generation is generate → evaluate → update, then the hall of
    fame and the statistics. The records stay on the device until the
    loop ends, so the loop itself never waits for the card (a strategy's
    update may: CMA-ES's ``torch.linalg.eigh`` does). ``telemetry`` and
    ``probes`` as in :func:`ea_simple` (meter rows from gen 0, no
    founder row; λ, which the run journals, is known after the first
    ``generate``). ``fused`` is accepted, as in the JAX package, and
    inert: this loop's variation is the strategy's ``generate``.
    ``plan`` places the strategy state on the plan and splits each
    generation's evaluation over its ranks, as in :func:`ea_simple`.
    """
    del fused  # no variation plane in the ask-tell loop
    tel = telemetry
    _check_probes(probes, tel)
    dev = resolve_device(device)
    check_generator(generator, dev)
    if plan is not None:
        state = plan.place(state)
    step, hof, records, mstates, lam = None, None, [], [], None
    for gen in range(ngen):
        if step is None:
            genomes = toolbox.generate(generator, state)
            values = _evaluate_genomes(toolbox.evaluate, genomes, plan)
            lam, hof = _generate_update_init(genomes, values, spec,
                                             halloffame_size)
            step = make_ea_generate_update_step(toolbox, spec, lam, stats,
                                                tel, plan=plan)
            if tel is None:
                state, hof, rec = step.tell(state, hof, genomes, values)
            else:
                tel.begin_run("ea_generate_update", toolbox,
                              declare=_tel_declare, probes=probes, ngen=ngen,
                              lambda_=lam)
                state, hof, rec, mstate = step.tell(
                    state, hof, genomes, values,
                    tel.meter.init(device=dev), gen)
                mstates.append(mstate)
        elif tel is None:
            state, hof, rec = step(generator, state, hof)
        else:
            state, hof, rec, mstate = step(generator, state, hof, mstate, gen)
            mstates.append(mstate)
        records.append(rec)
    if tel is not None:
        if step is None:  # ngen 0: no generation told λ
            tel.begin_run("ea_generate_update", toolbox,
                          declare=_tel_declare, probes=probes, ngen=ngen,
                          lambda_=lam)
        tel.end_run("ea_generate_update",
                    stacked_meter=tel.meter.stack(mstates), gen0=0,
                    ngen=ngen)
    logbook = _build_gu_logbook(records, stats)
    if verbose:
        print(logbook.stream)
    return state, logbook, hof
