"""Island-model evolution.

Port of :mod:`deap_tpu.parallel.island` (the reference's island and
multi-demic examples). Demes are stacked in one population ``[n_islands,
island_size, ...]``; an epoch runs ``freq`` eaSimple generations in every
deme, then one ring migration (:mod:`deap_tpu_torch.parallel.migration`).

A generation of all demes is one batched pass: the tournaments of every
deme drawn at once and offset to their deme, one ``var_and`` plane over
the flattened ``[n_islands * island_size, L]`` genomes (K1 on the card:
one launch a generation, not one a deme; each row's partner is explicit,
so pairs never straddle demes) and one evaluation. Its result equals a
loop over the demes on the same draws, bit for bit
(:func:`island_generation`).

Three paths, as in the JAX package:

- no mesh: the stacked demes on one device;
- ``plan=`` (a :class:`~deap_tpu_torch.parallel.ShardingPlan`): every
  rank holds the whole stack, runs its block of demes, and the blocks
  are gathered for migration; the same bits on any rank count;
- ``mesh=``: the explicit-collective path, each rank holding its block
  of demes (:func:`~deap_tpu_torch.parallel.shard_population` over
  ``axis_name``); the last deme's emigrants of a rank ride a
  ``batch_isend_irecv`` ring to the next rank's first deme.

Every rank draws every deme's draws and keeps its own, so the three
paths agree bit for bit for a migration selection that draws nothing
(the default ``sel_best``). The batched pass needs tournament selection
and a fused-capable (mate, mutate) pair; other toolboxes run deme by
deme through ``var_and`` (its fused plane, K1 on the card, whenever the
pair allows) on the whole stack (journaled ``sharding_fallback`` under a
plan of several ranks; refused on the mesh path of several ranks).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from deap_tpu_torch.algorithms import (_resolve_fused, evaluate_invalid,
                                       var_and, var_and_apply)
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import Population, init_population
from deap_tpu_torch.device import DeviceLike
from deap_tpu_torch.ops import selection as _sel
from deap_tpu_torch.ops import variation as _variation
from deap_tpu_torch.ops.kernels import KERNEL_DTYPES
from deap_tpu_torch.parallel.mesh import sharding_fallback
from deap_tpu_torch.parallel.migration import (_deme_map, _deme_wvalues,
                                               _put_rows, _take_rows,
                                               mig_ring, ring_permute)
from deap_tpu_torch.support.profiling import span

__all__ = ["IslandState", "island_init", "island_generation",
           "island_draws", "make_island_step"]

IslandState = Population  # demes stacked on the leading axis


def island_init(generator: torch.Generator, n_islands: int,
                island_size: int, init_genome: Callable, spec: FitnessSpec,
                device: DeviceLike = None) -> Population:
    """Stacked island populations: leaves ``[n_islands, island_size,
    ...]``, drawn as one population of ``n_islands * island_size`` rows
    on ``device`` (the card unless ``device="cpu"``)."""
    pop = init_population(generator, n_islands * island_size, init_genome,
                          spec, device=device)
    return _deme_map(
        lambda a: a.reshape((n_islands, island_size) + a.shape[1:]), pop)


def _flatten_demes(pops: Population) -> Population:
    """The stacked demes viewed as one flat population (the shape every
    probe expects)."""
    return _deme_map(lambda a: a.reshape((-1,) + a.shape[2:]), pops)


def _stack_demes(pop: Population, n_demes: int) -> Population:
    return _deme_map(lambda a: a.reshape((n_demes, -1) + a.shape[1:]), pop)


def _slice_demes(pops: Population, lo: int, hi: int) -> Population:
    return _deme_map(lambda a: a[lo:hi], pops)


def _tournsize(toolbox) -> Optional[int]:
    """The tournament size when ``toolbox.select`` is tournament
    selection (the batched pass draws its aspirants), else None."""
    fn, args, kwargs = _variation._partial_parts(toolbox.select)
    if fn is not _sel.sel_tournament:
        return None
    return int(kwargs.get("tournsize", args[0] if args else 0)) or None


def island_draws(generator: torch.Generator, n_islands: int,
                 island_size: int, length: int, tournsize: int,
                 cxpb: float, mutpb: float, vplan, dtype):
    """One generation's draws for every deme: ``(aspirants int64[n_islands,
    S, tournsize], masks)`` with ``masks`` as
    :func:`~deap_tpu_torch.ops.variation.var_and_masks` returns them,
    each led by ``[n_islands, S]``. An odd deme is drawn one row longer
    and cut; its last row never mates."""
    S = island_size
    aspirants = _sel.tournament_aspirants(
        generator, S, n_islands * S, tournsize).reshape(n_islands, S,
                                                         tournsize)
    S2 = S + S % 2
    masks = _variation.var_and_masks(generator, n_islands * S2, length,
                                     cxpb, mutpb, vplan, dtype)
    masks = [None if m is None else
             m.reshape((n_islands, S2) + m.shape[1:])[:, :S] for m in masks]
    if S2 != S:
        masks[0] = masks[0].clone()
        masks[0][:, S - 1] = False
    return aspirants, tuple(masks)


def island_generation(pops: Population, aspirants: torch.Tensor, masks,
                      toolbox, mut_kind: str, mode: str,
                      evaluate_rows: Optional[Callable] = None
                      ) -> Population:
    """One eaSimple generation of every deme of ``pops`` (stacked ``[m,
    S, ...]``) on given draws: ``aspirants`` ``[m, S, t]`` (indices within
    each deme) and ``masks`` led by ``[m, S]``. Tournament winners, the
    variation plane (``mode``: ``'kernel'``, K1, or ``'plain'``) and
    ``evaluate_invalid`` run once over the flattened demes;
    ``evaluate_rows(off) -> off`` takes the evaluation's place when
    given."""
    m, S = pops.valid.shape[:2]
    flat = _flatten_demes(pops)
    dev = flat.device
    offset = (torch.arange(m, device=dev) * S)[:, None]
    idx = _sel._tournament_winners(
        flat.wvalues, (aspirants + offset[..., None]).reshape(m * S, -1))
    masks = tuple(None if x is None else x.reshape((m * S,) + x.shape[2:])
                  for x in masks)
    pos = (_variation.pair_partner_positions(S, dev).long()[None, :]
           + offset).reshape(-1)
    off = var_and_apply(flat, masks, mut_kind, mode, sel_idx=idx,
                        partner=idx[pos])
    off = (evaluate_invalid(off, toolbox.evaluate) if evaluate_rows is None
           else evaluate_rows(off))
    return _stack_demes(off, m)


def _deme_generation(generator, pops: Population, toolbox, cxpb: float,
                     mutpb: float, journal: bool) -> Population:
    """The per-deme generation for toolboxes the batched pass cannot
    take: select, then :func:`~deap_tpu_torch.algorithms.var_and` (its
    fused plane when the (mate, mutate) pair allows: K1 on the card),
    deme after deme. ``journal`` journals the first deme's dispatch."""
    out = []
    for d in range(pops.valid.shape[0]):
        deme = _deme_map(lambda a: a[d], pops)
        idx = toolbox.select(generator, deme.wvalues, deme.size)
        off = var_and(generator, deme, toolbox, cxpb, mutpb, sel_idx=idx,
                      _journal=journal and d == 0)
        out.append(evaluate_invalid(off, toolbox.evaluate))
    return Population(
        genomes=torch.utils._pytree.tree_map(
            lambda *a: torch.stack(a), *[p.genomes for p in out]),
        fitness=torch.stack([p.fitness for p in out]),
        valid=torch.stack([p.valid for p in out]),
        extras=torch.utils._pytree.tree_map(
            lambda *a: torch.stack(a), *[p.extras for p in out]),
        spec=pops.spec)


def _local_stats(pops: Population):
    """The best/mean gauges' sufficient statistics: max, sum and valid
    count of the first weighted objective over ``pops``."""
    w0 = torch.where(pops.valid, (pops.fitness
                                  * pops.spec.warray(pops.device))[..., 0],
                     -torch.inf)
    return (w0.max(), torch.where(pops.valid, w0, 0.0).sum(),
            pops.valid.to(torch.float32).sum())


def make_island_step(toolbox, cxpb: float, mutpb: float, freq: int,
                     mig_k: int, mesh=None, axis_name: str = "island",
                     selection: Callable = _sel.sel_best,
                     telemetry=None, probes=(), plan=None,
                     donate: bool = False):
    """Build ``step(generator, pops) -> pops``: ``freq`` generations in
    every deme, then one ring migration of ``mig_k`` emigrants a deme
    (the reference's FREQ-generation epoch).

    ``plan`` (mutually exclusive with ``mesh``) runs each rank's block of
    demes and gathers the blocks for :func:`mig_ring`: the same bits on
    any rank count, the whole stack on every rank. ``mesh`` takes the
    explicit-collective path: ``pops`` is this rank's block of demes
    along ``axis_name`` and the step returns it. ``donate`` is accepted
    for the JAX signature (PyTorch has no buffer donation).

    With ``telemetry`` (a :class:`~deap_tpu_torch.telemetry.RunTelemetry`)
    the step is ``step(generator, pops, mstate) -> (pops, mstate)``: the
    counters ``epochs``, ``generations``, ``migrants`` and the gauges
    ``best``, ``mean`` over all demes (on the mesh path the ranks' max and
    sums are all-reduced, in the spans ``island/pmax`` and
    ``island/psum``); ``probes`` see the deme-flattened population. Build
    the initial state with ``telemetry.meter.init()`` after this call.

    Without ``mesh``, ``step.told(generator, pops[, mstate])`` is the
    epoch's tail for demes whose ``freq`` generations already ran: the
    migration, then the instrumentation."""
    del donate
    if plan is not None and mesh is not None:
        raise ValueError("pass either mesh= (shard_map path) or "
                         "plan= (pjit path), not both")
    tournsize = _tournsize(toolbox)
    first = [True]

    def batched_mode(pops):
        """``(mode, variation plan)`` of the batched pass for these
        genomes, or None when the toolbox needs the per-deme pass. The
        first call journals the dispatch."""
        vplan = _variation.resolve_plan(toolbox)
        leaf = _variation.single_genome_leaf(_flatten_demes(pops).genomes)
        if tournsize is None or vplan is None or leaf is None:
            return None
        mode = ("kernel" if leaf.device.type == "cuda"
                and leaf.dtype in KERNEL_DTYPES else "plain")
        _resolve_fused(mode, toolbox, leaf, "var_and", journal=first[0])
        first[0] = False
        return mode, vplan

    def generations(generator, pops, n_total: int, lo: int, hi: int,
                    batched):
        """``freq`` generations of the demes ``[lo, hi)`` of ``n_total``
        (``pops`` holds exactly those), drawing every deme's draws."""
        if batched is None:
            for _ in range(freq):
                pops = _deme_generation(generator, pops, toolbox, cxpb,
                                        mutpb, journal=first[0])
                first[0] = False
            return pops
        mode, vplan = batched
        S = pops.valid.shape[1]
        g = _variation.single_genome_leaf(_flatten_demes(pops).genomes)
        for _ in range(freq):
            aspirants, masks = island_draws(generator, n_total, S,
                                            g.shape[-1], tournsize, cxpb,
                                            mutpb, vplan, g.dtype)
            if (lo, hi) != (0, n_total):
                aspirants = aspirants[lo:hi]
                masks = tuple(None if x is None else x[lo:hi]
                              for x in masks)
            pops = island_generation(pops, aspirants, masks, toolbox,
                                     vplan.mut_kind, mode)
        return pops

    def global_epoch(generator, pops):
        """No mesh, or a plan: the whole stack in, the whole stack out."""
        n = pops.valid.shape[0]
        lo, hi = (0, n) if plan is None else plan.rows(n)
        batched = batched_mode(pops)
        if (lo, hi) != (0, n) and batched is None:
            sharding_fallback("make_island_step", "the toolbox needs the "
                              "per-deme pass: every rank runs every deme")
            lo, hi = 0, n
        if plan is not None:
            pops = plan.constrain(pops)
        if (lo, hi) == (0, n):
            pops = generations(generator, pops, n, 0, n, batched)
        else:
            local = generations(generator, _slice_demes(pops, lo, hi), n,
                                lo, hi, batched)
            pops = plan.gather_rows(local, n)
        return migrate(generator, pops)

    def migrate(generator, pops):
        """The epoch's tail on the whole stack: one ring migration."""
        pops = mig_ring(generator, pops, mig_k, selection=selection)
        return pops if plan is None else plan.constrain(pops)

    def mesh_epoch(generator, pops):
        """The explicit-collective path: this rank's block of demes."""
        size = mesh.axis_size(axis_name)
        m = pops.valid.shape[0]
        lo = mesh.axis_index(axis_name) * m
        batched = batched_mode(pops)
        if batched is None and size > 1:
            raise ValueError(
                "the island step's mesh path needs tournament selection "
                "and a fused-capable (mate, mutate) pair")
        pops = generations(generator, pops, m * size, lo, lo + m, batched)
        return _migrate_sharded(generator, pops, mig_k, selection, mesh,
                                axis_name)

    base = global_epoch if mesh is None else mesh_epoch

    tel = telemetry
    if tel is None:
        if probes:
            raise ValueError("probes= requires telemetry= (a "
                             "RunTelemetry): probe state rides the "
                             "telemetry Meter carry")
        step = (plan.compile(base, label="island_step") if plan is not None
                else base)
        if mesh is None:
            step.told = migrate
        return step

    meter = tel.meter
    meter.counter("epochs")
    meter.counter("generations")
    meter.counter("migrants")
    meter.gauge("best")
    meter.gauge("mean")
    if tel.probe is not None and hasattr(tel.probe, "declare"):
        tel.probe.declare(meter)
    tel.add_probes(probes)

    def instrumented(generator, pops, mstate):
        return measure(base(generator, pops), mstate)

    def measure(pops, mstate):
        """The epoch's instrumentation of the migrated stack."""
        gmax, gsum, gcnt = _local_stats(pops)
        n_islands = pops.valid.shape[0]
        seen = pops
        if mesh is not None:
            gmax, gsum, gcnt = _reduce_stats(gmax, gsum, gcnt, mesh,
                                             axis_name)
            n_islands *= mesh.axis_size(axis_name)
            if tel.probe is not None or tel._run_probes:
                seen = _gather_demes(pops, mesh, axis_name)
        mstate = meter.inc(mstate, "epochs")
        mstate = meter.inc(mstate, "generations", freq)
        mstate = meter.inc(mstate, "migrants", mig_k * n_islands)
        mstate = meter.set(mstate, "best", gmax)
        mstate = meter.set(mstate, "mean", gsum / torch.clamp(gcnt, min=1.0))
        mstate = tel.apply_probe(mstate, pop=_flatten_demes(seen))
        return pops, mstate

    step = (plan.compile(instrumented, label="island_step")
            if plan is not None else instrumented)
    if mesh is None:
        step.told = lambda generator, pops, mstate: measure(
            migrate(generator, pops), mstate)
    return step


def _migrate_sharded(generator, pops: Population, k: int, selection,
                     mesh, axis_name: str) -> Population:
    """Ring migration of a rank's block of demes: demes shift emigrants
    locally, the last local deme's emigrants go to the next rank's first
    deme."""
    m = pops.valid.shape[0]
    w = _deme_wvalues(pops)
    emi_idx = torch.stack([selection(generator, w[d], k) for d in range(m)])
    group = mesh.group(axis_name)
    n, me = mesh.axis_size(axis_name), mesh.axis_index(axis_name)

    def shift(rows):
        with span("island/ppermute"):
            incoming = ring_permute(rows[-1], (me + 1) % n, (me - 1) % n, me,
                                    group)
        return torch.cat([incoming[None], rows[:-1]])

    return _deme_map(
        lambda a: _put_rows(a, emi_idx, shift(_take_rows(a, emi_idx))), pops)


def _reduce_stats(gmax, gsum, gcnt, mesh, axis_name: str):
    """The ranks' best/mean statistics all-reduced over ``axis_name``."""
    group = mesh.group(axis_name)
    with span("island/pmax"):
        if group is not None:
            import torch.distributed as dist
            gmax = gmax.clone()
            dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    with span("island/psum"):
        if group is not None:
            import torch.distributed as dist
            sums = torch.stack([gsum, gcnt])
            dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
            gsum, gcnt = sums[0], sums[1]
    return gmax, gsum, gcnt


def _gather_demes(pops: Population, mesh, axis_name: str) -> Population:
    """Every rank's block of demes, concatenated in rank order."""
    group = mesh.group(axis_name)
    if group is None:
        return pops
    from deap_tpu_torch.parallel.plan import _all_gather
    size = mesh.axis_size(axis_name)
    return _deme_map(lambda a: _all_gather(a, size, group), pops)
