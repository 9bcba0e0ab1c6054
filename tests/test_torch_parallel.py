"""The port's parallelism against the JAX package, in one process.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
makes; the port runs one process with no process group (a plan of
several shards is built here on a mesh object whose ranks exist only for
the layout rule, which reads shapes and nothing else). Every comparison
is bit for bit unless it says otherwise:

- ``parallel.__all__``; ``leaf_sharding``'s decision on a grid of shapes
  and mesh sizes, ``axis2`` included; ``describe()``;
- ``mig_ring``: the default ring, a ``migarray`` permutation,
  ``replacement=sel_worst`` and the bad ``migarray``'s ``ValueError``;
- one ``make_island_step`` epoch on the JAX step's own draws (aspirants
  and ``var_and_masks`` for each deme, split as the JAX step splits its
  keys, handed to the port's step), against the JAX step with no mesh and
  with ``plan=ShardingPlan.for_islands(8)``, meter rows included; the
  batched generation against a loop over the demes;
- ``genome_mesh`` / ``make_sharded_evaluator`` on one rank against the
  JAX evaluator on 8 genome shards (OneMax exact; ``mean`` and ``max``
  within rtol 1e-5 and 1e-6);
- ``initialize()`` as a no-op; ``sharding_fallback`` journaled once per
  (where, reason); a plan of one rank equal to no plan on every loop it
  takes; the format-3 per-shard layout; ``island_run`` killed and
  resumed.
"""

import functools
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import ops as jops
from deap_tpu import parallel as jpar
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.ops import selection as jsel
from deap_tpu.ops import variation as jvar
from deap_tpu.parallel import island as jisl
from deap_tpu.telemetry import RunTelemetry as JTelemetry
from deap_tpu_torch import algorithms, ops as tops
from deap_tpu_torch import parallel as tpar
from deap_tpu_torch.core.fitness import FitnessSpec as TSpec
from deap_tpu_torch.core.population import (Population, concat,
                                             init_population)
from deap_tpu_torch.core.toolbox import Toolbox as TToolbox
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.mo import emo
from deap_tpu_torch.parallel import island as tisl
from deap_tpu_torch.parallel import mesh as tmesh
from deap_tpu_torch.parallel import migration as tmig
from deap_tpu_torch.resilience import ResilientRun
from deap_tpu_torch.resilience.faultinject import (FaultPlan, InjectedCrash,
                                                   KillAt)
from deap_tpu_torch.support import checkpoint as cp
from deap_tpu_torch.support.stats import fitness_stats
from deap_tpu_torch.telemetry import RunJournal, RunTelemetry
from deap_tpu_torch.telemetry import report

CPU = "cpu"
CXPB, MUTPB, INDPB, TOURN = 0.5, 0.3, 0.1, 3
I, L, FREQ, MIG_K = 8, 16, 2, 2


def _jtb():
    tb = JToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    tb.register("mate", jops.cx_two_point)
    tb.register("mutate", jops.mut_flip_bit, indpb=INDPB)
    tb.register("select", jops.sel_tournament, tournsize=TOURN)
    return tb


def _ttb():
    tb = TToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", tops.cx_two_point)
    tb.register("mutate", tops.mut_flip_bit, indpb=INDPB)
    tb.register("select", tops.sel_tournament, tournsize=TOURN)
    return tb


def _to_port(jp) -> Population:
    return Population(genomes=torch.from_numpy(np.array(jp.genomes)),
                      fitness=torch.from_numpy(np.array(jp.fitness)),
                      valid=torch.from_numpy(np.array(jp.valid)),
                      spec=TSpec(jp.spec.weights))


def _bitwise(got, want, what=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.tobytes() == want.astype(got.dtype).tobytes(), what


def _same_pop(got: Population, want):
    for name in ("genomes", "fitness", "valid"):
        _bitwise(getattr(got, name), getattr(want, name), name)


@functools.lru_cache(maxsize=None)
def _jax_demes(S, seed=0):
    """Evaluated stacked JAX demes (one epoch in), made once a size."""
    jp = jisl.island_init(jax.random.key(seed), I, S,
                          jops.bernoulli_genome(L), JSpec((1.0,)))
    return jisl.make_island_step(_jtb(), CXPB, MUTPB, FREQ, MIG_K)(
        jax.random.key(seed + 1), jp)


def _fake_plan(shape, names, axis, axis2=None):
    """A plan over ``prod(shape)`` shards for the layout rule alone."""
    n = int(np.prod(shape))
    mesh = tmesh.Mesh((torch.device(CPU),) * n, tuple(names), tuple(shape))
    return tpar.ShardingPlan(mesh, axis=axis, axis2=axis2)


# ---------------------------------------------------------- the surface ----

def test_all_matches_the_jax_package():
    assert tpar.__all__ == jpar.__all__
    for name in tpar.__all__:
        assert callable(getattr(tpar, name)) or name == "IslandState"


LEAF_SHAPES = [(), (0,), (1,), (7,), (8,), (16,), (6, 6), (16, 4), (16, 3),
               (24, 8, 3), (32, 2, 2), (12, 5)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_leaf_sharding_matches_jax(n):
    jplan = jpar.ShardingPlan.for_population(n, donate=False)
    tplan = _fake_plan((n,), ("pop",), "pop")
    for shape in LEAF_SHAPES:
        want = tuple(jplan.leaf_sharding(jnp.zeros(shape)).spec)
        assert tplan.leaf_sharding(torch.zeros(shape)) == want, shape
    assert tplan.leaf_sharding(make_generator(0, CPU)) == tuple(
        jplan.leaf_sharding(jax.random.key(0)).spec) == ()
    assert tplan.leaf_sharding(3.0) == tuple(
        jplan.leaf_sharding(3.0).spec) == ()


@pytest.mark.parametrize("runs", [1, 2, 4, 8])
def test_leaf_sharding_axis2_matches_jax(runs):
    jplan = jpar.ShardingPlan.for_island_runs(runs, 8, donate=False)
    tplan = _fake_plan((runs, 8 // runs), ("run", "island"), "run",
                       "island")
    assert (tplan.n_shards, tplan.n_shards2) == (jplan.n_shards,
                                                 jplan.n_shards2)
    for shape in LEAF_SHAPES:
        want = tuple(jplan.leaf_sharding(jnp.zeros(shape)).spec)
        assert tplan.leaf_sharding(torch.zeros(shape)) == want, shape
    assert tplan.describe() == jplan.describe()


def test_describe_repr_and_specs_match_jax():
    jplan = jpar.ShardingPlan.for_islands(8, donate=False)
    tplan = _fake_plan((8,), ("island",), "island")
    assert tplan.describe() == jplan.describe()
    assert set(tplan.describe()) == {"axes", "shape", "axis", "axis2",
                                     "n_devices"}
    assert tplan.spec("island") == tuple(jplan.spec("island"))
    assert tplan.replicated == tuple(jplan.replicated.spec)
    assert tplan.row_sharding == tuple(jplan.row_sharding.spec)
    assert "axis='island'" in repr(tplan) and "mode='pjit'" in repr(tplan)
    shardings = tplan.tree_shardings({"a": torch.zeros(16, 2),
                                      "b": torch.zeros(3)})
    assert shardings == {"a": ("island",), "b": ()}


def test_one_rank_plan_places_fresh_and_compiles_to_the_seam():
    plan = tpar.ShardingPlan.for_population(device=CPU)
    assert plan.n_shards == 1 and plan.rank == 0 and plan.mode == "pjit"
    x = torch.arange(8.0)
    placed = plan.place({"x": x, "n": 3})
    assert placed["n"] == 3 and torch.equal(placed["x"], x)
    assert placed["x"].data_ptr() != x.data_ptr()
    assert plan.place(x, fresh=False) is x
    assert plan.rows(8) == (0, 8) and not plan.is_split(8)
    f = plan.compile(lambda a: a + 1, donate_argnums=(0,), label="t")
    assert f.label == "plan/t" and torch.equal(f(x), x + 1)
    with pytest.raises(ValueError, match="axis"):
        tpar.ShardingPlan(plan.mesh, axis="island")


def test_fake_plan_rows_split_blocks():
    plan = _fake_plan((4,), ("pop",), "pop")
    assert plan.rows(16) == (0, 4) and plan.rows(18) == (0, 18)
    assert plan.is_split(16) and not plan.is_split(6)


# ----------------------------------------------------------- migration ----

@pytest.mark.parametrize("topology", ["ring", "migarray", "sel_worst"])
def test_mig_ring_matches_jax(topology):
    jp = _jax_demes(10)
    kw_j, kw_t = {}, {}
    if topology == "migarray":
        kw_j = kw_t = {"migarray": [3, 0, 5, 1, 7, 2, 4, 6]}
    elif topology == "sel_worst":
        kw_j, kw_t = ({"replacement": jops.sel_worst},
                      {"replacement": tops.sel_worst})
    want = jpar.mig_ring(jax.random.key(3), jp, 3, **kw_j)
    got = tpar.mig_ring(None, _to_port(jp), 3, **kw_t)
    _same_pop(got, want)
    assert tpar.migRing is tpar.mig_ring


def test_bad_migarray_raises_as_the_jax_package():
    jp = _jax_demes(6)
    bad = [0, 0, 1, 2, 3, 4, 5, 6]
    with pytest.raises(ValueError, match="permutation") as jerr:
        jpar.mig_ring(jax.random.key(0), jp, 2, migarray=bad)
    with pytest.raises(ValueError, match="permutation") as terr:
        tpar.mig_ring(None, _to_port(jp), 2, migarray=bad)
    assert str(terr.value) == str(jerr.value)


def test_mig_ring_collective_on_one_rank_is_the_local_ring():
    jp = _jax_demes(6)
    pops = _to_port(jp)
    deme = Population(genomes=pops.genomes[0], fitness=pops.fitness[0],
                      valid=pops.valid[0], spec=pops.spec)
    got = tpar.mig_ring_collective(None, deme, 2, "island")
    one = pops.replace(genomes=pops.genomes[:1], fitness=pops.fitness[:1],
                       valid=pops.valid[:1])
    want = tpar.mig_ring(None, one, 2)
    for name in ("genomes", "fitness", "valid"):
        assert torch.equal(getattr(got, name), getattr(want, name)[0])
    with pytest.raises(ValueError, match="permutation"):
        tpar.mig_ring_collective(None, deme, 2, "island", migarray=[1])


# ------------------------------------------------------------- islands ----

def _jax_epoch_draws(key, S):
    """The JAX step's draws of one epoch, as the port's ``island_draws``
    returns them, one generation at a time."""
    k_gen, _ = jax.random.split(key)
    vplan = jvar.resolve_plan(_jtb())
    out = []
    for k in jax.random.split(k_gen, FREQ):
        asp, masks = [], []
        for kk in jax.random.split(k, I):
            k_sel, k_var = jax.random.split(kk)
            asp.append(np.array(jsel.tournament_aspirants(k_sel, S, S,
                                                          TOURN)))
            masks.append(jvar.var_and_masks(k_var, S, L, CXPB, MUTPB, vplan,
                                            jnp.bool_))
        stacked = tuple(
            None if masks[0][j] is None else
            torch.from_numpy(np.stack([np.array(m[j]) for m in masks]))
            for j in range(6))
        out.append((torch.from_numpy(np.stack(asp)).long(), stacked))
    return out


@pytest.mark.parametrize("path", ["no_mesh", "plan"])
@pytest.mark.parametrize("S", [6, 5])
def test_island_epoch_on_injected_draws_matches_jax(monkeypatch, tmp_path,
                                                     path, S):
    jp = _jax_demes(S)
    key = jax.random.key(11)
    jplan = (jpar.ShardingPlan.for_islands(8, donate=False)
             if path == "plan" else None)
    tplan = tpar.ShardingPlan.for_islands(device=CPU) \
        if path == "plan" else None
    with JTelemetry(str(tmp_path / "j.jsonl")) as jtel:
        jstep = jisl.make_island_step(_jtb(), CXPB, MUTPB, FREQ, MIG_K,
                                      telemetry=jtel, plan=jplan)
        want, jm = jstep(key, jp, jtel.meter.init())
        jrow = jtel.meter.row(jm)
    draws = iter(_jax_epoch_draws(key, S))
    monkeypatch.setattr(tisl, "island_draws", lambda *a, **k: next(draws))
    with RunTelemetry(str(tmp_path / "t.jsonl")) as ttel:
        tstep = tpar.make_island_step(_ttb(), CXPB, MUTPB, FREQ, MIG_K,
                                      telemetry=ttel, plan=tplan)
        got, tm = tstep(None, _to_port(jp), ttel.meter.init(device=CPU))
        trow = ttel.meter.row(tm)
    _same_pop(got, want)
    for name in ("epochs", "generations", "migrants", "best", "mean"):
        assert trow[name] == jrow[name], name
    # and with no telemetry, the same demes
    draws = iter(_jax_epoch_draws(key, S))
    bare = tpar.make_island_step(_ttb(), CXPB, MUTPB, FREQ, MIG_K,
                                 plan=tplan)(None, _to_port(jp))
    _same_pop(bare, want)


@pytest.mark.parametrize("S", [6, 5])
def test_batched_generation_equals_a_loop_over_demes(S):
    pops = _to_port(_jax_demes(S))
    vplan = tops.variation.resolve_plan(_ttb())
    g = make_generator(3, CPU)
    asp, masks = tisl.island_draws(g, I, S, L, TOURN, CXPB, MUTPB, vplan,
                                   torch.bool)
    whole = tisl.island_generation(pops, asp, masks, _ttb(), vplan.mut_kind,
                                   "plain")
    kernel = tisl.island_generation(pops, asp, masks, _ttb(), vplan.mut_kind,
                                    "kernel")
    for d in range(I):
        one = tisl._slice_demes(pops, d, d + 1)
        got = tisl.island_generation(
            one, asp[d:d + 1], tuple(None if m is None else m[d:d + 1]
                                     for m in masks), _ttb(),
            vplan.mut_kind, "plain")
        for name in ("genomes", "fitness", "valid"):
            assert torch.equal(getattr(got, name)[0],
                               getattr(whole, name)[d])
    for name in ("genomes", "fitness", "valid"):
        assert torch.equal(getattr(kernel, name), getattr(whole, name))
    if S % 2:  # the odd trailing row never mates
        assert not masks[0][:, S - 1].any()


def test_island_paths_agree_and_refuse_both_mesh_and_plan():
    pops = tpar.island_init(make_generator(0, CPU), I, 6,
                            tops.bernoulli_genome(L), TSpec((1.0,)),
                            device=CPU)
    assert pops.genomes.shape == (I, 6, L)
    mesh = tpar.population_mesh(axis_names=("island",), device=CPU)
    plan = tpar.ShardingPlan.for_islands(device=CPU)
    outs = []
    for kw in ({}, {"mesh": mesh}, {"plan": plan}):
        g = make_generator(1, CPU)
        step = tpar.make_island_step(_ttb(), CXPB, MUTPB, FREQ, MIG_K, **kw)
        p = pops
        for _ in range(3):
            p = step(g, p)
        outs.append((p, g.get_state()))
    for p, state in outs[1:]:
        _same_pop(p, outs[0][0])
        assert torch.equal(state, outs[0][1])
    with pytest.raises(ValueError, match="not both"):
        tpar.make_island_step(_ttb(), CXPB, MUTPB, FREQ, MIG_K, mesh=mesh,
                              plan=plan)
    with pytest.raises(ValueError, match="requires telemetry"):
        tpar.make_island_step(_ttb(), CXPB, MUTPB, FREQ, MIG_K,
                              probes=(object(),))


def _per_deme_epoch(generator, pops, tb, freq, mig_k, fused):
    """One island epoch deme by deme: select, ``var_and(fused=...)``,
    evaluate, then the ring (the per-deme pass's definition)."""
    for _ in range(freq):
        demes = []
        for d in range(pops.valid.shape[0]):
            deme = tisl._slice_demes(pops, d, d + 1)
            deme = tisl._flatten_demes(deme)
            idx = tb.select(generator, deme.wvalues, deme.size)
            off = algorithms.var_and(generator, deme, tb, CXPB, MUTPB,
                                     fused=fused, sel_idx=idx)
            demes.append(algorithms.evaluate_invalid(off, tb.evaluate))
        pops = tisl._stack_demes(concat(demes), len(demes))
    return tmig.mig_ring(generator, pops, mig_k)


def test_island_per_deme_pass_for_other_toolboxes():
    """A selection the batched pass cannot take runs deme by deme, equal
    to the per-deme loop of the unfused composition."""
    tb = _ttb()
    tb.register("select", tops.sel_best)
    pops = tpar.island_init(make_generator(0, CPU), 4, 6,
                            tops.bernoulli_genome(L), TSpec((1.0,)),
                            device=CPU)
    g = make_generator(1, CPU)
    out = tpar.make_island_step(tb, CXPB, MUTPB, 1, 1)(g, pops)
    w = make_generator(1, CPU)
    want = _per_deme_epoch(w, pops, tb, 1, 1, fused=False)
    _same_pop(out, want)
    assert torch.equal(g.get_state(), w.get_state())
    assert out.genomes.shape == pops.genomes.shape and bool(out.valid.all())


@pytest.mark.parametrize("select", ["sel_random", "sel_roulette",
                                    "sel_worst"])
def test_island_per_deme_pass_takes_the_fused_plane(select, tmp_path):
    """The per-deme pass varies through ``var_and``'s fused plane (K1 on
    the card) and journals that dispatch once; it equals the unfused
    composition, generator end state included."""
    tb = _ttb()
    tb.register("select", getattr(tops, select))
    pops = tpar.island_init(make_generator(0, CPU), 3, 5,
                            tops.bernoulli_genome(L), TSpec((1.0,)),
                            device=CPU)
    pops = tisl._stack_demes(algorithms.evaluate_invalid(
        tisl._flatten_demes(pops), tb.evaluate), 3)
    path = str(tmp_path / "j.jsonl")
    g = make_generator(2, CPU)
    with RunJournal(path):
        got = tpar.make_island_step(tb, CXPB, MUTPB, FREQ, MIG_K)(g, pops)
    w = make_generator(2, CPU)
    want = _per_deme_epoch(w, pops, tb, FREQ, MIG_K, fused=False)
    _same_pop(got, want)
    assert torch.equal(g.get_state(), w.get_state())
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in rows if r["kind"] == "variation_dispatch"]
    assert [r["path"] for r in rows] == ["fused_plain"]


def test_island_run_killed_and_resumed_equals_the_whole_run(tmp_path):
    plan = tpar.ShardingPlan.for_islands(device=CPU)

    def run(directory, faults=None):
        step = tpar.make_island_step(_ttb(), CXPB, MUTPB, FREQ, MIG_K,
                                     plan=plan)
        pops = tpar.island_init(make_generator(0, CPU), I, 6,
                                tops.bernoulli_genome(L), TSpec((1.0,)),
                                device=CPU)
        g = make_generator(1, CPU)
        res = ResilientRun(str(directory), segment_len=2, fault_plan=faults,
                           plan=plan)
        return res.island_run(step, g, pops, 6, device=CPU), g

    want, gw = run(tmp_path / "whole")
    with pytest.raises(InjectedCrash):
        run(tmp_path / "cut", FaultPlan([KillAt(2, "after_save")]))
    got, gg = run(tmp_path / "cut")
    _same_pop(got, want)
    assert torch.equal(gg.get_state(), gw.get_state())


# --------------------------------------------------------- genome shard ----

def test_sharded_evaluator_on_one_rank_matches_jax():
    jmesh = jpar.genome_mesh(n_pop_shards=1, n_genome_shards=8)
    tmesh_ = tpar.genome_mesh(device=CPU)
    assert tmesh_.axis_names == ("pop", "genome") and tmesh_.shape == (1, 1)
    bits = np.array(jax.random.bernoulli(jax.random.key(2), 0.5, (64, 512)),
                    np.float32)
    normal = np.array(jax.random.normal(jax.random.key(4), (16, 128)))
    for data, jfn, tfn, combine, rtol in (
            (bits, lambda g: g.sum(-1), lambda g: g.sum(-1), "sum", 0),
            (normal, lambda g: g.mean(-1), lambda g: g.mean(-1), "mean",
             1e-5),
            (normal, lambda g: g.max(-1), lambda g: g.max(-1).values, "max",
             1e-6)):
        want = jpar.make_sharded_evaluator(jfn, jmesh, combine)(
            jpar.shard_genomes(jnp.asarray(data), jmesh))
        ev = tpar.make_sharded_evaluator(tfn, tmesh_, combine)
        got = ev(tpar.shard_genomes(torch.from_numpy(data), tmesh_))
        if rtol:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=rtol)
        else:
            _bitwise(got, want, combine)
    plan = tpar.ShardingPlan(tmesh_, axis="pop")
    ev = tpar.make_sharded_evaluator(lambda g: g.sum(-1), plan)
    assert torch.equal(ev(tpar.shard_genomes(torch.from_numpy(bits), plan)),
                       torch.from_numpy(bits).sum(-1))
    with pytest.raises(ValueError):
        tpar.make_sharded_evaluator(lambda g: g, tmesh_, "median")
    with pytest.raises(ValueError, match="devices are available"):
        tpar.genome_mesh(2, 2, device=CPU)


# ----------------------------------------------------- multi-process ----

def test_initialize_without_a_cluster_is_a_no_op(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tpar.initialize() is None
    assert not torch.distributed.is_initialized()
    assert (tpar.process_count(), tpar.process_index()) == (1, 0)
    assert not tpar.is_distributed()
    mesh = tpar.global_population_mesh(device=CPU)
    assert mesh.shape == (1,) and mesh.device_mesh is None
    with pytest.raises(ValueError, match="initialize"):
        tpar.population_mesh(4, device=CPU)


def test_sharding_fallback_journals_once_per_where_and_reason(
        monkeypatch, tmp_path):
    monkeypatch.setattr(tmesh, "_FALLBACK_SEEN", set())
    path = str(tmp_path / "j.jsonl")
    with RunJournal(path):
        tpar.sharding_fallback("a", "r1", n=1)
        tpar.sharding_fallback("a", "r1", n=2)
        tpar.sharding_fallback("a", "r2")
        tpar.sharding_fallback("b", "r1")
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    rows = [r for r in rows if r["kind"] == "sharding_fallback"]
    assert [(r["where"], r["reason"]) for r in rows] == [
        ("a", "r1"), ("a", "r2"), ("b", "r1")]
    assert rows[0]["n"] == 1 and rows[0]["mode"] == tpar.sharding_mode()
    text = report.render_report(path)
    assert "Sharding fallbacks" in text and "a: r1" in text


# ---------------------------------------------------- plan on the loops ----

def _pop(n, seed=0):
    return init_population(make_generator(seed, CPU), n,
                           tops.bernoulli_genome(L), TSpec((1.0,)),
                           device=CPU)


@pytest.mark.parametrize("loop", ["ea_simple", "mu_plus", "mu_comma"])
def test_one_rank_plan_equals_no_plan(loop):
    plan = tpar.ShardingPlan.for_population(device=CPU)
    outs = []
    for p in (None, plan):
        g = make_generator(1, CPU)
        if loop == "ea_simple":
            out = algorithms.ea_simple(g, _pop(20), _ttb(), CXPB, MUTPB, 3,
                                       stats=fitness_stats(),
                                       halloffame_size=2, plan=p,
                                       device=CPU)
        else:
            fn = (algorithms.ea_mu_plus_lambda if loop == "mu_plus"
                  else algorithms.ea_mu_comma_lambda)
            out = fn(g, _pop(12), _ttb(), 12, 18, CXPB, MUTPB, 3,
                     stats=fitness_stats(), halloffame_size=2, plan=p,
                     device=CPU)
        outs.append(out)
    (a, la, ha), (b, lb, hb) = outs
    for name in ("genomes", "fitness", "valid"):
        assert torch.equal(getattr(a, name), getattr(b, name))
    assert torch.equal(ha.fitness, hb.fitness)
    assert [r["max"] for r in la] == [r["max"] for r in lb]


def test_var_and_rows_are_the_whole_plane_cut():
    pop = algorithms.evaluate_invalid(_pop(10), _ttb().evaluate)
    idx = torch.randint(0, 10, (10,), generator=make_generator(2, CPU))
    for fused in ("plain", "kernel", False):
        whole = algorithms.var_and(make_generator(3, CPU), pop, _ttb(),
                                   CXPB, MUTPB, fused=fused, sel_idx=idx)
        for rows in ((0, 4), (3, 8), (8, 10)):
            part = algorithms.var_and(make_generator(3, CPU), pop, _ttb(),
                                      CXPB, MUTPB, fused=fused, sel_idx=idx,
                                      rows=rows)
            sl = slice(*rows)
            assert torch.equal(part.genomes, whole.genomes[sl])
            assert torch.equal(part.valid, whole.valid[sl])
            assert torch.equal(part.fitness, whole.fitness[sl])
        whole = algorithms.var_or(make_generator(4, CPU), pop, _ttb(), 12,
                                  CXPB, MUTPB, fused=fused)
        part = algorithms.var_or(make_generator(4, CPU), pop, _ttb(), 12,
                                 CXPB, MUTPB, fused=fused, rows=(6, 12))
        assert torch.equal(part.genomes, whole.genomes[6:])


def test_nd_rank_with_a_plan_equals_without():
    g = make_generator(5, CPU)
    w = -torch.rand((40, 3), generator=g)
    plan = tpar.ShardingPlan.for_population(device=CPU)
    for impl in ("auto", "matrix", "tiled", "dc"):
        assert torch.equal(emo.nd_rank(w, impl=impl, plan=plan),
                           emo.nd_rank(w, impl=impl))


# ---------------------------------------------------------- format 3 ----

def test_format3_stores_row_sharded_leaves_per_shard(tmp_path):
    plan = _fake_plan((4,), ("pop",), "pop")
    bt = torch.rand(8, 8).t()  # column-major: strides come back
    state = {"pop": _pop(16), "odd": torch.arange(6), "g": make_generator(0,
                                                                          CPU),
             "bt": bt, "n": 3}
    path = str(tmp_path / "ck.pkl")
    cp.save_state(path, state, meta={"x": 1}, plan=plan)
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["format_version"] == 3
    assert payload["meta"]["mesh"] == plan.describe()
    leaves = [pickle.loads(b) for b in payload["leaves"]]
    sharded = [x for x in leaves if isinstance(x, dict)
               and "__sharded__" in x]
    assert len(sharded) == 4  # genomes, fitness, valid, bt
    assert all(len(x["shards"]) == 4 for x in sharded)
    back = cp.restore_state(path, device=CPU)
    for name in ("genomes", "fitness", "valid"):
        assert torch.equal(getattr(back["pop"], name),
                           getattr(state["pop"], name))
    assert torch.equal(back["odd"], state["odd"]) and back["n"] == 3
    assert torch.equal(back["bt"], bt) and back["bt"].stride() == bt.stride()
    assert torch.equal(back["g"].get_state(), state["g"].get_state())
    # a plan of one rank writes whole leaves
    cp.save_state(path, state, plan=tpar.ShardingPlan.for_population(
        device=CPU))
    with open(path, "rb") as f:
        assert b"__sharded__" not in f.read()
    # a format-2 file (no sharded leaf) still restores
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["format_version"] = 2
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    back = cp.restore_state(path, device=CPU)
    assert torch.equal(back["pop"].genomes, state["pop"].genomes)
