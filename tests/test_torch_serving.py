"""The port's run axis, tenants and scheduler, on the CPU.

- **Per-lane bit identity with the port's solo loops**: ``ea_simple``,
  (μ + λ), (μ, λ) and the CMA-ES ask-tell loop (``'lapack'`` and
  ``'jacobi'``) with mixed ``ngen`` and per-lane hyperparameters in one
  batch, statistics and a hall of fame: populations, logbooks, halls of
  fame and meter/probe rows equal the solo run from the lane's starting
  generator state, and the caller's generators are never advanced.
- ``pack_fresh`` equal to ``lane_init``; eviction/resume and round-robin
  over two buckets in the scheduler; ``ResilientRun.multirun`` segmented,
  killed and resumed.
- **Against the JAX package**: one batched ``ea_simple`` segment of 3
  lanes on the JAX lanes' own draws (each lane's aspirants and
  ``var_and_masks`` from its JAX key): populations, records and halls of
  fame bitwise, ``std`` within 1e-5·max|fitness| (XLA's summation order
  is its own); ``pad_pow2`` over a range; ``bucket_key``'s separations;
  the scheduler's journal row kinds and keys for the same jobs.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import ops as jops
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import init_population as j_init_population
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.ops import selection as jsel
from deap_tpu.ops import variation as jvar
from deap_tpu.serving import Job as JJob
from deap_tpu.serving import MultiRunEngine as JEngine
from deap_tpu.serving import Scheduler as JScheduler
from deap_tpu.serving import bucket_key as j_bucket_key
from deap_tpu.serving import pad_pow2 as j_pad_pow2
from deap_tpu.support.stats import fitness_stats as j_fitness_stats
from deap_tpu.telemetry import read_journal as j_read_journal
from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, convert, ops
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.resilience import ResilientRun
from deap_tpu_torch.resilience.faultinject import (FaultPlan, InjectedCrash,
                                                   KillAt)
from deap_tpu_torch.serving import (Job, MultiRunEngine, Scheduler,
                                    bucket_key, multirun, pad_pow2, prewarm)
from deap_tpu_torch.serving.wire import result_digest
from deap_tpu_torch.strategies import cma
from deap_tpu_torch.support.checkpoint import tree_flatten
from deap_tpu_torch.support.stats import Statistics, fitness_stats, max0, mean0
from deap_tpu_torch.telemetry import RunTelemetry, read_journal
from deap_tpu_torch.telemetry.probes import (DiversityProbe, FitnessProbe,
                                             HealthMonitor)

CPU = "cpu"
# the module (the package exports the function of the same name)
tmr = importlib.import_module("deap_tpu_torch.serving.multirun")
HYPER = [{"cxpb": 0.5, "mutpb": 0.2}, {"cxpb": 0.7, "mutpb": 0.1},
         {"cxpb": 0.3, "mutpb": 0.3}]


def _toolbox():
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


def _pops(n_runs=3, n=24, length=16):
    return [init_population(make_generator(s, CPU), n,
                            ops.bernoulli_genome(length),
                            FitnessSpec((1.0,)), device=CPU)
            for s in range(n_runs)]


def _gens(n_runs=3, base=100):
    return [make_generator(base + s, CPU) for s in range(n_runs)]


def assert_same(a, b):
    """Equal trees: the same structure, every tensor bitwise."""
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb and len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert torch.equal(x, y) or (x.dtype.is_floating_point and
                                         torch.equal(x.view(torch.int32),
                                                     y.view(torch.int32)))
        else:
            assert x == y


def assert_logbooks(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert set(ra) == set(rb)
        for k in ra:
            assert_same(ra[k], rb[k])


def _stats():
    st = Statistics()
    st.register("max", max0)
    st.register("mean", mean0)
    return st


# ------------------------------------------- batched-vs-solo parity ----

@pytest.mark.parametrize("family", ["ea_simple", "ea_mu_plus_lambda",
                                    "ea_mu_comma_lambda"])
def test_population_families_lane_bit_identity(family):
    """Mixed ngen and per-lane cxpb/mutpb in one batch, statistics and a
    hall of fame, three segments of 3: every lane equals its solo loop,
    and the callers' generators are left untouched."""
    tb, pops = _toolbox(), _pops()
    gens = _gens(base=40)
    before = [g.get_state() for g in gens]
    ngen = [7, 5, 7]
    kw = {} if family == "ea_simple" else {"mu": 24, "lambda_": 30}
    res = multirun(family, tb, gens, pops, ngen, HYPER, segment_len=3,
                   stats=_stats(), halloffame_size=4, device=CPU, **kw)
    for g, s in zip(gens, before):
        assert torch.equal(g.get_state(), s)
    solo = getattr(algorithms, family)
    for r in range(3):
        args = (() if family == "ea_simple" else (24, 30))
        sp, slb, sh = solo(make_generator(40 + r, CPU), pops[r], tb, *args,
                           HYPER[r]["cxpb"], HYPER[r]["mutpb"], ngen[r],
                           stats=_stats(), halloffame_size=4, device=CPU)
        bp, blb, bh = res[r]
        assert_same(sp, bp)
        assert_same(sh, bh)
        assert_logbooks(slb, blb)


def _rastrigin_toolbox():
    from deap_tpu_torch import benchmarks
    tb = Toolbox()
    tb.register("evaluate", benchmarks.rastrigin)
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=0.3, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


@pytest.mark.parametrize("family", ["ea_simple", "ea_mu_plus_lambda",
                                    "ea_mu_comma_lambda"])
def test_float_lanes_bit_identity(family):
    """A float32 genome under a float-valued evaluate (Rastrigin through
    the fused two-point/Gaussian plane): each lane's rows are evaluated
    in the lane's own shape, and every lane equals its solo loop."""
    tb = _rastrigin_toolbox()
    pops = [init_population(make_generator(s, CPU), 24,
                            ops.uniform_genome(16, -5.12, 5.12),
                            FitnessSpec((-1.0,)), device=CPU)
            for s in range(3)]
    ngen = [6, 4, 6]
    kw = {} if family == "ea_simple" else {"mu": 24, "lambda_": 30}
    res = multirun(family, tb, _gens(base=70), pops, ngen, HYPER,
                   segment_len=4, stats=_stats(), halloffame_size=3,
                   device=CPU, **kw)
    solo = getattr(algorithms, family)
    for r in range(3):
        args = (() if family == "ea_simple" else (24, 30))
        sp, slb, sh = solo(make_generator(70 + r, CPU), pops[r], tb, *args,
                           HYPER[r]["cxpb"], HYPER[r]["mutpb"], ngen[r],
                           stats=_stats(), halloffame_size=3, device=CPU)
        bp, blb, bh = res[r]
        assert_same(sp, bp)
        assert_same(sh, bh)
        assert_logbooks(slb, blb)


@pytest.mark.parametrize("integer", [True, False])
def test_evaluate_lanes_stacks_only_integer_fitness(integer):
    """Integer-valued fitness is exact at any row count: the first lane
    alone, then every other lane in one call. Float-valued fitness is
    evaluated lane by lane, each in its solo shape. Either way each
    lane's values are those of evaluating its rows alone."""
    calls = []

    def evaluate(g):
        calls.append(g.shape[0])
        if integer:
            return g.sum(-1)
        return (g.to(torch.float32) * 0.1).sum(-1)

    off = tmr.concat(_pops(n_runs=4, n=6, length=8))
    lanes = tmr.evaluate_lanes(off, evaluate, 6)
    assert calls == ([6, 18] if integer else [6, 6, 6, 6])
    for r, lane in enumerate(lanes):
        want = algorithms.evaluate_invalid(tmr._rows(off, 6 * r, 6 * r + 6),
                                           evaluate)
        assert_same(lane, want)


@pytest.mark.parametrize("impl", ["lapack", "jacobi"])
def test_cma_lanes_bit_identity(impl):
    """The ask-tell family: per-lane sigma through the initial state,
    mixed ngen; the whole strategy state, logbook and hall of fame equal
    the solo loop's. With 'jacobi' one J1 call decomposes every lane's
    matrix."""
    strat = cma.Strategy(centroid=[3.0] * 6, sigma=0.5, lambda_=12,
                         eigh_impl=impl, device=CPU)
    tb = Toolbox()
    tb.register("evaluate", lambda g: (g ** 2).sum(-1))
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    states = [strat.initial_state(sigma=s) for s in (0.3, 0.5, 0.9)]
    ngens = [8, 5, 3]
    res = multirun("ea_generate_update", tb, _gens(base=7), states, ngens,
                   segment_len=3, spec=strat.spec,
                   state_template=states[0], halloffame_size=2,
                   stats=fitness_stats(), device=CPU)
    for r in range(3):
        st, slb, sh = algorithms.ea_generate_update(
            make_generator(7 + r, CPU), states[r], tb, ngens[r],
            spec=strat.spec, halloffame_size=2, stats=fitness_stats(),
            device=CPU)
        bt, blb, bh = res[r]
        assert_same(st, bt)
        assert_same(sh, bh)
        assert_logbooks(slb, blb)


def test_lapack_bucket_journals_the_eigh_hint(tmp_path):
    strat = cma.Strategy(centroid=[1.0] * 3, sigma=0.5, lambda_=4,
                         device=CPU)
    tb = Toolbox()
    tb.register("evaluate", lambda g: (g ** 2).sum(-1))
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    with RunTelemetry(str(tmp_path / "j.jsonl")):
        from deap_tpu_torch.telemetry import RunJournal
        with RunJournal(str(tmp_path / "b.jsonl")):
            MultiRunEngine("ea_generate_update", tb, spec=strat.spec,
                           state_template=strat.initial_state(),
                           device=CPU)
    rows = read_journal(str(tmp_path / "b.jsonl"))
    assert [r["kind"] for r in rows].count("serving_eigh_hint") == 1


def test_solo_fallback_for_non_tournament_selection():
    """A selection the batched pass cannot take steps lane by lane
    through the solo step: the same bits."""
    tb = _toolbox()
    tb.register("select", ops.sel_random)
    pops, gens = _pops(2), _gens(2, base=3)
    res = multirun("ea_simple", tb, gens, pops, 4, HYPER[0], device=CPU)
    for r in range(2):
        sp, slb, _ = algorithms.ea_simple(make_generator(3 + r, CPU),
                                          pops[r], tb, 0.5, 0.2, 4,
                                          device=CPU)
        assert_same(sp, res[r][0])
        assert_logbooks(slb, res[r][1])


@pytest.mark.parametrize("family", ["ea_simple", "ea_mu_plus_lambda"])
def test_pack_fresh_matches_lane_init(family):
    tb, pops = _toolbox(), _pops()
    kw = {} if family == "ea_simple" else {"mu": 24, "lambda_": 24}
    eng1 = MultiRunEngine(family, tb, stats=fitness_stats(),
                          halloffame_size=3, device=CPU, **kw)
    b1 = eng1.pack([eng1.lane_init(g, p, 5, HYPER[0])
                    for g, p in zip(_gens(base=80), pops)])
    eng2 = MultiRunEngine(family, tb, stats=fitness_stats(),
                          halloffame_size=3, device=CPU, **kw)
    b2 = eng2.pack_fresh(_gens(base=80), pops, 5, HYPER[0], n_lanes=4)
    for i in range(3):
        assert_same(eng1.unpack(b1, i), eng2.unpack(b2, i))


def test_batched_meter_probe_rows_match_solo(tmp_path):
    """Per-lane meter states (built-ins, DiversityProbe, FitnessProbe)
    decode to rows IDENTICAL to each solo run's journal rows."""
    tb, pops = _toolbox(), _pops()
    NGEN = 6
    probes = lambda: (DiversityProbe(sample=16), FitnessProbe())
    solo_rows = []
    for r in range(3):
        path = str(tmp_path / f"solo{r}.jsonl")
        with RunTelemetry(path) as tel:
            algorithms.ea_simple(make_generator(100 + r, CPU), pops[r], tb,
                                 0.5, 0.2, NGEN, telemetry=tel,
                                 probes=probes(), device=CPU)
        solo_rows.append([e for e in read_journal(path)
                          if e.get("kind") == "meter"])
    with RunTelemetry(str(tmp_path / "batch.jsonl")) as tel:
        eng = MultiRunEngine("ea_simple", tb, telemetry=tel,
                             probes=probes(), device=CPU)
        lanes = [eng.lane_init(g, p, NGEN, {"cxpb": 0.5, "mutpb": 0.2})
                 for g, p in zip(_gens(), pops)]
        batch = eng.pack(lanes)
        segs = []
        while not eng.done(batch).all():
            batch, seg = eng.advance(batch, 4)
            segs.append(seg)
        for r in range(3):
            rows = eng.lane_meter_rows(segs, r, lane=lanes[r])
            srows = solo_rows[r]
            assert len(rows) == len(srows) == NGEN + 1
            for got, want in zip(rows, srows):
                want = {k: v for k, v in want.items()
                        if k not in ("kind", "t")}
                assert got == want, (r, got.get("gen"))


def test_multirun_rejects_streaming_telemetry(tmp_path):
    with RunTelemetry(str(tmp_path / "j.jsonl"), stream=True) as tel:
        with pytest.raises(ValueError, match="stream"):
            MultiRunEngine("ea_simple", _toolbox(), telemetry=tel,
                           device=CPU)


def test_lane_generator_lives_on_the_bucket_device():
    eng = MultiRunEngine("ea_simple", _toolbox(), device=CPU)
    with pytest.raises(ValueError, match="ngen"):
        eng.lane_init(make_generator(0, CPU), _pops(1)[0], 0, HYPER[0])
    with pytest.raises(ValueError, match="hyper"):
        eng.lane_init(make_generator(0, CPU), _pops(1)[0], 3, {})


# ------------------------------------------ against the JAX package ----

def _jax_toolbox():
    tb = JToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    tb.register("mate", jops.cx_two_point)
    tb.register("mutate", jops.mut_flip_bit, indpb=0.1)
    tb.register("select", jops.sel_tournament, tournsize=3)
    return tb


def test_batched_segment_on_jax_draws_matches_jax_engine(monkeypatch):
    """3 lanes of 23 (odd) rows, one generation through the JAX engine;
    the port's engine on each JAX lane's own draws (aspirants and
    var_and_masks from the lane's key) gives the same populations,
    records and halls of fame."""
    n, L, R = 23, 16, 3
    jtb = _jax_toolbox()
    jpops = [j_init_population(jax.random.key(s), n,
                               jops.bernoulli_genome(L), JSpec((1.0,)))
             for s in range(R)]
    keys = [jax.random.key(50 + s) for s in range(R)]
    ngens = [2, 3, 2]
    jeng = JEngine("ea_simple", jtb, stats=j_fitness_stats(),
                   halloffame_size=3)
    jlanes = [jeng.lane_init(k, p, g, h)
              for k, p, g, h in zip(keys, jpops, ngens, HYPER)]
    jbatch = jeng.pack(jlanes, n_lanes=4, horizon=4)
    jbatch, jseg = jeng.advance(jbatch, 1)

    plan = jvar.resolve_plan(jtb)
    draws = []
    for r in range(R):
        key = jax.random.split(keys[r], ngens[r])[0]
        k_sel, k_var = jax.random.split(key)
        asp = np.array(jsel.tournament_aspirants(k_sel, n, n, 3))
        masks = jvar.var_and_masks(k_var, n, L, HYPER[r]["cxpb"],
                                   HYPER[r]["mutpb"], plan, jnp.bool_)
        draws.append((torch.from_numpy(asp).long(),
                      tuple(None if m is None else torch.from_numpy(
                          np.array(m)) for m in masks)))
    it = iter(draws)
    monkeypatch.setattr(tmr, "simple_lane_draws", lambda *a, **k: next(it))

    eng = MultiRunEngine("ea_simple", _toolbox(), stats=fitness_stats(),
                         halloffame_size=3, device=CPU)
    lanes = []
    for r in range(R):
        jl = jeng.unpack(jbatch, r)  # only the lane's gen-0 is used
        p0 = jlanes[r]["carry"][0]
        tpop = convert.population_from_arrays(p0.genomes, p0.fitness,
                                              p0.valid, (1.0,), device=CPU)
        lanes.append(eng.lane_init(make_generator(r, CPU), tpop, ngens[r],
                                   HYPER[r]))
    batch, seg = eng.advance(eng.pack(lanes), 1)
    for r in range(R):
        jl = jeng.unpack(jbatch, r)
        jpop, jhof = jl["carry"][0], jl["carry"][1]
        got = convert.population_to_arrays(eng.unpack(batch, r)["carry"]
                                           ["pop"])
        for name in ("genomes", "fitness", "valid"):
            assert np.asarray(got[name]).tobytes() == \
                np.asarray(getattr(jpop, name)).astype(
                    np.asarray(got[name]).dtype).tobytes(), (r, name)
        ghof = convert.hof_to_arrays(eng.unpack(batch, r)["carry"]["hof"])
        for name in ("genomes", "fitness", "filled"):
            assert np.array_equal(np.asarray(ghof[name]),
                                  np.asarray(getattr(jhof, name))), name
        jrec = jeng.lane_records([jseg], r)
        trec = eng.lane_records([seg], r)[0]
        assert int(trec["nevals"]) == int(jrec["nevals"][0])
        for k in ("avg", "min", "max"):
            assert trec[k].numpy().tobytes() == \
                np.asarray(jrec[k][0]).tobytes(), k
        np.testing.assert_allclose(trec["std"].numpy(),
                                   np.asarray(jrec["std"][0]), rtol=0,
                                   atol=1e-5 * L)


def test_pad_pow2_matches_jax():
    for n in range(1, 300):
        assert pad_pow2(n) == j_pad_pow2(n)
        assert pad_pow2(n, cap=64) == j_pad_pow2(n, cap=64)
    for bad in (0, -3):
        with pytest.raises(ValueError):
            pad_pow2(bad)


def test_bucket_key_separates_as_the_jax_one_does():
    """The same five variations separate (or not) in both packages; the
    generator's device joins the port's key."""
    tb, jtb = _toolbox(), _jax_toolbox()
    tpops = _pops(1) + [init_population(
        make_generator(9, CPU), 24, ops.bernoulli_genome(32),
        FitnessSpec((1.0,)), device=CPU)]
    jpops = [j_init_population(jax.random.key(0), 24,
                               jops.bernoulli_genome(16), JSpec((1.0,))),
             j_init_population(jax.random.key(9), 24,
                               jops.bernoulli_genome(32), JSpec((1.0,)))]

    def keys(make, pops):
        base = make(pops[0])
        return [make(pops[0]) == base, make(pops[1]) == base,
                make(pops[0], prog="q") == base,
                make(pops[0], fam="ea_mu_plus_lambda", mu=8,
                     lambda_=16) == base,
                make(pops[0], halloffame_size=2) == base]

    tk = keys(lambda pop, fam="ea_simple", prog="p", **kw: bucket_key(Job(
        tenant_id="x", family=fam, toolbox=tb,
        generator=make_generator(0, CPU), init=pop, ngen=5, program=prog,
        **kw)), tpops)
    jk = keys(lambda pop, fam="ea_simple", prog="p", **kw: j_bucket_key(
        JJob(tenant_id="x", family=fam, toolbox=jtb, key=jax.random.key(0),
             init=pop, ngen=5, program=prog, **kw)), jpops)
    assert tk == jk == [True, False, False, False, False]
    assert ("device", "cpu") in bucket_key(Job(
        tenant_id="x", family="ea_simple", toolbox=tb,
        generator=make_generator(0, CPU), init=tpops[0], ngen=5))[2]


LIFECYCLE = ("job_submitted", "tenant_admitted", "tenant_evicted",
             "tenant_resumed", "tenant_finished", "segment", "slo",
             "meter", "checkpoint")


def test_scheduler_journal_kinds_and_keys_match_jax(tmp_path):
    """The same 3 jobs (2 lanes, quantum 1, so tenants are evicted and
    resumed) through both schedulers journal the same lifecycle kinds,
    each with the same keys."""
    def jjobs():
        tb = _jax_toolbox()
        return [JJob(tenant_id=f"t{i}", family="ea_simple", toolbox=tb,
                     key=jax.random.key(100 + i),
                     init=j_init_population(jax.random.key(i), 16,
                                            jops.bernoulli_genome(12),
                                            JSpec((1.0,))),
                     ngen=4, hyper={"cxpb": 0.5, "mutpb": 0.2},
                     program="onemax") for i in range(3)]

    with JScheduler(str(tmp_path / "j"), max_lanes=2, segment_len=2,
                    fair_quantum=1) as js:
        for j in jjobs():
            js.submit(j)
        js.run()
    with Scheduler(str(tmp_path / "t"), max_lanes=2, segment_len=2,
                   fair_quantum=1) as ts:
        for j in _jobs(_toolbox(), n=3, ngen=4):
            ts.submit(j)
        ts.run()
    jrows = j_read_journal(str(tmp_path / "j" / "journal.jsonl"))
    trows = read_journal(str(tmp_path / "t" / "journal.jsonl"))

    def shape(rows):
        out = {}
        for r in rows:
            if r.get("kind") in LIFECYCLE:
                out.setdefault(r["kind"], set()).update(
                    k for k in r if k not in ("t", "wall"))
        return out

    js_, ts_ = shape(jrows), shape(trows)
    assert set(js_) == set(ts_)
    for kind in js_:
        assert js_[kind] == ts_[kind], kind
    count = lambda rows, k: sum(r.get("kind") == k for r in rows)
    for kind in ("job_submitted", "tenant_admitted", "tenant_finished",
                 "tenant_evicted", "tenant_resumed", "meter"):
        assert count(jrows, kind) == count(trows, kind), kind


# ------------------------------------------------- scheduler ----

def _jobs(tb, n=4, ngen=5, **kw):
    return [Job(tenant_id=f"t{i}", family="ea_simple", toolbox=tb,
                generator=make_generator(100 + i, CPU),
                init=init_population(make_generator(i, CPU), 16,
                                     ops.bernoulli_genome(12),
                                     FitnessSpec((1.0,)), device=CPU),
                ngen=ngen, hyper={"cxpb": 0.5, "mutpb": 0.2},
                program="onemax", **kw) for i in range(n)]


def test_scheduler_eviction_resume_bit_identity(tmp_path):
    """Contention (4 tenants, 2 lanes, quantum 1) forces checkpoint
    eviction and resume; every tenant equals its solo run, the journal
    shows the swaps, every meter row carries its tenant id."""
    tb = _toolbox()
    jobs = _jobs(tb)
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=3,
                   fair_quantum=1) as sched:
        for j in jobs:
            sched.submit(j)
        results = sched.run()
    assert set(results) == {j.tenant_id for j in jobs}
    for i, j in enumerate(jobs):
        solo = algorithms.ea_simple(make_generator(100 + i, CPU), j.init,
                                    tb, 0.5, 0.2, j.ngen, device=CPU)
        assert result_digest(solo) == result_digest(results[j.tenant_id])
    rows = read_journal(str(tmp_path / "journal.jsonl"))
    kinds = [e.get("kind") for e in rows]
    assert kinds.count("tenant_finished") == len(jobs)
    assert "tenant_evicted" in kinds and "tenant_resumed" in kinds
    meters = [e for e in rows if e.get("kind") == "meter"]
    assert meters and all("tenant_id" in e for e in meters)


def test_scheduler_health_early_stop_frees_slot(tmp_path):
    tb = Toolbox()
    tb.register("evaluate", lambda g: torch.zeros(g.shape[0]))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    jobs = _jobs(tb, n=2, ngen=9)
    jobs[0].health = HealthMonitor(stagnation_window=2,
                                   early_stop=("zero_improvement",))
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=3) as sched:
        for j in jobs:
            sched.submit(j)
        results = sched.run()
        stopped, other = sched.tenants["t0"], sched.tenants["t1"]
    assert stopped.status == "stopped"
    assert stopped.stopped_at is not None and stopped.stopped_at < 9
    assert other.status == "finished" and other.gen == 9
    assert len(results["t0"][1]) == stopped.stopped_at + 1


def test_scheduler_two_buckets_round_robin(tmp_path):
    """A GA bucket and a CMA-ES bucket share the scheduler round-robin;
    both finish bit for bit their solo runs."""
    tb = _toolbox()
    strat = cma.Strategy(centroid=[2.0] * 4, sigma=0.4, lambda_=8,
                         device=CPU)
    tbc = Toolbox()
    tbc.register("evaluate", lambda g: (g ** 2).sum(-1))
    tbc.register("generate", strat.generate)
    tbc.register("update", strat.update)
    ga = _jobs(tb, n=1, ngen=4)[0]
    cj = Job(tenant_id="cma0", family="ea_generate_update", toolbox=tbc,
             generator=make_generator(5, CPU),
             init=strat.initial_state(sigma=0.7), ngen=4, spec=strat.spec,
             program="sphere")
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=2) as sched:
        sched.submit(ga)
        sched.submit(cj)
        results = sched.run()
        assert len(sched.buckets) == 2
    solo = algorithms.ea_generate_update(make_generator(5, CPU), cj.init,
                                         tbc, 4, spec=strat.spec, device=CPU)
    assert result_digest(solo) == result_digest(results["cma0"])
    rows = read_journal(str(tmp_path / "journal.jsonl"))
    fams = [r["family"] for r in rows if r.get("kind") == "segment"]
    assert fams[:2] in (["ea_simple", "ea_generate_update"],
                        ["ea_generate_update", "ea_simple"])


def test_scheduler_prewarm_journals_per_bucket(tmp_path):
    jobs = _jobs(_toolbox(), n=2)
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=3) as sched:
        assert prewarm(sched, jobs) == 1  # one shared bucket
    pw = [e for e in read_journal(str(tmp_path / "journal.jsonl"))
          if e.get("kind") == "prewarm"]
    assert len(pw) == 1 and pw[0]["family"] == "ea_simple"
    assert pw[0]["lanes"] == 2


def test_prewarm_runs_one_scratch_generation(tmp_path):
    """Prewarm runs one generation of a scratch lane (its variation
    dispatch is journaled before any tenant), once per bucket whatever
    the lane counts, and reads the job's generator without advancing
    it: the job then runs to its solo result."""
    tb = _toolbox()
    job = _jobs(tb, n=1)[0]
    state = job.generator.get_state()
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=3) as sched:
        assert sched.prewarm([job], lane_counts=[1, 2]) == 2
        assert torch.equal(job.generator.get_state(), state)
        rows = read_journal(str(tmp_path / "journal.jsonl"))
        kinds = [r.get("kind") for r in rows]
        assert "variation_dispatch" in kinds
        assert "job_submitted" not in kinds
        pw = [r for r in rows if r.get("kind") == "prewarm"]
        assert [r["lanes"] for r in pw] == [1, 2]
        assert pw[1]["compile_s"] == 0.0
        assert sched.prewarm([job]) == 1
        sched.submit(job)
        res = sched.run()
    solo = algorithms.ea_simple(make_generator(100, CPU), job.init, tb, 0.5,
                                0.2, job.ngen, device=CPU)
    assert result_digest(res["t0"]) == result_digest(solo)


# ------------------------------------------------ ResilientRun.multirun ----

def test_resilient_multirun_killed_resumes_bit_for_bit(tmp_path):
    """Segments of 2 over lanes of 5 and 3 generations; a kill after the
    second segment's save; a fresh engine over the same directory
    resumes every lane to the uninterrupted result."""
    tb, pops = _toolbox(), _pops(2)
    mk = lambda: MultiRunEngine("ea_simple", tb, stats=fitness_stats(),
                                halloffame_size=2, device=CPU)
    want = ResilientRun(str(tmp_path / "ref"), segment_len=2).multirun(
        mk(), _gens(2), pops, [5, 3], HYPER[:2])
    d = str(tmp_path / "run")
    with pytest.raises(InjectedCrash):
        ResilientRun(d, segment_len=2,
                     fault_plan=FaultPlan([KillAt(4, "after_save")])
                     ).multirun(mk(), _gens(2), pops, [5, 3], HYPER[:2])
    res = ResilientRun(d, segment_len=2)
    got = res.multirun(mk(), _gens(2), pops, [5, 3], HYPER[:2])
    assert res.resumed_from is not None
    for w, g in zip(want, got):
        assert result_digest(w) == result_digest(g)
    for r, ngen in enumerate([5, 3]):
        solo = algorithms.ea_simple(make_generator(100 + r, CPU), pops[r],
                                    tb, HYPER[r]["cxpb"], HYPER[r]["mutpb"],
                                    ngen, stats=fitness_stats(),
                                    halloffame_size=2, device=CPU)
        assert result_digest(solo) == result_digest(got[r])


def test_resilient_multirun_cma_resumes(tmp_path):
    strat = cma.Strategy(centroid=[1.0] * 4, sigma=0.5, lambda_=6,
                         eigh_impl="jacobi", device=CPU)
    tb = Toolbox()
    tb.register("evaluate", lambda g: (g ** 2).sum(-1))
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    states = [strat.initial_state(sigma=s) for s in (0.3, 0.6)]
    mk = lambda: MultiRunEngine("ea_generate_update", tb, spec=strat.spec,
                                state_template=states[0], device=CPU)
    d = str(tmp_path / "run")
    with pytest.raises(InjectedCrash):
        ResilientRun(d, segment_len=2,
                     fault_plan=FaultPlan([KillAt(2)])).multirun(
            mk(), _gens(2), states, [5, 4])
    got = ResilientRun(d, segment_len=2).multirun(mk(), _gens(2), states,
                                                  [5, 4])
    for r, ngen in enumerate([5, 4]):
        solo = algorithms.ea_generate_update(
            make_generator(100 + r, CPU), states[r], tb, ngen,
            spec=strat.spec, device=CPU)
        assert result_digest(solo) == result_digest(got[r])
