"""The port's GP and island run axis, on the CPU.

- GP lanes (:class:`GpMultiRunEngine`) against the solo host-dispatch
  loop (``make_symbreg_loop``/``make_gp_loop``), bit for bit: mixed
  ``ngen`` and per-lane hyperparameters, ERC-heavy lanes (high mutpb,
  deep donors), a bool vocabulary through a custom evaluator, and ADF
  lanes whose evaluator runs a frozen defined function; ``pack_fresh``
  (every lane's founders in one evaluation) equal to ``lane_init``; the
  meter rows equal to the solo loop's telemetry rows.
- Island lanes (:class:`IslandMultiRunEngine`) against the solo
  ``make_island_step`` epochs, with and without telemetry.
- The scheduler serving GP and island buckets with eviction/resume, the
  tuner's ``gp_batch`` knob, and ``ResilientRun.multirun`` killed and
  resumed for both engines.
- The JAX package's GP engine journals ``gp_dispatch`` with ``n_lanes``;
  so does the port's (no mask replays: K9 dispatches every opcode).
"""

import os

import pytest
import torch

from deap_tpu_torch import FitnessSpec, Toolbox, gp, ops, parallel, tuning
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.gp.loop import make_gp_loop, make_symbreg_loop
from deap_tpu_torch.gp.pset import bool_set, math_set
from deap_tpu_torch.resilience import ResilientRun
from deap_tpu_torch.resilience.faultinject import (FaultPlan, InjectedCrash,
                                                   KillAt)
from deap_tpu_torch.serving import (GpJobSpec, GpMultiRunEngine,
                                    IslandJobSpec, IslandMultiRunEngine,
                                    Job, Scheduler)
from deap_tpu_torch.serving.wire import result_digest
from deap_tpu_torch.support.checkpoint import tree_flatten
from deap_tpu_torch.telemetry import RunJournal, RunTelemetry, read_journal

CPU = "cpu"
ML, N, P = 32, 24, 12


def _same(a, b):
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    return sa == sb and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def _assert_gp_equal(solo, batched, label=""):
    for k in ("genomes", "depths", "fitness", "best_genome"):
        assert _same(solo[k], batched[k]), f"{label}: {k}"
    assert solo["nevals"] == batched["nevals"], label
    assert solo["best_fitness"] == batched["best_fitness"], label


def _founders(pset, seed, n=N, max_len=ML, depth=3):
    return gp.make_generator(pset, max_len, 1, depth, "full")(
        make_generator(seed, CPU), n)


def _data(n_points=P):
    X = torch.linspace(-1, 1, n_points)[:, None]
    return X, X[:, 0] ** 2 + X[:, 0]


def _run(eng, seeds, inits, ngens, hypers, segment_len=3):
    lanes = [eng.lane_init(make_generator(s, CPU), g0, ng, h)
             for s, g0, ng, h in zip(seeds, inits, ngens, hypers)]
    batch = eng.pack(lanes)
    segs = []
    while not eng.done(batch).all():
        batch, seg = eng.advance(batch, segment_len)
        segs.append(seg)
    return [eng.lane_result(eng.unpack(batch, i), eng.lane_records(segs, i))
            for i in range(len(lanes))]


# ------------------------------------------------------------ GP lanes ----

def test_gp_lanes_mixed_ngen_and_hyper_bit_identity():
    pset = math_set(n_args=1)
    X, y = _data()
    ngens = [7, 4, 7, 2]
    hypers = [{"cxpb": 0.5, "mutpb": 0.2}, {"cxpb": 0.8, "mutpb": 0.1},
              {"cxpb": 0.2, "mutpb": 0.5}, {"cxpb": 0.5, "mutpb": 0.2}]
    eng = GpMultiRunEngine(GpJobSpec(pset=pset, max_len=ML, X=X, y=y),
                           device=CPU)
    out = _run(eng, [100 + i for i in range(4)],
               [_founders(pset, i) for i in range(4)], ngens, hypers)
    for i, ng in enumerate(ngens):
        solo = make_symbreg_loop(pset, ML, X, y, device=CPU, **hypers[i])
        want = solo(make_generator(100 + i, CPU), _founders(pset, i), ng)
        _assert_gp_equal(want, out[i], f"lane {i}")


def test_gp_lanes_erc_heavy_bit_identity():
    pset = math_set(n_args=1, erc_low=-2.0, erc_high=2.0)
    X, y = _data()
    solo = make_symbreg_loop(pset, ML, X, y, cxpb=0.3, mutpb=0.6,
                             mut_max=3, device=CPU)
    eng = GpMultiRunEngine(GpJobSpec(pset=pset, max_len=ML, X=X, y=y,
                                     mut_max=3), device=CPU)
    out = _run(eng, [7, 8], [_founders(pset, 50 + i) for i in range(2)],
               [5, 5], [{"cxpb": 0.3, "mutpb": 0.6}] * 2, segment_len=2)
    for i in range(2):
        want = solo(make_generator(7 + i, CPU), _founders(pset, 50 + i), 5)
        _assert_gp_equal(want, out[i], f"erc lane {i}")


def test_gp_lanes_bool_vocab_custom_eval_bit_identity():
    pset = bool_set(n_args=2)
    interp = gp.make_batch_interpreter(pset, 24, mode="scan", dedup=False)
    X = torch.tensor([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=torch.float32)
    y = torch.tensor([0, 1, 1, 0], dtype=torch.float32)

    def evaluate(genomes):
        return -((interp(genomes, X) - y[None, :]) ** 2).mean(1)

    solo = make_gp_loop(pset, 24, evaluate, cxpb=0.5, mutpb=0.3,
                        device=CPU)
    eng = GpMultiRunEngine(GpJobSpec(pset=pset, max_len=24,
                                     evaluate=evaluate, name="parity"),
                           device=CPU)
    inits = [_founders(pset, 80 + i, max_len=24) for i in range(2)]
    out = _run(eng, [31, 32], inits, [5, 5],
               [{"cxpb": 0.5, "mutpb": 0.3}] * 2, segment_len=2)
    for i in range(2):
        want = solo(make_generator(31 + i, CPU), inits[i], 5)
        _assert_gp_equal(want, out[i], f"bool lane {i}")


def test_gp_lanes_adf_bit_identity():
    """ADF lanes: the MAIN branch evolves (its set carries the ADF0 call)
    while a frozen defined function rides inside a shared row-independent
    evaluator built on the ADF batch interpreter."""
    main = gp.PrimitiveSet("MAIN", 1)
    main.add_primitive(torch.add, 2, "add")
    main.add_primitive(torch.mul, 2, "mul")
    main.add_adf("ADF0", 1, branch=1)
    sub = gp.PrimitiveSet("ADF0", 1)
    sub.add_primitive(torch.sub, 2, "sub")
    sub.add_primitive(torch.cos, 1, "cos")
    adf_interp = gp.make_adf_batch_interpreter([(main, 24), (sub, 16)],
                                               specialize="none")
    sub_g = gp.make_generator(sub, 16, 1, 2, "full")(
        make_generator(999, CPU), 1)
    X = torch.linspace(-1.0, 1.0, 9)[:, None]
    y = torch.cos(X[:, 0]) * X[:, 0]

    def evaluate(genomes):
        rows = genomes["nodes"].shape[0]
        sub_b = {k: v.expand((rows,) + v.shape[1:]) for k, v in
                 sub_g.items()}
        preds = adf_interp((genomes, sub_b), X)
        return -(preds - y[None, :]).abs().amax(1)

    solo = make_gp_loop(main, 24, evaluate, cxpb=0.5, mutpb=0.2,
                        device=CPU)
    eng = GpMultiRunEngine(GpJobSpec(pset=main, max_len=24,
                                     evaluate=evaluate, name="adf"),
                           device=CPU)
    inits = [_founders(main, 90 + i, max_len=24) for i in range(2)]
    out = _run(eng, [61, 62], inits, [4, 4],
               [{"cxpb": 0.5, "mutpb": 0.2}] * 2, segment_len=2)
    for i in range(2):
        want = solo(make_generator(61 + i, CPU), inits[i], 4)
        _assert_gp_equal(want, out[i], f"adf lane {i}")


def test_gp_pack_fresh_matches_lane_init_and_meter_rows(tmp_path):
    """Every lane's founders in one evaluation equal lane_init's; the
    per-lane meter rows equal the solo loop's telemetry rows; the engine
    journals gp_dispatch with its lane count."""
    pset = math_set(n_args=1)
    X, y = _data()
    spec = GpJobSpec(pset=pset, max_len=ML, X=X, y=y)
    inits = [_founders(pset, i) for i in range(3)]
    hyper = {"cxpb": 0.5, "mutpb": 0.2}
    with RunTelemetry(str(tmp_path / "b.jsonl")) as tel:
        eng = GpMultiRunEngine(spec, telemetry=tel, device=CPU)
        b1 = eng.pack([eng.lane_init(make_generator(10 + i, CPU), g, 4,
                                     hyper) for i, g in enumerate(inits)])
        b2 = eng.pack_fresh([make_generator(10 + i, CPU) for i in range(3)],
                            inits, 4, hyper)
        for i in range(3):
            assert _same(eng.unpack(b1, i), eng.unpack(b2, i))
        lanes = [eng.unpack(b2, i) for i in range(3)]
        segs = []
        while not eng.done(b2).all():
            b2, seg = eng.advance(b2, 3)
            segs.append(seg)
        rows = [eng.lane_meter_rows(segs, i, lane=lanes[i])
                for i in range(3)]
    for i in range(3):
        path = str(tmp_path / f"s{i}.jsonl")
        with RunTelemetry(path) as tel:
            solo = make_symbreg_loop(pset, ML, X, y, device=CPU,
                                     telemetry=tel, **hyper)
            solo(make_generator(10 + i, CPU), inits[i], 4)
        want = [{k: v for k, v in r.items() if k not in ("kind", "t")}
                for r in read_journal(path) if r.get("kind") == "meter"]
        assert rows[i] == want
    disp = [r for r in read_journal(str(tmp_path / "b.jsonl"))
            if r.get("kind") == "gp_dispatch" and r.get("mode") == "batched"]
    assert disp and disp[-1]["n_lanes"] == 3


def test_gp_engine_refuses_probes_stats_and_streaming(tmp_path):
    pset = math_set(n_args=1)
    X, y = _data()
    spec = GpJobSpec(pset=pset, max_len=ML, X=X, y=y)
    with pytest.raises(ValueError, match="probes"):
        GpMultiRunEngine(spec, probes=(object(),), device=CPU)
    with pytest.raises(ValueError, match="stats"):
        GpMultiRunEngine(spec, halloffame_size=2, device=CPU)
    with RunTelemetry(str(tmp_path / "j.jsonl"), stream=True) as tel:
        with pytest.raises(ValueError, match="stream"):
            GpMultiRunEngine(spec, telemetry=tel, device=CPU)
    with pytest.raises(ValueError, match="X="):
        GpJobSpec(pset=pset, max_len=ML)
    assert GpJobSpec(pset=pset, max_len=ML, X=X, y=y).fingerprint() != \
        GpJobSpec(pset=pset, max_len=ML, X=X, y=y + 1).fingerprint()


# -------------------------------------------------------- island lanes ----

def _island_toolbox(real=False):
    """OneMax, or Rastrigin on float32 genomes (a float-valued
    evaluation, which the engine runs lane by lane)."""
    from deap_tpu_torch import benchmarks
    tb = Toolbox()
    if real:
        tb.register("evaluate", benchmarks.rastrigin)
        tb.register("mutate", ops.mut_gaussian, mu=0.0, sigma=0.3,
                    indpb=0.1)
    else:
        tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
        tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("mate", ops.cx_two_point)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


def _island_init(seed, n_islands=4, island_size=16, real=False):
    genome = (ops.uniform_genome(12, -5.12, 5.12) if real
              else ops.bernoulli_genome(12))
    return parallel.island_init(make_generator(seed, CPU), n_islands,
                                island_size, genome,
                                FitnessSpec((-1.0,) if real else (1.0,)),
                                device=CPU)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("telemetry", [False, True])
def test_island_lanes_vs_solo_epochs(tmp_path, telemetry, real):
    tb = _island_toolbox(real)
    spec = IslandJobSpec(n_islands=4, island_size=16, freq=2, mig_k=2)
    ngens = [5, 3, 5]
    hypers = [{"cxpb": 0.5, "mutpb": 0.2}, {"cxpb": 0.7, "mutpb": 0.1},
              {"cxpb": 0.5, "mutpb": 0.2}]
    tel = RunTelemetry(str(tmp_path / "b.jsonl")) if telemetry else None
    eng = IslandMultiRunEngine(tb, spec, telemetry=tel, device=CPU)
    lanes = [eng.lane_init(make_generator(200 + i, CPU),
                           _island_init(i, real=real), ngens[i], hypers[i])
             for i in range(3)]
    batch, segs = eng.pack(lanes), []
    while not eng.done(batch).all():
        batch, seg = eng.advance(batch, 2)
        segs.append(seg)
    for i in range(3):
        stel = (RunTelemetry(str(tmp_path / f"s{i}.jsonl"))
                if telemetry else None)
        step = parallel.make_island_step(tb, hypers[i]["cxpb"],
                                         hypers[i]["mutpb"], 2, 2,
                                         telemetry=stel)
        g, pops = make_generator(200 + i, CPU), _island_init(i, real=real)
        ms = stel.meter.init(device=CPU) if telemetry else None
        rows = []
        for _ in range(ngens[i]):
            if telemetry:
                pops, ms = step(g, pops, ms)
                rows.append(stel.meter.row(ms))
            else:
                pops = step(g, pops)
        assert _same(pops, eng.lane_result(eng.unpack(batch, i), None))
        if telemetry:
            got = eng.lane_meter_rows(segs, i)
            assert [{k: v for k, v in r.items() if k != "gen"}
                    for r in got] == rows
            assert [r["gen"] for r in got] == list(range(ngens[i]))


def test_island_lane_topology_is_checked():
    eng = IslandMultiRunEngine(_island_toolbox(),
                               IslandJobSpec(4, 16, 2, 2), device=CPU)
    with pytest.raises(ValueError, match="topology"):
        eng.lane_init(make_generator(0, CPU), _island_init(0, 2, 16), 2,
                      {"cxpb": 0.5, "mutpb": 0.2})


# ---------------------------------------------------------- scheduler ----

def _gp_job(i, pset, X, y, ngen=5):
    return Job(tenant_id=f"g{i}", family="gp", toolbox=None,
               generator=make_generator(300 + i, CPU),
               init=_founders(pset, i), ngen=ngen,
               hyper={"cxpb": 0.5, "mutpb": 0.2},
               spec=GpJobSpec(pset=pset, max_len=ML, X=X, y=y))


def test_scheduler_gp_and_island_buckets_bit_identity(tmp_path):
    """GP and island tenants (3 each, 2 lanes, quantum 1: evictions and
    resumes) equal their solo runs."""
    pset = math_set(n_args=1)
    X, y = _data()
    tb = _island_toolbox()
    ispec = IslandJobSpec(4, 16, 2, 2)
    gjobs = [_gp_job(i, pset, X, y) for i in range(3)]
    ijobs = [Job(tenant_id=f"i{i}", family="island", toolbox=tb,
                 generator=make_generator(400 + i, CPU),
                 init=_island_init(i), ngen=3,
                 hyper={"cxpb": 0.5, "mutpb": 0.2}, spec=ispec)
             for i in range(3)]
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=2,
                   fair_quantum=1) as sched:
        for j in gjobs + ijobs:
            sched.submit(j)
        res = sched.run()
    solo = make_symbreg_loop(pset, ML, X, y, cxpb=0.5, mutpb=0.2,
                             device=CPU)
    for i, j in enumerate(gjobs):
        want = solo(make_generator(300 + i, CPU), j.init, j.ngen)
        _assert_gp_equal(want, res[j.tenant_id], j.tenant_id)
    step = parallel.make_island_step(tb, 0.5, 0.2, 2, 2)
    for i, j in enumerate(ijobs):
        g, pops = make_generator(400 + i, CPU), j.init
        for _ in range(3):
            pops = step(g, pops)
        assert _same(pops, res[j.tenant_id])
    kinds = [r["kind"] for r in read_journal(str(tmp_path /
                                                 "journal.jsonl"))]
    assert "tenant_evicted" in kinds and "tenant_resumed" in kinds


def test_gp_batch_knob_routes_the_bucket(tmp_path, monkeypatch):
    """The tuner's gp_batch knob: with the override at 'solo' the GP
    bucket runs one lane at a time (journaled tuned_admission); the
    results are the same bits."""
    pset = math_set(n_args=1)
    X, y = _data()
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_GP_BATCH", "solo")
    jobs = [_gp_job(i, pset, X, y, ngen=3) for i in range(2)]
    with RunJournal(str(tmp_path / "t.jsonl")):
        with Scheduler(str(tmp_path / "s"), max_lanes=4,
                       segment_len=2) as sched:
            for j in jobs:
                sched.submit(j)
            res = sched.run()
            assert [b.max_lanes for b in sched.buckets.values()] == [1]
    rows = read_journal(str(tmp_path / "s" / "journal.jsonl"))
    assert any(r.get("kind") == "tuned_admission" for r in rows)
    solo = make_symbreg_loop(pset, ML, X, y, cxpb=0.5, mutpb=0.2,
                             device=CPU)
    for i, j in enumerate(jobs):
        _assert_gp_equal(solo(make_generator(300 + i, CPU), j.init, 3),
                         res[j.tenant_id])
    assert "gp_batch" in tuning.KNOBS


# ----------------------------------------------- ResilientRun.multirun ----

def test_resilient_multirun_gp_killed_resumes(tmp_path):
    pset = math_set(n_args=1)
    X, y = _data()
    spec = GpJobSpec(pset=pset, max_len=ML, X=X, y=y)
    inits = [_founders(pset, i) for i in range(2)]
    gens = lambda: [make_generator(20 + i, CPU) for i in range(2)]
    hyper = {"cxpb": 0.5, "mutpb": 0.2}
    d = str(tmp_path / "run")
    with pytest.raises(InjectedCrash):
        ResilientRun(d, segment_len=2,
                     fault_plan=FaultPlan([KillAt(2, "after_save")])
                     ).multirun(GpMultiRunEngine(spec, device=CPU), gens(),
                                inits, [5, 3], hyper)
    got = ResilientRun(d, segment_len=2).multirun(
        GpMultiRunEngine(spec, device=CPU), gens(), inits, [5, 3], hyper)
    solo = make_symbreg_loop(pset, ML, X, y, device=CPU, **hyper)
    for i, ng in enumerate([5, 3]):
        _assert_gp_equal(solo(make_generator(20 + i, CPU), inits[i], ng),
                         got[i], f"lane {i}")


def test_resilient_multirun_island_killed_resumes(tmp_path):
    tb = _island_toolbox()
    spec = IslandJobSpec(4, 16, 2, 2)
    inits = [_island_init(i) for i in range(2)]
    gens = lambda: [make_generator(30 + i, CPU) for i in range(2)]
    hyper = {"cxpb": 0.5, "mutpb": 0.2}
    d = str(tmp_path / "run")
    with pytest.raises(InjectedCrash):
        ResilientRun(d, segment_len=2,
                     fault_plan=FaultPlan([KillAt(2)])).multirun(
            IslandMultiRunEngine(tb, spec, device=CPU), gens(), inits,
            [4, 3], hyper)
    got = ResilientRun(d, segment_len=2).multirun(
        IslandMultiRunEngine(tb, spec, device=CPU), gens(), inits, [4, 3],
        hyper)
    step = parallel.make_island_step(tb, 0.5, 0.2, 2, 2)
    for i, ng in enumerate([4, 3]):
        g, pops = make_generator(30 + i, CPU), inits[i]
        for _ in range(ng):
            pops = step(g, pops)
        assert _same(pops, got[i])
    assert result_digest(got[0]) != result_digest(got[1])
