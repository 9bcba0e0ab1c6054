"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never fall back to the CPU quietly."""

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import device as tdevice
from deap_tpu_torch import ops as tops
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import init_population

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_port_runs_without_jax_or_the_jax_package():
    script = textwrap.dedent("""
        import sys
        import torch
        from deap_tpu_torch import Toolbox, FitnessSpec, ops, algorithms
        from deap_tpu_torch.core.population import init_population
        from deap_tpu_torch.device import make_generator
        from deap_tpu_torch.support.stats import fitness_stats
        import deap_tpu_torch.convert, deap_tpu_torch.ops.packed
        import deap_tpu_torch.mo, deap_tpu_torch.benchmarks
        import deap_tpu_torch.support.pareto, deap_tpu_torch.native
        import deap_tpu_torch.ops.kernels_real
        import chip_smoke, port_profile
        from deap_tpu_torch import benchmarks as bm, mo
        fx = -bm.dtlz2(torch.rand(40, 12, generator=make_generator(1, "cpu")),
                       3)
        assert mo.sel_nsga2(None, fx, 20, nd="dc").shape == (20,)
        gen = make_generator(0, "cpu")
        tb = Toolbox()
        tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
        tb.register("mate", ops.cx_two_point)
        tb.register("mutate", ops.mut_flip_bit, indpb=0.05)
        tb.register("select", ops.sel_tournament, tournsize=3)
        pop = init_population(gen, 50, ops.bernoulli_genome(20),
                              FitnessSpec((1.0,)), device="cpu")
        pop, lb, hof = algorithms.ea_simple(gen, pop, tb, 0.5, 0.2, 3,
                                            stats=fitness_stats(),
                                            halloffame_size=1, device="cpu")
        assert len(lb) == 4
        from deap_tpu_torch import gp
        X = torch.linspace(-1, 1, 16)[:, None]
        run = gp.make_symbreg_loop(gp.math_set(1), 24, X, X[:, 0] ** 2,
                                   device="cpu")
        trees = gp.gen_half_and_half(gp.math_set(1), 24, 1, 2)(gen, 32)
        res = run(gen, trees, 3)
        assert len(res["nevals"]) == 4 and run.interpreter.levels_run > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|deap_tpu)(\s|\.|$)", re.M)


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    files = sorted((ROOT / "deap_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "port_profile.py"]
    assert len(files) > 10
    for path in files:
        hits = _IMPORT.findall(path.read_text())
        assert not hits, (path, hits)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    spec = FitnessSpec((1.0,))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.make_generator(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device("cuda")
    gen = tdevice.make_generator(0, "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_population(gen, 4, tops.bernoulli_genome(8), spec)
    pop = init_population(gen, 4, tops.bernoulli_genome(8), spec,
                          device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        talg.ea_simple(gen, pop, None, 0.5, 0.2, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        talg.ea_simple_packed(gen, torch.zeros((4, 1), dtype=torch.uint32),
                              torch.zeros(4), 8, 1, cxpb=0.5, mutpb=0.2,
                              indpb=0.05)


def test_gp_entry_points_raise_without_a_card(no_card):
    from deap_tpu_torch import gp
    pset = gp.math_set(1)
    X = torch.linspace(-1, 1, 8)[:, None]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp.make_symbreg_loop(pset, 16, X, X[:, 0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp.make_gp_loop(pset, 16, lambda g: g["length"].float(), cxpb=0.5,
                        mutpb=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp.from_string("add(ARG0, ARG0)", pset, 16)


def test_generator_must_live_on_the_run_device():
    gen = tdevice.make_generator(0, "cpu")
    with pytest.raises(ValueError, match="generator"):
        tdevice.check_generator(gen, torch.device("meta"))


def test_var_or_loops_and_es_operators_stand_alone(no_card):
    """The (μ + λ) / (μ, λ) loops, ``var_or``, the ES operators, the
    ``sel_best`` family and Kursawe run without jax or the JAX package,
    and the loops raise without a card unless asked for the CPU."""
    script = textwrap.dedent("""
        import sys
        import torch
        from deap_tpu_torch import Toolbox, FitnessSpec, ops, algorithms
        from deap_tpu_torch import benchmarks as bm
        from deap_tpu_torch.core.population import init_population
        from deap_tpu_torch.device import make_generator
        import chip_smoke
        gen = make_generator(0, "cpu")
        tb = Toolbox()
        tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
        tb.register("mate", ops.cx_two_point)
        tb.register("mutate", ops.mut_flip_bit, indpb=0.05)
        tb.register("select", ops.sel_best)
        pop = init_population(gen, 30, ops.bernoulli_genome(20),
                              FitnessSpec((1.0,)), device="cpu")
        for loop in (algorithms.ea_mu_plus_lambda,
                     algorithms.ea_mu_comma_lambda):
            _, lb, _ = loop(gen, pop, tb, 30, 60, 0.5, 0.2, 2, device="cpu")
            assert len(lb) == 3
        assert algorithms.var_or(gen, pop, tb, 7, 0.5, 0.2).size == 7
        assert ops.sel_worst(None, torch.zeros(4, 1), 2).tolist() == [0, 1]
        assert ops.sel_random(gen, torch.zeros(4, 1), 3).shape == (3,)
        tb = chip_smoke.fctmin_toolbox()
        pop = init_population(gen, 10, chip_smoke.fctmin_init,
                              FitnessSpec((-1.0,)), device="cpu")
        pop, _, _ = algorithms.ea_mu_comma_lambda(gen, pop, tb, 10, 100,
                                                  0.6, 0.3, 2, device="cpu")
        g, s = pop.genomes["x"], pop.genomes["strategy"]
        assert ops.cx_es_two_point(gen, g, s, g, s)[0][0].shape == g.shape
        assert bm.kursawe(g[:, :3]).shape == (10, 2)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    gen = tdevice.make_generator(0, "cpu")
    pop = init_population(gen, 4, tops.bernoulli_genome(8),
                          FitnessSpec((1.0,)), device="cpu")
    for loop in (talg.ea_mu_plus_lambda, talg.ea_mu_comma_lambda):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            loop(gen, pop, None, 4, 8, 0.5, 0.2, 1)


def test_cma_family_and_jacobi_stand_alone(no_card):
    """The Jacobi eigensolver, ``'jacobi'`` CMA-ES, (1+λ)-CMA-ES, MO-CMA-ES
    and BIPOP run without jax or the JAX package, and their entry points
    raise without a card unless asked for the CPU."""
    script = textwrap.dedent("""
        import sys
        import torch
        from deap_tpu_torch import Toolbox, algorithms, benchmarks, convert
        from deap_tpu_torch.device import make_generator
        from deap_tpu_torch.ops import eigh_jacobi, linalg
        from deap_tpu_torch.strategies import (
            Strategy, StrategyMultiObjective, StrategyOnePlusLambda,
            bipop_cmaes, hypervolume_contributions_2d)
        import chip_smoke, port_profile
        w, V = eigh_jacobi(torch.eye(5) * 2)
        assert w.tolist() == [2.0] * 5 and eigh_jacobi.launches == 0
        gen = make_generator(0, "cpu")
        s = Strategy(torch.zeros(4), 1.0, lambda_=8, eigh_impl="jacobi",
                     device="cpu")
        st = s.initial_state()
        pop = s.generate(gen, st)
        st = s.update(st, pop, benchmarks.sphere(pop))
        p = torch.ones(3)
        o = StrategyOnePlusLambda(p, benchmarks.sphere(p[None]), 1.0,
                                  lambda_=4, device="cpu")
        os = o.initial_state()
        g = o.generate(gen, os)
        os = o.update(os, g, benchmarks.sphere(g))
        convert.one_plus_lambda_state_to_arrays(os)
        x0 = torch.rand(6, 3, generator=gen)
        m = StrategyMultiObjective(x0, benchmarks.zdt1(x0), 0.1, lambda_=9,
                                   device="cpu")
        ms = m.initial_state()
        g = m.generate(gen, ms)
        ms = m.update(ms, g, benchmarks.zdt1(g["x"].clamp(0, 1)))
        assert ms.x.shape == (6, 3)
        convert.mo_state_to_arrays(ms)
        bx, bf, lbs = bipop_cmaes(gen, lambda x: (x * x).sum(-1), 2,
                                  nrestarts=1, device="cpu")
        assert len(lbs) == 1
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    from deap_tpu_torch import strategies
    with pytest.raises(RuntimeError, match="device='cpu'"):
        strategies.Strategy(torch.zeros(3), 1.0, eigh_impl="jacobi")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        strategies.StrategyOnePlusLambda(torch.zeros(3), 0.0, 1.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        strategies.StrategyMultiObjective(torch.zeros(4, 3),
                                          torch.zeros(4, 2), 0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        strategies.bipop_cmaes(tdevice.make_generator(0, "cpu"),
                               lambda x: x.sum(-1), 3)


def test_rest_of_strategies_and_nsga3_stand_alone(no_card):
    """PSO, DE, PBIL, EMNA, the multi-swarm and speciation swarms, moving
    peaks, NSGA-III and dense SPEA2 run without jax or the JAX package,
    and their entry points raise without a card unless asked for the
    CPU."""
    script = textwrap.dedent("""
        import sys
        import torch
        from deap_tpu_torch import benchmarks, convert, mo, strategies
        from deap_tpu_torch.benchmarks import movingpeaks as mp
        from deap_tpu_torch.device import make_generator
        from deap_tpu_torch.strategies import (
            EMNA, PBIL, PSO, DifferentialEvolution, MultiSwarmPSO,
            SpeciationPSO, species_seeds)
        import chip_smoke
        gen = make_generator(0, "cpu")
        pso = PSO(benchmarks.h1, smin=0.001, smax=3.0, device="cpu")
        s, traj = pso.run(gen, pso.init(gen, 8, 2, -6, 6, -3, 3), 3)
        assert traj.shape == (3,)
        pbil = PBIL(16, device="cpu")
        st = pbil.initial_state(gen)
        x = pbil.generate(gen, st)
        st = pbil.update(st, x, x.sum(-1))
        emna = EMNA([1.0] * 4, 1.0, 3, 6, device="cpu")
        es = emna.initial_state()
        x = emna.generate(gen, es)
        emna.update(es, x, benchmarks.griewank(x))
        cfg = mp.MovingPeaksConfig(dim=2, **mp.SCENARIO_3)
        land = mp.mp_init(gen, cfg)
        land, v = mp.mp_evaluate(cfg, land, torch.rand(5, 2) * 100,
                                 exact=True)
        ms = MultiSwarmPSO(chip_smoke.two_peaks, -6.0, 6.0, device="cpu")
        ms.step(gen, ms.init(gen, 2, 3, 2, capacity=4))
        sp = SpeciationPSO(chip_smoke.two_peaks, -6.0, 6.0, 2.0,
                           device="cpu")
        sp.step(gen, sp.init(gen, 10, 2))
        w = -benchmarks.dtlz2(torch.rand(40, 7, generator=gen), 3)
        ref = mo.uniform_reference_points(3, 4)
        assert mo.sel_nsga3(gen, w, 20, ref).shape == (20,)
        assert mo.sel_spea2(None, w, 10).shape == (10,)
        assert len(strategies.__all__) == 20
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    from deap_tpu_torch import strategies
    from deap_tpu_torch.benchmarks import movingpeaks as mp
    f = lambda x: x.sum(-1)  # noqa: E731
    for make in (lambda: strategies.PSO(f), lambda: strategies.PBIL(4),
                 lambda: strategies.EMNA([0.0], 1.0, 1, 2),
                 lambda: strategies.MultiSwarmPSO(f, 0.0, 1.0),
                 lambda: strategies.SpeciationPSO(f, 0.0, 1.0, 1.0),
                 lambda: mp.mp_init(tdevice.make_generator(0),
                                    mp.MovingPeaksConfig(dim=2))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_cartpole_mesh_and_rest_of_the_operators_stand_alone(no_card):
    """The cart-pole (its rollouts and J5's wrapper), the one-device mesh,
    the rest of the operators (A3, A7), the constraint decorators,
    MultiStatistics and logbook_from_records run without jax or the JAX
    package, and the cart-pole configuration's entry points raise without
    a card unless asked for the CPU."""
    script = textwrap.dedent("""
        import sys
        import torch
        from deap_tpu_torch import FitnessSpec, ops, parallel
        from deap_tpu_torch.benchmarks import cartpole
        from deap_tpu_torch.core.population import init_population
        from deap_tpu_torch.device import make_generator
        from deap_tpu_torch.support import (MultiStatistics, Statistics,
                                            logbook_from_records)
        import chip_smoke
        gen = make_generator(0, "cpu")
        g, starts, tb, pop = chip_smoke.cartpole_start("cpu", 0, 16)
        pop = chip_smoke.cartpole_generation(g, pop, tb)
        assert pop.fitness.shape == (16, 1) and bool(pop.valid.all())
        assert parallel.population_mesh(device="cpu").device.type == "cpu"
        perm = torch.stack([torch.randperm(9, generator=gen)
                            for _ in range(4)])
        w = torch.rand(4, 1, generator=gen) + 0.1
        for out in (ops.cx_uniform(gen, perm, perm, 0.5),
                    ops.cx_partialy_matched(gen, perm, perm.flip(1)),
                    ops.cx_uniform_partialy_matched(gen, perm, perm, 0.3),
                    ops.cx_ordered(gen, perm, perm.flip(1)),
                    ops.cx_simulated_binary(gen, w, w, 2.0)):
            assert out[0].shape == out[1].shape
        ops.mut_uniform_int(gen, perm, 0, 8, 0.3)
        ops.mut_shuffle_indexes(gen, perm, 0.3)
        ops.mut_two_opt(gen, perm, torch.rand(9, 9, generator=gen), 2)
        ops.sel_roulette(gen, w, 3)
        ops.sel_stochastic_universal_sampling(gen, w, 3)
        ops.sel_double_tournament(gen, w, torch.arange(4), 3, 2, 1.4, True)
        ops.sel_lexicase(gen, torch.rand(4, 5, generator=gen), [1.0] * 5, 3)
        pen = ops.delta_penalty(lambda x: x[:, 0] > 0.5, 9.0)(
            lambda x: x.sum(-1))
        assert pen(w).shape == (4, 1)
        ms = MultiStatistics(fit=Statistics())
        assert ms.fields == ["fit"]
        assert len(logbook_from_records({"gen": torch.arange(3)})) == 3
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    import chip_smoke
    from deap_tpu_torch import parallel
    with pytest.raises(RuntimeError, match="device='cpu'"):
        chip_smoke.cartpole_start(None, 0, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        parallel.population_mesh()


def test_resilience_checkpoints_and_journal_stand_alone(no_card, tmp_path):
    """The resilient engine, the checkpoint container, the genealogy
    helpers, the fault harness and the run journal run without jax or the
    JAX package: a killed ``ea_simple`` resumes bit for bit, and the
    engine raises without a card unless asked for the CPU."""
    script = textwrap.dedent(f"""
        import sys
        import torch
        from deap_tpu_torch import Toolbox, FitnessSpec, ops, algorithms
        from deap_tpu_torch.core.population import init_population
        from deap_tpu_torch.device import make_generator
        from deap_tpu_torch.resilience import (
            FaultPlan, InjectedCrash, KillAt, ResilientRun, RetryPolicy,
            DrainSignal, quarantine_non_finite, nan_inject_evaluate)
        from deap_tpu_torch.support import (
            Checkpointer, History, lineage_init, lineage_step, pair_parents,
            restore_state, save_state)
        from deap_tpu_torch.telemetry import RunJournal, read_journal
        tb = Toolbox()
        tb.register("evaluate", quarantine_non_finite(
            lambda g: g.sum(-1).to(torch.float32)))
        tb.register("mate", ops.cx_two_point)
        tb.register("mutate", ops.mut_flip_bit, indpb=0.05)
        tb.register("select", ops.sel_tournament, tournsize=3)
        pop = lambda: init_population(make_generator(0, "cpu"), 40,
                                      ops.bernoulli_genome(12),
                                      FitnessSpec((1.0,)), device="cpu")
        want = algorithms.ea_simple(make_generator(1, "cpu"), pop(), tb, 0.5,
                                    0.2, 5, device="cpu")
        d = {str(tmp_path / "ck")!r}
        with RunJournal({str(tmp_path / "j.jsonl")!r}):
            try:
                ResilientRun(d, segment_len=2,
                             fault_plan=FaultPlan([KillAt(3)])).ea_simple(
                    make_generator(1, "cpu"), pop(), tb, 0.5, 0.2, 5,
                    device="cpu")
            except InjectedCrash:
                pass
            got = ResilientRun(d, segment_len=2).ea_simple(
                make_generator(1, "cpu"), pop(), tb, 0.5, 0.2, 5,
                device="cpu")
        assert torch.equal(want[0].genomes, got[0].genomes)
        kinds = [r["kind"] for r in read_journal({str(tmp_path / "j.jsonl")!r})]
        assert "resumed" in kinds and "segment" in kinds, kinds
        lin, ids = lineage_step(lineage_init(4, "cpu"), pair_parents(
            torch.tensor([0, 1, 2, 3]), torch.tensor([True, False])))
        History().record(ids)
        assert RetryPolicy(jitter=0.5).delay(1) > 0
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    from deap_tpu_torch.resilience import ResilientRun
    from deap_tpu_torch.support import restore_state, save_state
    gen = tdevice.make_generator(0, "cpu")
    pop = init_population(gen, 4, tops.bernoulli_genome(8),
                          FitnessSpec((1.0,)), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ResilientRun(str(tmp_path / "c2")).ea_simple(gen, pop, None, 0.5,
                                                     0.2, 1)
    save_state(str(tmp_path / "s.pkl"), {"x": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_state(str(tmp_path / "s.pkl"))


def test_telemetry_stands_alone(no_card, tmp_path):
    """Run telemetry (the meter, the probes, the journal's rows, spans,
    the observatory, the flight recorder and the copied standard-library
    modules, whose sibling loads are the port's own files) runs without
    jax or the JAX package, and the meter raises without a card unless
    asked for the CPU."""
    script = textwrap.dedent(f"""
        import os, sys
        import torch
        from deap_tpu_torch import Toolbox, FitnessSpec, ops, algorithms
        from deap_tpu_torch.core.population import init_population
        from deap_tpu_torch.device import make_generator
        from deap_tpu_torch.resilience import ResilientRun
        from deap_tpu_torch.support import SpanRecorder, span, trace
        from deap_tpu_torch.telemetry import (
            DiversityProbe, FitnessProbe, HealthMonitor, MetricsRegistry,
            ProgramObservatory, RunTelemetry, SelectionProbe, read_journal)
        from deap_tpu_torch.telemetry import (alerts, federation, metrics,
                                              report, slo, tracing)
        here = os.path.dirname(report.__file__)
        assert os.path.dirname(report._journal().__file__) == here
        assert os.path.dirname(federation._slo().__file__) == here
        tb = Toolbox()
        tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
        tb.register("mate", ops.cx_two_point)
        tb.register("mutate", ops.mut_flip_bit, indpb=0.05)
        tb.register("select", ops.sel_tournament, tournsize=3)
        g = make_generator(0, "cpu")
        pop = init_population(g, 30, ops.bernoulli_genome(12),
                              FitnessSpec((1.0,)), device="cpu")
        path = {str(tmp_path / "t.jsonl")!r}
        with RunTelemetry(path, health=HealthMonitor()) as tel, \\
                ProgramObservatory(journal=tel.journal):
            algorithms.ea_simple(g, pop, tb, 0.5, 0.2, 3, telemetry=tel,
                                 probes=(DiversityProbe(), FitnessProbe(),
                                         SelectionProbe(n=30)), device="cpu")
            ResilientRun({str(tmp_path / "ck")!r}, segment_len=2,
                         telemetry=tel, metrics=MetricsRegistry(),
                         trace_every=2).ea_simple(
                make_generator(0, "cpu"), pop, tb, 0.5, 0.2, 3, device="cpu")
        kinds = [r["kind"] for r in read_journal(path, strict=True)]
        assert "meter" in kinds and "flight_trace" in kinds, kinds
        assert "program_profile" in kinds, kinds
        assert "Run" in report.render_report(path) or kinds
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith("jax.")
                     or m == "deap_tpu" or m.startswith("deap_tpu."))
        print("LOADED", bad)
        assert not bad, bad
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
    from deap_tpu_torch.telemetry import Meter
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Meter().init()
