"""Run telemetry of the port on the CPU: telemetry changes nothing, the
journal matches the JAX package's, and what is ported no longer raises.

- Telemetry changes nothing: ``ea_simple``, ``ea_mu_plus_lambda``,
  ``ea_mu_comma_lambda``, ``ea_generate_update`` (Hansen CMA-ES, under
  ``strategy_probe``), a (μ + λ) NSGA-II under ``FrontProbe`` and the GP
  loop, run with ``RunTelemetry``, every built-in probe that applies and a
  ``HealthMonitor``, equal the bare runs bit for bit (populations,
  logbooks, halls of fame, the generator's final state); so do the same
  runs under ``ResilientRun`` in segments of 1, 3 and ngen, whose meter
  rows equal the uninterrupted telemetered run's, and a run killed and
  resumed with telemetry journals every generation's row.
- The journal against the JAX package's: one injected ``ea_simple``
  generation gives the JAX meter row's ``nevals``, ``best`` and
  ``evaluated_frac`` bitwise and ``mean`` within ``fitness_stats``'
  1e-5·max|fitness| (bitwise here: OneMax sums are exact); across whole
  runs the sequence of row kinds and each row's key set equal the JAX
  run's, ``compile``/``retrace`` rows left out (the JAX journal counts
  XLA compiles, the port's ``nvcc`` builds: none on the CPU) and, for
  the GP loop, ``gp_interpreter_build`` rows (the JAX interpreter's jit
  cache, which the port does not have).
- ``compile`` and ``retrace`` rows around ``mark_steady`` when
  ``_build.build`` runs a stub compiler (no ``nvcc`` here).
- The raise list: no ``NotImplementedError`` naming A11 remains for
  ``telemetry=``, ``probes=``, ``metrics=`` or ``trace_every=``; the
  A11b items raise naming A11b.
- The program observatory's profile keys, its drift alarm and its seam.

Sizes: pop 40, L 16, ngen 5; GP pop 48, width 24.
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from deap_tpu_torch import (FitnessSpec, Toolbox, _build, algorithms,
                            benchmarks, ops)
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.resilience import FaultPlan, KillAt, ResilientRun
from deap_tpu_torch.resilience.faultinject import InjectedCrash
from deap_tpu_torch.support.stats import fitness_stats
from deap_tpu_torch.telemetry import (
    DiversityProbe, FitnessProbe, FrontProbe, HealthMonitor, MetricsRegistry,
    ProgramObservatory, QuarantineProbe, RunJournal, RunTelemetry,
    SelectionProbe, TreeDiversityProbe, costs, profile_compiled,
    read_journal, strategy_probe)

CPU = "cpu"
N, L, NGEN = 40, 16, 5
MU_C, LAM = 20, 60


def _rows_equal(x, y):
    """Logbook rows (dicts of host scalars or numpy arrays) bit for bit."""
    if len(x) != len(y):
        return False
    for rx, ry in zip(x, y):
        if list(rx) != list(ry):
            return False
        for k in rx:
            a, b = np.asarray(rx[k]), np.asarray(ry[k])
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                return False
    return True


def _bitwise(a, b):
    """Result trees bit for bit (``chip_smoke.same_tree``, with logbooks
    compared row by row)."""
    from deap_tpu_torch.support.checkpoint import tree_flatten
    la, sa = tree_flatten(a)
    lb, sb = tree_flatten(b)
    assert sa == sb and len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, list):
            assert _rows_equal(x, y)
        else:
            assert chip_smoke.same_tree(torch, x, y)


def _toolbox():
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


def _pop(g, n=N):
    return init_population(g, n, ops.bernoulli_genome(L), FitnessSpec((1.0,)),
                           device=CPU)


def _health():
    return HealthMonitor(clone_rate_max=0.5, diversity_floor=5.0,
                         stagnation_window=2)


def _cma():
    from deap_tpu_torch.strategies import Strategy
    strat = Strategy(torch.full((6,), 0.5), 0.5, lambda_=12, device=CPU)
    tb = Toolbox()
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    tb.register("evaluate", benchmarks.sphere)
    return strat, tb


def _mo_toolbox():
    from deap_tpu_torch import mo
    tb = Toolbox()
    tb.register("evaluate", lambda g: benchmarks.dtlz2(g, 3))
    tb.register("mate", ops.cx_simulated_binary_bounded, eta=20.0, low=0.0,
                up=1.0)
    tb.register("mutate", ops.mut_polynomial_bounded, eta=20.0, low=0.0,
                up=1.0, indpb=0.2)
    tb.register("select", mo.sel_nsga2)
    return tb


def _gp_parts():
    from deap_tpu_torch import gp
    pset = gp.math_set(1)
    X = torch.linspace(-1.0, 1.0, 17)[:-1, None]
    genomes = gp.gen_half_and_half(pset, 24, 1, 2)(make_generator(3, CPU), 48)
    return pset, X, genomes


LOOPS = ("ea_simple", "ea_mu_plus_lambda", "ea_mu_comma_lambda",
         "ea_generate_update", "nsga2", "gp_loop")


def _probes(name, pset=None):
    if name == "ea_simple":
        return (DiversityProbe(), FitnessProbe(), SelectionProbe(n=N),
                QuarantineProbe())
    if name == "ea_mu_plus_lambda":
        return (DiversityProbe(), FitnessProbe(), SelectionProbe(n=N))
    if name == "ea_mu_comma_lambda":
        return (DiversityProbe(), FitnessProbe(), SelectionProbe(n=MU_C))
    if name == "ea_generate_update":
        return (DiversityProbe(), FitnessProbe())
    if name == "nsga2":
        return (FrontProbe((-3.0, -3.0, -3.0)), SelectionProbe(n=N),
                DiversityProbe())
    return (TreeDiversityProbe(pset), FitnessProbe(), SelectionProbe(n=48))


def _run(name, g, tel=None, res=None):
    """One loop's run (through ``res`` when given), with ``tel`` and the
    loop's probes when ``tel`` is given."""
    kw = dict(stats=fitness_stats(), halloffame_size=3, device=CPU)
    probes = {}
    if tel is not None:
        probes = {"probes": _probes(name, _gp_parts()[0])}
    if res is None and tel is not None:
        kw["telemetry"] = tel
    tb = _toolbox()
    if name in ("ea_simple", "ea_mu_plus_lambda", "ea_mu_comma_lambda"):
        args = {"ea_simple": (0.5, 0.2, NGEN),
                "ea_mu_plus_lambda": (N, LAM, 0.4, 0.3, NGEN),
                "ea_mu_comma_lambda": (MU_C, LAM, 0.4, 0.3, NGEN)}[name]
        pop = _pop(g)
        fn = getattr(res, name) if res is not None else \
            getattr(algorithms, name)
        return fn(g, pop, tb, *args, **kw, **probes)
    if name == "nsga2":
        pop = init_population(g, N, ops.uniform_genome(8, 0.0, 1.0),
                              FitnessSpec((-1.0, -1.0, -1.0)), device=CPU)
        fn = res.ea_mu_plus_lambda if res is not None else \
            algorithms.ea_mu_plus_lambda
        return fn(g, pop, _mo_toolbox(), N, N, 0.6, 0.3, NGEN, **kw,
                  **probes)
    if name == "ea_generate_update":
        strat, ctb = _cma()
        if tel is not None and res is None:
            tel.probe = strategy_probe(strat)
        fn = res.ea_generate_update if res is not None else \
            algorithms.ea_generate_update
        return fn(g, strat.initial_state(), ctb, NGEN, strat.spec, **kw,
                  **probes)
    from deap_tpu_torch import gp
    pset, X, genomes = _gp_parts()
    run = gp.make_symbreg_loop(pset, 24, X, X[:, 0] ** 3 + X[:, 0],
                               height_limit=6, device=CPU, telemetry=tel,
                               **probes)
    if res is not None:
        return res.gp_loop(run, g, genomes, NGEN, device=CPU)
    return run(g, genomes, NGEN)


_BARE = {}


def _bare(name):
    if name not in _BARE:
        g = make_generator(11, CPU)
        out = _run(name, g)
        _BARE[name] = (out, g.get_state())
    return _BARE[name]


def _meter_rows(path):
    return [{k: v for k, v in r.items() if k != "t"}
            for r in read_journal(path) if r["kind"] == "meter"]


@pytest.mark.parametrize("name", LOOPS)
def test_telemetry_changes_nothing(tmp_path, name):
    want, want_gen = _bare(name)
    g = make_generator(11, CPU)
    path = str(tmp_path / "run.jsonl")
    with RunTelemetry(path, health=_health()) as tel:
        got = _run(name, g, tel)
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)
    rows = read_journal(path, strict=True)
    gens = [r["gen"] for r in rows if r["kind"] == "meter"]
    first = 0
    assert gens == list(range(first, NGEN + (0 if name ==
                                              "ea_generate_update" else 1)))
    names = set(_meter_rows(path)[-1])
    for p in _probes(name, _gp_parts()[0]):
        assert set(p.metric_names) <= names
    kinds = [r["kind"] for r in rows if r["kind"] != "span"]
    assert kinds[-3:] == ["run_end", "steady", "summary"]


@pytest.mark.parametrize("seg", [1, 3, NGEN])
@pytest.mark.parametrize("name", LOOPS)
def test_resilient_telemetry_changes_nothing(tmp_path, name, seg):
    want, want_gen = _bare(name)
    mono = str(tmp_path / "mono.jsonl")
    with RunTelemetry(mono) as tel:
        _run(name, make_generator(11, CPU), tel)
    g = make_generator(11, CPU)
    path = str(tmp_path / "seg.jsonl")
    with RunTelemetry(path, health=_health()) as tel:
        res = ResilientRun(str(tmp_path / "ck"), segment_len=seg,
                           telemetry=tel)
        if name == "ea_generate_update":
            tel.probe = strategy_probe(_cma()[0])
        got = _run(name, g, tel, res)
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)
    assert _meter_rows(path) == _meter_rows(mono)
    kinds = [r["kind"] for r in read_journal(path, strict=True)]
    assert kinds.count("segment") == -(-NGEN // seg)


def test_killed_and_resumed_run_journals_every_row(tmp_path):
    want, want_gen = _bare("ea_simple")
    mono = str(tmp_path / "mono.jsonl")
    with RunTelemetry(mono) as tel:
        _run("ea_simple", make_generator(11, CPU), tel)
    d = str(tmp_path / "ck")
    with RunTelemetry(str(tmp_path / "a.jsonl")) as tel:
        res = ResilientRun(d, segment_len=2, telemetry=tel,
                           fault_plan=FaultPlan([KillAt(4)]))
        with pytest.raises(InjectedCrash):
            _run("ea_simple", make_generator(11, CPU), tel, res)
    g = make_generator(11, CPU)
    path = str(tmp_path / "b.jsonl")
    with RunTelemetry(path) as tel:
        got = _run("ea_simple", g, tel, ResilientRun(d, segment_len=2,
                                                     telemetry=tel))
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)
    assert _meter_rows(path) == _meter_rows(mono)
    assert "resumed" in [r["kind"] for r in read_journal(path)]


def test_probes_need_telemetry(tmp_path):
    g = make_generator(0, CPU)
    tb = _toolbox()
    for call in (
            lambda: algorithms.ea_simple(g, _pop(g), tb, 0.5, 0.2, 1,
                                         probes=(FitnessProbe(),),
                                         device=CPU),
            lambda: algorithms.ea_mu_plus_lambda(g, _pop(g), tb, N, N, 0.5,
                                                 0.2, 1,
                                                 probes=(FitnessProbe(),),
                                                 device=CPU),
            lambda: ResilientRun(str(tmp_path / "ck")).ea_simple(
                g, _pop(g), tb, 0.5, 0.2, 1, probes=(FitnessProbe(),),
                device=CPU)):
        with pytest.raises(ValueError, match="requires telemetry"):
            call()


def test_stream_emits_a_live_row_each_generation(tmp_path, capsys):
    path = str(tmp_path / "live.jsonl")
    with RunTelemetry(path, stream=True) as tel:
        g = make_generator(1, CPU)
        algorithms.ea_simple(g, _pop(g), _toolbox(), 0.5, 0.2, 3,
                             telemetry=tel, device=CPU)
    rows = read_journal(path)
    assert [r["gen"] for r in rows if r["kind"] == "meter_live"] == \
        [0, 1, 2, 3]
    assert "[deap_tpu_torch] gen 3:" in capsys.readouterr().err


def test_strategy_probe_needs_metric_names():
    with pytest.raises(TypeError, match="metric_names"):
        strategy_probe(object())


# ------------------------------------------------ against the JAX package --

def test_injected_generation_gives_the_jax_meter_row():
    import jax
    import jax.numpy as jnp
    from deap_tpu import algorithms as jalg
    from deap_tpu import ops as jops
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    from deap_tpu.core.population import init_population as jinit
    from deap_tpu.core.toolbox import Toolbox as JToolbox
    from deap_tpu.ops import selection as jsel
    from deap_tpu.ops import variation as jvar
    from deap_tpu.telemetry import RunTelemetry as JTel
    from deap_tpu_torch import convert
    from deap_tpu_torch.ops import selection as tsel
    from deap_tpu_torch.telemetry import meter as tmeter
    import tempfile

    n, length = 301, 100
    jtb = JToolbox()
    jtb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    jtb.register("mate", jops.cx_two_point)
    jtb.register("mutate", jops.mut_flip_bit, indpb=0.05)
    jtb.register("select", jops.sel_tournament, tournsize=3)
    pop = jinit(jax.random.key(5), n, jops.bernoulli_genome(length),
                JSpec((1.0,)))
    pop, _, hof = jalg.ea_simple(jax.random.key(6), pop, jtb, 0.5, 0.2, 3,
                                 halloffame_size=2)
    key = jax.random.key(7)
    with tempfile.TemporaryDirectory() as d:
        jtel = JTel(os.path.join(d, "j.jsonl"))
        jtel.begin_run("ea_simple", declare=jalg._tel_declare)
        m0 = jtel.meter.init()
        step = jalg.make_ea_simple_step(jtb, 0.5, 0.2, None, jtel)
        (_, _, mstate), _ = jax.jit(step)((pop, hof, m0),
                                          (key, jnp.int32(1)))
        want = jtel.meter.row(mstate)
        jtel.journal.close()

        k_sel, k_var = jax.random.split(key)
        asp = jsel.tournament_aspirants(k_sel, n, n, 3)
        masks = jvar.var_and_masks(k_var, n, length, 0.5, 0.2,
                                   jvar.resolve_plan(jtb),
                                   pop.genomes.dtype)
        tpop = convert.population_from_arrays(pop.genomes, pop.fitness,
                                              pop.valid, pop.spec.weights,
                                              device=CPU)
        idx = tsel._tournament_winners(tpop.wvalues, torch.from_numpy(
            np.array(asp)).long())
        tmasks = tuple(torch.from_numpy(np.array(x)) for x in masks[:5])
        off = algorithms.var_and_apply(tpop, tmasks + (None,), "flip",
                                       "plain", sel_idx=idx)
        nevals = (~off.valid).sum()
        off = algorithms.evaluate_invalid(off, _toolbox().evaluate)
        ttel = RunTelemetry(os.path.join(d, "t.jsonl"))
        ttel.begin_run("ea_simple", declare=algorithms._tel_declare)
        got = ttel.meter.row(algorithms._tel_measure(
            ttel, ttel.meter.init(device=CPU), nevals, off, 1))
        ttel.journal.close()
    assert isinstance(ttel.meter, tmeter.Meter)
    for k in ("nevals", "best", "evaluated_frac"):
        assert got[k] == want[k], k
    assert abs(got["mean"] - want["mean"]) <= 1e-5 * abs(want["best"])


def _jax_onemax(name, tel, probes):
    import jax
    import jax.numpy as jnp
    from deap_tpu import algorithms as jalg
    from deap_tpu import ops as jops
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    from deap_tpu.core.population import init_population as jinit
    from deap_tpu.core.toolbox import Toolbox as JToolbox
    from deap_tpu.support.stats import fitness_stats as jstats

    tb = JToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    tb.register("mate", jops.cx_two_point)
    tb.register("mutate", jops.mut_flip_bit, indpb=0.1)
    tb.register("select", jops.sel_tournament, tournsize=3)
    pop = jinit(jax.random.key(0), N, jops.bernoulli_genome(L), JSpec((1.0,)))
    kw = dict(stats=jstats(), halloffame_size=3, telemetry=tel,
              probes=probes)
    if name == "ea_simple":
        jalg.ea_simple(jax.random.key(1), pop, tb, 0.5, 0.2, NGEN, **kw)
    else:
        jalg.ea_mu_plus_lambda(jax.random.key(1), pop, tb, N, LAM, 0.4, 0.3,
                               NGEN, **kw)


def _jax_cma(tel):
    import jax
    import jax.numpy as jnp
    from deap_tpu import algorithms as jalg
    from deap_tpu import benchmarks as jbm
    from deap_tpu.core.toolbox import Toolbox as JToolbox
    from deap_tpu.strategies import cma as jcma
    from deap_tpu.support.stats import fitness_stats as jstats
    from deap_tpu.telemetry import probes as jp
    from deap_tpu.telemetry import strategy_probe as jsp

    strat = jcma.Strategy(jnp.full((6,), 0.5), 0.5, lambda_=12)
    tb = JToolbox()
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    tb.register("evaluate", jax.vmap(jbm.sphere))
    tel.probe = jsp(strat)
    jalg.ea_generate_update(jax.random.key(1), strat.initial_state(), tb,
                            NGEN, strat.spec, stats=jstats(),
                            halloffame_size=3, telemetry=tel,
                            probes=(jp.DiversityProbe(), jp.FitnessProbe()))


def _jax_gp(tel):
    import jax
    from deap_tpu import gp as jgp
    from deap_tpu.telemetry import probes as jp

    pset = jgp.math_set(1)
    X = np.linspace(-1.0, 1.0, 17, dtype=np.float32)[:-1, None]
    gen = jgp.make_generator(pset, 24, 1, 2, "half_and_half")
    genomes = jax.vmap(gen)(jax.random.split(jax.random.key(3), 48))
    run = jgp.make_symbreg_loop(pset, 24, X, X[:, 0] ** 3 + X[:, 0],
                                height_limit=6, telemetry=tel,
                                probes=(jp.TreeDiversityProbe(pset),
                                        jp.FitnessProbe(),
                                        jp.SelectionProbe(n=48)))
    run(jax.random.key(4), genomes, NGEN)


def _shape(path, skip):
    """Each row's kind and key set (``t`` and the header's environment
    values aside), in order."""
    out = []
    for r in read_journal(path, strict=True):
        if r["kind"] in skip:
            continue
        out.append((r["kind"], tuple(sorted(r))))
    return out


@pytest.mark.parametrize("name", ["ea_simple", "ea_mu_plus_lambda",
                                  "ea_generate_update", "gp_loop"])
def test_journal_rows_match_the_jax_run(tmp_path, name, monkeypatch):
    import jax
    from deap_tpu.telemetry import RunTelemetry as JTel
    from deap_tpu.telemetry import probes as jp

    if name == "gp_loop" and not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)
    kw = dict(clone_rate_max=0.5, stagnation_window=2)
    jpath = str(tmp_path / "j.jsonl")
    with JTel(jpath, health=jp.HealthMonitor(**kw)) as jtel:
        if name == "ea_generate_update":
            _jax_cma(jtel)
        elif name == "gp_loop":
            _jax_gp(jtel)
        else:
            jprobes = (jp.DiversityProbe(), jp.FitnessProbe(),
                       jp.SelectionProbe(n=N))
            _jax_onemax(name, jtel, jprobes)
    tpath = str(tmp_path / "t.jsonl")
    with RunTelemetry(tpath, health=HealthMonitor(**kw)) as tel:
        g = make_generator(1, CPU)
        if name == "ea_simple":
            algorithms.ea_simple(g, _pop(g), _toolbox(), 0.5, 0.2, NGEN,
                                 stats=fitness_stats(), halloffame_size=3,
                                 telemetry=tel,
                                 probes=(DiversityProbe(), FitnessProbe(),
                                         SelectionProbe(n=N)), device=CPU)
        elif name == "ea_mu_plus_lambda":
            algorithms.ea_mu_plus_lambda(
                g, _pop(g), _toolbox(), N, LAM, 0.4, 0.3, NGEN,
                stats=fitness_stats(), halloffame_size=3, telemetry=tel,
                probes=(DiversityProbe(), FitnessProbe(),
                        SelectionProbe(n=N)), device=CPU)
        elif name == "ea_generate_update":
            strat, ctb = _cma()
            tel.probe = strategy_probe(strat)
            algorithms.ea_generate_update(
                g, strat.initial_state(), ctb, NGEN, strat.spec,
                stats=fitness_stats(), halloffame_size=3, telemetry=tel,
                probes=(DiversityProbe(), FitnessProbe()), device=CPU)
        else:
            from deap_tpu_torch import gp
            pset, X, genomes = _gp_parts()
            run = gp.make_symbreg_loop(
                pset, 24, X, X[:, 0] ** 3 + X[:, 0], height_limit=6,
                device=CPU, telemetry=tel,
                probes=(TreeDiversityProbe(pset), FitnessProbe(),
                        SelectionProbe(n=48)))
            run(g, genomes, NGEN)
    skip = {"compile", "retrace", "gp_interpreter_build", "alarm",
            "gp_dispatch"}
    want, got = _shape(jpath, skip), _shape(tpath, skip)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (kind, a), (_, b) in zip(got, want):
        assert a == b, kind
    # alarms and gp_dispatch rows come with the run's values (the two
    # runs draw different numbers); where both journal one of a kind, its
    # key set is the JAX package's
    def keysets(path):
        out = {}
        for r in read_journal(path):
            if r["kind"] in ("alarm", "gp_dispatch"):
                out.setdefault((r["kind"], r.get("alarm")), set()).add(
                    tuple(sorted(r)))
        return out

    want_ks, got_ks = keysets(jpath), keysets(tpath)
    for key in set(want_ks) & set(got_ks):
        assert got_ks[key] <= want_ks[key], key


def test_report_renders_a_port_journal(tmp_path):
    from deap_tpu.telemetry import report as jreport
    from deap_tpu_torch.telemetry import report as treport

    path = str(tmp_path / "run.jsonl")
    with RunTelemetry(path, health=_health()) as tel, \
            ProgramObservatory(journal=tel.journal):
        res = ResilientRun(str(tmp_path / "ck"), segment_len=2,
                           telemetry=tel, metrics=MetricsRegistry(),
                           trace_every=2)
        _run("ea_simple", make_generator(1, CPU), tel, res)
    text = jreport.render_report(path)
    assert "meter" in text.lower() or "gen" in text
    assert treport.render_report(path) == text


# --------------------------------------------------------- compile rows --

def test_compile_and_retrace_rows_around_mark_steady(tmp_path,
                                                     monkeypatch):
    stub = tmp_path / "nvcc"
    stub.write_text("#!" + sys.executable + "\n"
                    "import sys\n"
                    "out = sys.argv[sys.argv.index('-o') + 1]\n"
                    "open(out, 'wb').write(b'stub')\n"
                    "print('ptxas info: stub')\n")
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    path = str(tmp_path / "c.jsonl")
    with RunJournal(path) as j:
        j.header(init_backend=False)
        secs = _build.build(["fused_variation", "dominance"])
        assert _build.build(["fused_variation"]) == {"fused_variation": 0.0}
        j.mark_steady("warm")
        _build.build(["gp_grouped"])
        j.summary()
    rows = read_journal(path, strict=True)
    comp = [r for r in rows if r["kind"] in ("compile", "retrace")]
    assert [(r["kind"], r["library"], r["seq"]) for r in comp] == [
        ("compile", "fused_variation", 1), ("compile", "dominance", 2),
        ("retrace", "gp_grouped", 3)]
    assert comp[2]["after"] == "warm"
    assert {"dur_s", "seq"} <= set(comp[0])
    assert rows[-1]["n_compiles"] == 3 and rows[-1]["n_retraces"] == 1
    assert [r["kind"] for r in rows].index("steady") == 3
    assert all(s > 0 for s in secs.values())


# -------------------------------------------------------- the raise list --

def test_no_telemetry_option_raises_naming_a11(tmp_path):
    """``telemetry=``, ``probes=``, ``metrics=`` and ``trace_every=`` are
    accepted everywhere the JAX package takes them."""
    tel = RunTelemetry(str(tmp_path / "t.jsonl"))
    res = ResilientRun(str(tmp_path / "ck"), telemetry=tel,
                       metrics=MetricsRegistry(), trace_every=2)
    assert res.telemetry is tel and res.trace_every == 2
    g = make_generator(0, CPU)
    strat, ctb = _cma()
    algorithms.ea_generate_update(g, strat.initial_state(), ctb, 1,
                                  strat.spec, telemetry=tel,
                                  probes=(FitnessProbe(),), device=CPU)
    from deap_tpu_torch import gp
    pset, X, _ = _gp_parts()
    gp.make_symbreg_loop(pset, 24, X, X[:, 0], device=CPU, telemetry=tel,
                         probes=(TreeDiversityProbe(pset),))
    tel.journal.close()
    src = os.path.join(os.path.dirname(_build.__file__))
    for root, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "A11)" not in text and "A11\")" not in text, f


@pytest.mark.parametrize("what", ["segment_len", "gp_mode", "eigh_impl"])
def test_a11b_items_raise_naming_a11b(tmp_path, what):
    """A11b is ported: each 'auto' resolves to the JAX package's static
    default with no tuner (segment_len 10, gp_mode 'scan', eigh_impl
    'lapack')."""
    if what == "segment_len":
        got = ResilientRun(str(tmp_path / "ck"),
                           segment_len="auto").segment_len
        assert got == 10
    elif what == "gp_mode":
        from deap_tpu_torch import gp
        got = gp.make_batch_interpreter(gp.math_set(1), 16, mode="auto")
        assert got.mode == "scan"
    else:
        from deap_tpu_torch.strategies import Strategy
        got = Strategy(torch.zeros(3), 1.0, eigh_impl="auto", device=CPU)
        assert got.eigh_impl == "lapack"


# --------------------------------------------------------- observatory --

def test_observatory_profiles_and_drift(tmp_path, monkeypatch):
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    wrapped = costs.instrument(fn, "prog")
    assert wrapped(torch.ones(3), 2).tolist() == [2.0] * 3  # inactive
    path = str(tmp_path / "o.jsonl")
    health = HealthMonitor()
    with RunJournal(path) as j, ProgramObservatory(journal=j,
                                                   health=health) as obs:
        wrapped(torch.ones(3), 2)
        wrapped(torch.ones(3), 2)  # the same signature: not profiled again
        wrapped(torch.ones(4), 2)  # a second signature: no drift
        assert len(obs.profiles) == 2 and not obs.drifts
        # the same (label, signature) launching other kernels: drift
        names = iter([["k_a", "k_b"], ["k_a", "k_c"], ["k_d"]])

        class _Evt:
            def __init__(self, name):
                self.name = name

        monkeypatch.setattr(costs, "_kernel_events",
                            lambda prof: [_Evt(x) for x in next(names)])
        w2 = costs.instrument(fn, "prog2")
        w3 = costs.instrument(fn, "prog2")
        w2(torch.ones(2), 1)
        w3(torch.ones(2), 1)
        out, prof = profile_compiled("prog3", fn, torch.ones(2), 3)
    assert out.tolist() == [3.0, 3.0] and prof["label"] == "prog3"
    assert len(obs.drifts) == 1 and health.alarms[0]["alarm"] == "hlo_drift"
    rows = read_journal(path)
    profs = [r for r in rows if r["kind"] == "program_profile"]
    assert len(profs) == 5
    assert {"label", "kernel_hash", "build_hash", "compile_s", "kernels",
            "n_launches", "kernel_us", "device_us"} <= set(profs[0])
    for absent in ("hlo_hash", "flops", "bytes_accessed", "aliased_bytes"):
        assert absent not in profs[0]
    assert [r["alarm"] for r in rows if r["kind"] == "alarm"] == ["hlo_drift"]
    assert calls == [2, 2, 2, 2, 1, 1, 3]
    assert profile_compiled("p", fn, torch.ones(1), 1)[1] is None
