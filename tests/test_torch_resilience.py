"""The port's ResilientRun, held against the port's uninterrupted loops
and against the JAX package's engine.

- Each of the five loops (``ea_simple``, ``ea_mu_plus_lambda``,
  ``ea_mu_comma_lambda``, ``ea_generate_update`` on Hansen CMA-ES and the
  GP loop) run in segments of 1, 3, ngen and ngen + 5 generations equals
  the port's uninterrupted run bit for bit; so does a run killed before
  or after a save (``KillAt``), preempted by a real SIGTERM
  (``PreemptAt``) or whose newest checkpoint was corrupted
  (``CorruptCheckpoint``), then resumed with a fresh generator made from
  the same seed, which ends in the uninterrupted run's state.
- Retry: backoff with ``degraded`` rows, an exhausted budget raises, a
  fatal error propagates unretried, a retried segment draws what the
  failed attempt drew; ``classify_error`` on the JAX package's
  vocabulary plus CUDA out-of-memory (retried) and sticky CUDA errors
  (fatal).
- Double buffering: the same results and leaf-for-leaf equal files as
  synchronous saves; the snapshot is immune to in-place writes; a fault
  plan forces synchronous saves; ``tenant_id`` is stamped and filtered.
- Parity with the JAX engine for the same ngen, segment length and
  fault plan: the same fault-event log (paths relative), the same
  journal rows (kind, lo, hi, step, attempt) and the same checkpoint
  steps; ``quarantine_non_finite`` equals the JAX wrapper bit for bit on
  NaN and ±inf rows; ``RetryPolicy.delay`` gives the JAX sequence.
- What is not ported raises, naming its ROADMAP item.

Sizes: pop 64, L 16, ngen 7; GP pop 64, width 32. Tolerance: bitwise.
"""

import os
import signal

import numpy as np
import pytest
import torch

import chip_smoke
from deap_tpu_torch import FitnessSpec, Toolbox, algorithms, ops
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.resilience import (
    QUARANTINE_PENALTY,
    CorruptCheckpoint,
    DrainSignal,
    FailSegments,
    FaultPlan,
    InjectedCrash,
    InjectedTransient,
    KillAt,
    Preempted,
    PreemptAt,
    ResilientRun,
    RetryPolicy,
    classify_error,
    nan_inject_evaluate,
    quarantine_non_finite,
)
from deap_tpu_torch.resilience import engine as teng
from deap_tpu_torch.resilience.faultinject import corrupt_pytree
from deap_tpu_torch.support.checkpoint import (AsyncCheckpointWriter,
                                               Checkpointer)
from deap_tpu_torch.support.stats import fitness_stats
from deap_tpu_torch.telemetry import RunJournal, read_journal

CPU = "cpu"
NGEN = 7
SEG = 3  # does not divide NGEN: the last segment is short


def _toolbox():
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


def _pop(n=64, length=16, seed=0):
    return init_population(make_generator(seed, CPU), n,
                           ops.bernoulli_genome(length), FitnessSpec((1.0,)),
                           device=CPU)


def _bitwise(a, b):
    assert chip_smoke.same_tree(torch, a, b)


# ---------------------------------------------------- the five loops ----
#
# Each loop is a pair: uninterrupted(generator), resilient(res, generator).

def _cma():
    from deap_tpu_torch import benchmarks
    from deap_tpu_torch.strategies import Strategy

    strat = Strategy(torch.full((6,), 0.5), 0.5, lambda_=12, device=CPU)
    tb = Toolbox()
    tb.register("generate", strat.generate)
    tb.register("update", strat.update)
    tb.register("evaluate", benchmarks.sphere)
    return strat, tb


def _gp():
    from deap_tpu_torch import gp

    pset = gp.math_set(1)
    X = torch.linspace(-1.0, 1.0, 33)[:-1, None]
    genomes = gp.gen_half_and_half(pset, 32, 1, 2)(make_generator(3, CPU),
                                                    64)
    run = gp.make_symbreg_loop(pset, 32, X, X[:, 0] ** 3 + X[:, 0],
                               height_limit=6, device=CPU)
    return run, genomes


def _loop(name):
    tb, stats = _toolbox(), fitness_stats()
    kw = dict(stats=stats, halloffame_size=4, device=CPU)
    if name == "ea_simple":
        return (
            lambda g: algorithms.ea_simple(g, _pop(), tb, 0.5, 0.2, NGEN,
                                           **kw),
            lambda r, g: r.ea_simple(g, _pop(), tb, 0.5, 0.2, NGEN, **kw))
    if name == "ea_mu_plus_lambda":
        return (
            lambda g: algorithms.ea_mu_plus_lambda(
                g, _pop(), tb, 64, 128, 0.4, 0.3, NGEN, **kw),
            lambda r, g: r.ea_mu_plus_lambda(g, _pop(), tb, 64, 128, 0.4,
                                             0.3, NGEN, **kw))
    if name == "ea_mu_comma_lambda":
        return (
            lambda g: algorithms.ea_mu_comma_lambda(
                g, _pop(), tb, 32, 96, 0.4, 0.3, NGEN, **kw),
            lambda r, g: r.ea_mu_comma_lambda(g, _pop(), tb, 32, 96, 0.4,
                                              0.3, NGEN, **kw))
    if name == "ea_generate_update":
        def plain(g):
            strat, ctb = _cma()
            return algorithms.ea_generate_update(
                g, strat.initial_state(), ctb, NGEN, strat.spec, **kw)

        def resilient(r, g):
            strat, ctb = _cma()
            return r.ea_generate_update(g, strat.initial_state(), ctb, NGEN,
                                        strat.spec, **kw)

        return plain, resilient
    assert name == "gp_loop"

    def plain_gp(g):
        run, genomes = _gp()
        return run(g, genomes, NGEN)

    def resilient_gp(r, g):
        run, genomes = _gp()
        return r.gp_loop(run, g, genomes, NGEN, device=CPU)

    return plain_gp, resilient_gp


LOOPS = ("ea_simple", "ea_mu_plus_lambda", "ea_mu_comma_lambda",
         "ea_generate_update", "gp_loop")
_REFERENCE = {}


def _reference(name):
    """The uninterrupted run's result and its generator's final state."""
    if name not in _REFERENCE:
        g = make_generator(11, CPU)
        out = _loop(name)[0](g)
        _REFERENCE[name] = (out, g.get_state())
    return _REFERENCE[name]


@pytest.mark.parametrize("seg", [1, SEG, NGEN, NGEN + 5])
@pytest.mark.parametrize("name", LOOPS)
def test_segmented_equals_uninterrupted(tmp_path, name, seg):
    want, want_gen = _reference(name)
    g = make_generator(11, CPU)
    res = ResilientRun(str(tmp_path / "ck"), segment_len=seg)
    got = _loop(name)[1](res, g)
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)
    assert res.ckpt.latest_step() == NGEN


FAULTS = {
    "kill_before_save": lambda: KillAt(4, "before_save"),
    "kill_after_save": lambda: KillAt(4, "after_save"),
    "sigterm": lambda: PreemptAt(4),
    "corrupt_newest": lambda: CorruptCheckpoint(4),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", LOOPS)
def test_fault_then_resume_equals_uninterrupted(tmp_path, name, fault):
    want, want_gen = _reference(name)
    d = str(tmp_path / "ck")
    first = ResilientRun(d, segment_len=2,
                         fault_plan=FaultPlan([FAULTS[fault]()]))
    with pytest.raises((InjectedCrash, Preempted)):
        _loop(name)[1](first, make_generator(11, CPU))
    steps = Checkpointer(d).steps()
    assert steps == {"kill_before_save": [2], "kill_after_save": [2, 4],
                     "sigterm": [2, 4], "corrupt_newest": [2, 4]}[fault]
    g = make_generator(11, CPU)  # a fresh process's generator
    res = ResilientRun(d, segment_len=2)
    got = _loop(name)[1](res, g)
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)
    assert res.resumed_from == first.run_id


# ------------------------------------------------------- preemption ----

def test_sigterm_preempts_journals_and_resumes(tmp_path):
    tb = _toolbox()
    want, _ = _reference("ea_simple")
    d = str(tmp_path / "ck")
    jpath = str(tmp_path / "j.jsonl")
    with RunJournal(jpath):
        res = ResilientRun(d, segment_len=2,
                           fault_plan=FaultPlan([PreemptAt(4)]))
        with pytest.raises(Preempted) as exc:
            res.ea_simple(make_generator(11, CPU), _pop(), tb, 0.5, 0.2,
                          NGEN, stats=fitness_stats(), halloffame_size=4,
                          device=CPU)
    assert exc.value.step == 4 and exc.value.signum == signal.SIGTERM
    assert os.path.exists(exc.value.path)
    assert [r for r in read_journal(jpath) if r["kind"] == "preempted"]
    assert signal.getsignal(signal.SIGTERM) is not None


def test_resume_journals_run_id_chain(tmp_path):
    tb = _toolbox()
    d = str(tmp_path / "ck")
    with pytest.raises(Preempted):
        ResilientRun(d, segment_len=2, run_id="first",
                     fault_plan=FaultPlan([PreemptAt(2)])).ea_simple(
            make_generator(6, CPU), _pop(), tb, 0.5, 0.2, NGEN, device=CPU)
    jpath = str(tmp_path / "b.jsonl")
    with RunJournal(jpath):
        res2 = ResilientRun(d, segment_len=2)
        res2.ea_simple(make_generator(6, CPU), _pop(), tb, 0.5, 0.2, NGEN,
                       device=CPU)
    assert res2.resumed_from == "first"
    resumed = [r for r in read_journal(jpath) if r["kind"] == "resumed"]
    assert resumed and resumed[0]["resumed_from"] == "first"
    assert resumed[0]["step"] == 2


def test_refuses_resume_of_different_algorithm(tmp_path):
    tb = _toolbox()
    d = str(tmp_path / "ck")
    with pytest.raises(Preempted):
        ResilientRun(d, segment_len=2,
                     fault_plan=FaultPlan([PreemptAt(2)])).ea_simple(
            make_generator(8, CPU), _pop(), tb, 0.5, 0.2, NGEN, device=CPU)
    with pytest.raises(ValueError, match="refusing to resume"):
        ResilientRun(d, segment_len=2).ea_mu_comma_lambda(
            make_generator(8, CPU), _pop(), tb, 64, 128, 0.4, 0.3, NGEN,
            device=CPU)


# --------------------------------------------------- failure handling ----

def test_transient_retry_backoff_and_degraded_events(tmp_path):
    want, want_gen = _reference("ea_simple")
    tb = _toolbox()
    jpath = str(tmp_path / "j.jsonl")
    sleeps, degrades = [], []
    g = make_generator(11, CPU)
    with RunJournal(jpath):
        res = ResilientRun(
            str(tmp_path / "ck"), segment_len=2,
            retry=RetryPolicy(max_retries=3, backoff_s=0.01,
                              sleep=sleeps.append),
            degrade_cb=lambda kind, exc: degrades.append(kind)
            or "halved eval batch",
            fault_plan=FaultPlan([FailSegments(lo=2, times=2)]))
        got = res.ea_simple(g, _pop(), tb, 0.5, 0.2, NGEN,
                            stats=fitness_stats(), halloffame_size=4,
                            device=CPU)
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)
    assert degrades == ["resource_exhausted"] * 2
    assert len(sleeps) == 2 and sleeps[1] > sleeps[0]
    degraded = [r for r in read_journal(jpath) if r["kind"] == "degraded"]
    assert len(degraded) == 2
    assert degraded[0]["error_kind"] == "resource_exhausted"
    assert degraded[0]["action"] == "halved eval batch"


def test_retry_draws_what_the_failed_attempt_drew(tmp_path):
    """A CUDA out-of-memory error in the middle of a segment, after the
    segment has drawn: the retry puts the generator back where the
    segment began, so the run still equals the uninterrupted one."""
    want, want_gen = _reference("ea_simple")
    tb = _toolbox()
    real = algorithms.make_ea_simple_step
    calls = []

    def flaky_step(*a, **kw):
        step = real(*a, **kw)

        def wrapped(g, pop, hof):
            calls.append(1)
            out = step(g, pop, hof)
            if len(calls) == 4:  # the second generation of segment [2, 4)
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 2.00 GiB")
            return out

        return wrapped

    g = make_generator(11, CPU)
    res = ResilientRun(str(tmp_path / "ck"), segment_len=2,
                       retry=RetryPolicy(sleep=lambda s: None))
    try:
        algorithms.make_ea_simple_step = flaky_step
        got = res.ea_simple(g, _pop(), tb, 0.5, 0.2, NGEN,
                            stats=fitness_stats(), halloffame_size=4,
                            device=CPU)
    finally:
        algorithms.make_ea_simple_step = real
    assert len(calls) == NGEN + 2
    _bitwise(want, got)
    assert torch.equal(g.get_state(), want_gen)


def test_retry_budget_exhausted_raises(tmp_path):
    res = ResilientRun(
        str(tmp_path / "ck"), segment_len=2,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0, sleep=lambda s: None),
        fault_plan=FaultPlan([FailSegments(lo=0, times=5)]))
    with pytest.raises(InjectedTransient):
        res.ea_simple(make_generator(10, CPU), _pop(), _toolbox(), 0.5, 0.2,
                      NGEN, device=CPU)


def test_fatal_error_propagates_unretried(tmp_path):
    attempts = []

    class _Boom(FaultPlan):
        def fire(self, event, **ctx):
            if event == "segment_attempt":
                attempts.append(ctx["attempt"])
                raise RuntimeError("CUDA error: an illegal memory access "
                                   "was encountered")

    jpath = str(tmp_path / "j.jsonl")
    with RunJournal(jpath):
        res = ResilientRun(str(tmp_path / "ck"), segment_len=2,
                           fault_plan=_Boom())
        with pytest.raises(RuntimeError, match="illegal memory access"):
            res.ea_simple(make_generator(11, CPU), _pop(), _toolbox(), 0.5,
                          0.2, NGEN, device=CPU)
    assert attempts == [0]
    failed = [r for r in read_journal(jpath) if r["kind"] == "segment_failed"]
    assert failed and failed[0]["error_kind"] == "fatal"


def test_classify_error_vocabulary():
    assert classify_error(
        RuntimeError("RESOURCE_EXHAUSTED: oom")) == "resource_exhausted"
    assert classify_error(
        RuntimeError("Out of memory allocating 1g")) == "resource_exhausted"
    assert classify_error(
        RuntimeError("UNAVAILABLE: socket closed")) == "transient"
    assert classify_error(ValueError("bad shape")) is None
    assert classify_error(AssertionError("x")) is None
    assert classify_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB (GPU 0; 79.11 GiB "
        "total capacity)")) == "resource_exhausted"
    for sticky in ("CUDA error: an illegal memory access was encountered",
                   "CUDA error: device-side assert triggered",
                   "CUDA error: unspecified launch failure"):
        assert classify_error(RuntimeError(sticky)) is None


# ---------------------------------------------------------- quarantine ----

def test_quarantine_equals_the_jax_wrapper_and_journals(tmp_path):
    import jax.numpy as jnp
    from deap_tpu.resilience import engine as jeng

    rng = np.random.default_rng(5)
    values = rng.standard_normal((64, 2)).astype(np.float32)
    values[3, 0], values[5, 1] = np.nan, np.inf
    values[9] = -np.inf
    vec = values[:, 0].copy()
    for v in (values, vec):
        want = np.asarray(jeng.quarantine_non_finite(
            lambda x: x, journal=False)(jnp.asarray(v)))
        got = quarantine_non_finite(lambda x: x)(torch.from_numpy(v))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(want.view(np.uint32),
                                      got.numpy().view(np.uint32))
    assert float(got[3]) == np.float32(QUARANTINE_PENALTY)
    jpath = str(tmp_path / "q.jsonl")
    wrapped = quarantine_non_finite(
        nan_inject_evaluate(lambda g: g.sum(-1).to(torch.float32), [3, 5]))
    with RunJournal(jpath):
        vals = wrapped(_pop().genomes)
    assert bool(torch.isfinite(vals).all())
    assert vals[3] == np.float32(QUARANTINE_PENALTY) == vals[5]
    q = [r for r in read_journal(jpath) if r["kind"] == "quarantine"]
    assert q and q[0]["n"] == 2


def test_quarantine_reads_nothing_back_without_a_journal(monkeypatch):
    """With no journal open, the wrapper never moves its count to the
    host (on the card that read would stop the host every evaluation)."""
    reads = []
    monkeypatch.setattr(teng, "int", lambda x: reads.append(x) or 0,
                        raising=False)
    wrapped = quarantine_non_finite(nan_inject_evaluate(
        lambda g: g.sum(-1).to(torch.float32), [1]))
    assert wrapped(_pop().genomes)[1] == np.float32(QUARANTINE_PENALTY)
    assert reads == []


def test_fault_helpers_on_tensors():
    x = {"a": [torch.arange(4, dtype=torch.int32)], "b": 2}
    y = corrupt_pytree(x)
    assert torch.equal(x["a"][0], torch.arange(4, dtype=torch.int32))
    assert int(y["a"][0][0]) == 0xA5 and y["b"] == 2
    out = nan_inject_evaluate(lambda g: g, [0, 2])(torch.ones(3, 2))
    assert torch.isnan(out[[0, 2]]).all() and not torch.isnan(out[1]).any()


# ------------------------------------------------ double-buffered saves ----

def test_double_buffer_matches_sync_results_and_checkpoints(tmp_path):
    results = {}
    for db in (False, True):
        res = ResilientRun(str(tmp_path / f"ck_{db}"), segment_len=SEG,
                           double_buffer=db)
        assert res.double_buffer is db
        results[db] = _loop("ea_simple")[1](res, make_generator(11, CPU))
    _bitwise(results[False], results[True])
    for step in (6, NGEN):
        s1 = Checkpointer(str(tmp_path / "ck_False")).restore(step, CPU)
        s2 = Checkpointer(str(tmp_path / "ck_True")).restore(step, CPU)
        s1.pop("_resilience")  # carries each run's id
        s2.pop("_resilience")
        _bitwise(s1, s2)


def test_double_buffer_resume_bit_exact(tmp_path):
    want, _ = _reference("ea_simple")
    res = ResilientRun(str(tmp_path / "ck"), segment_len=SEG)
    assert res.double_buffer
    res.preempt_requested = True  # honoured after the first segment
    with pytest.raises(Preempted):
        _loop("ea_simple")[1](res, make_generator(11, CPU))
    assert res.ckpt.latest_step() == SEG  # the background write landed
    got = _loop("ea_simple")[1](ResilientRun(str(tmp_path / "ck"),
                                             segment_len=SEG),
                                make_generator(11, CPU))
    _bitwise(want, got)


def test_async_writer_snapshot_immune_to_mutation(tmp_path):
    ck = Checkpointer(str(tmp_path / "ck"))
    writer = AsyncCheckpointWriter()
    g = make_generator(2, CPU)
    vals = torch.arange(4)
    state = {"gen": 3, "vals": vals, "log": [1, 2], "generator": g}
    want_gen = g.get_state()
    writer.submit(ck, 3, state, meta={"m": 1})
    state["gen"] = 99
    state["log"].append(777)
    vals.add_(100)  # the next segment writes into the same tensor
    torch.rand(8, generator=g)
    writer.wait()
    got = ck.restore(3, CPU)
    assert got["gen"] == 3 and got["log"] == [1, 2]
    assert torch.equal(got["vals"], torch.arange(4))
    assert torch.equal(got["generator"].get_state(), want_gen)
    assert ck.meta(3)["m"] == 1


def test_async_writer_error_surfaces_on_wait(tmp_path):
    class _Boom(Checkpointer):
        def save(self, *a, **kw):
            raise OSError("disk gone")

    writer = AsyncCheckpointWriter()
    writer.submit(_Boom(str(tmp_path / "ck")), 1, {"x": 1})
    with pytest.raises(OSError, match="disk gone"):
        writer.wait()
    ck = Checkpointer(str(tmp_path / "ck2"))
    writer.submit(ck, 2, {"x": 2})
    writer.wait()
    assert ck.restore(2, CPU) == {"x": 2}


def test_fault_plan_forces_synchronous_saves(tmp_path):
    assert ResilientRun(str(tmp_path / "a"),
                        fault_plan=FaultPlan()).double_buffer is False
    assert ResilientRun(str(tmp_path / "b")).double_buffer is True


def test_tenant_id_round_trip_and_filter(tmp_path):
    d = str(tmp_path / "ckpt")
    tb = _toolbox()
    run = lambda r: r.ea_simple(make_generator(1, CPU), _pop(32, 8), tb, 0.5,
                                0.2, 4, device=CPU)
    p1, _, _ = run(ResilientRun(d, segment_len=2, tenant_id="alice",
                                double_buffer=False))
    assert Checkpointer(d).meta()["tenant_id"] == "alice"
    res2 = ResilientRun(d, segment_len=2, tenant_id="alice")
    p2, _, _ = run(res2)
    assert torch.equal(p1.genomes, p2.genomes)
    assert res2.resumed_from is not None
    res3 = ResilientRun(d, segment_len=2, tenant_id="mallory")
    assert res3.ckpt.restore_latest(tenant_id="mallory", device=CPU) is None


# ----------------------------------------------------- not ported yet ----

@pytest.mark.parametrize("what,item", [
    ("telemetry", "A11"), ("metrics", "A11"), ("trace_every", "A11"),
    ("segment_len", "A11"), ("probes", "A11"), ("plan", "A12"),
    ("island_run", "A12"), ("multirun", "A13")])
def test_not_ported_raises_naming_its_item(tmp_path, what, item):
    """What is not ported raises naming its ROADMAP item. ``telemetry=``,
    ``metrics=``, ``trace_every=`` and ``probes=`` are ported (A11):
    accepted, and probes without telemetry is the JAX engine's
    ValueError; the tuner's ``segment_len="auto"`` is ported (A11b): 10
    with no tuner."""
    d = str(tmp_path / "ck")
    if what in ("telemetry", "metrics", "trace_every"):
        from deap_tpu_torch.telemetry import MetricsRegistry, RunTelemetry
        value = {"telemetry": RunTelemetry(str(tmp_path / "t.jsonl")),
                 "metrics": MetricsRegistry(), "trace_every": 2}[what]
        res = ResilientRun(d, **{what: value})
        got = {"telemetry": res.telemetry, "trace_every": res.trace_every,
               "metrics": res._metrics}[what]
        assert got is value or got == value
        if what == "telemetry":
            value.journal.close()
        return
    if what == "probes":
        with pytest.raises(ValueError, match="requires telemetry"):
            ResilientRun(d).ea_simple(make_generator(0, CPU), _pop(),
                                      _toolbox(), 0.5, 0.2, 1,
                                      probes=(object(),), device=CPU)
        return
    if what == "segment_len":
        assert ResilientRun(d, segment_len="auto").segment_len == 10
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        if what == "island_run":
            ResilientRun(d).island_run(None, None, None, 1)
        elif what == "multirun":
            ResilientRun(d).multirun(None, [], [], 1)
        elif what == "probes":
            ResilientRun(d).ea_simple(make_generator(0, CPU), _pop(),
                                      _toolbox(), 0.5, 0.2, 1,
                                      probes=(object(),), device=CPU)
        else:
            value = {"telemetry": object(), "metrics": True,
                     "trace_every": 2, "segment_len": "auto",
                     "plan": object()}[what]
            ResilientRun(d, **{what: value})


# ------------------------------------------- parity with the JAX engine ----

JOURNAL_KINDS = ("segments_begin", "segment", "resumed", "degraded",
                 "segment_failed", "preempted", "checkpoint",
                 "checkpoint_corrupt", "checkpoint_fallback",
                 "checkpoint_restore")
PLANS = {
    "none": lambda m: [],
    "kill_before_save": lambda m: [m.KillAt(4)],
    "kill_after_save": lambda m: [m.KillAt(4, "after_save")],
    "corrupt": lambda m: [m.CorruptCheckpoint(4)],
    "transient": lambda m: [m.FailSegments(lo=2, times=2)],
    "sigterm": lambda m: [m.PreemptAt(4)],
}


def _engine_trace(tmp_path, which, plan, journal_cls, run):
    """Run one engine under ``plan``, then resume once without it;
    return the first run's fault log, the journal rows of both runs and
    the checkpoint steps."""
    d = str(tmp_path / which / "ck")
    os.makedirs(d)
    jpath = str(tmp_path / which / "j.jsonl")
    with journal_cls(jpath):
        first = run(d, plan, True)
        run(d, None, False)
    for row in first.log:
        if "path" in row:
            row["path"] = os.path.relpath(row["path"], d)
    rows = []
    for r in read_journal(jpath):
        if r["kind"] not in JOURNAL_KINDS:
            continue
        keep = {k: r[k] for k in ("kind", "lo", "hi", "step", "attempt",
                                  "error_kind", "async_save", "fallback")
                if k in r}
        if "path" in r:
            keep["file"] = os.path.basename(r["path"])
        rows.append(keep)
    return first.log, rows, Checkpointer(d).steps()


@pytest.mark.parametrize("plan", list(PLANS))
def test_engine_matches_the_jax_engine(tmp_path, plan):
    import jax
    import jax.numpy as jnp
    from deap_tpu import ops as jops
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    from deap_tpu.core.population import init_population as jinit
    from deap_tpu.core.toolbox import Toolbox as JToolbox
    from deap_tpu.resilience import faultinject as jfi
    from deap_tpu.resilience.engine import ResilientRun as JRun
    from deap_tpu.resilience.engine import RetryPolicy as JRetry
    from deap_tpu.telemetry import RunJournal as JJournal
    from deap_tpu_torch.resilience import faultinject as tfi

    jtb = JToolbox()
    jtb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    jtb.register("mate", jops.cx_two_point)
    jtb.register("mutate", jops.mut_flip_bit, indpb=0.1)
    jtb.register("select", jops.sel_tournament, tournsize=3)
    jpop = jinit(jax.random.key(0), 32, jops.bernoulli_genome(8),
                 JSpec((1.0,)))
    tb = _toolbox()

    def run(mod, Run, Retry, call):
        def go(d, faults, first):
            fp = mod.FaultPlan(PLANS[plan](mod) if faults is not None else [])
            res = Run(d, segment_len=2, fault_plan=fp,
                      retry=Retry(sleep=lambda s: None))
            try:
                call(res)
            except (mod.InjectedCrash, Exception) as e:
                if not first or type(e).__name__ not in (
                        "InjectedCrash", "Preempted"):
                    raise
            return fp
        return go

    jax_trace = _engine_trace(
        tmp_path, "jax", plan, JJournal,
        run(jfi, JRun, JRetry,
            lambda r: r.ea_simple(jax.random.key(1), jpop, jtb, 0.5, 0.2,
                                  ngen=NGEN)))
    port_trace = _engine_trace(
        tmp_path, "port", plan, RunJournal,
        run(tfi, ResilientRun, RetryPolicy,
            lambda r: r.ea_simple(make_generator(1, CPU), _pop(32, 8), tb,
                                  0.5, 0.2, NGEN, device=CPU)))
    assert port_trace[0] == jax_trace[0]  # the fault-event log
    assert port_trace[1] == jax_trace[1]  # the journal rows
    assert port_trace[2] == jax_trace[2]  # the checkpoint steps
    assert port_trace[1]  # the comparison saw rows


def test_retry_policy_delay_equals_the_jax_sequence():
    from deap_tpu.resilience.retry import RetryPolicy as JRetry

    for kw in ({}, {"jitter": 0.5, "seed": 7}, {"jitter": 0.3, "seed": None,
                                               "max_backoff_s": 0.2}):
        if kw.get("seed", 0) is None:
            kw = dict(kw, seed=3)
        a, b = JRetry(**kw), RetryPolicy(**kw)
        assert [a.delay(i) for i in range(8)] == [b.delay(i) for i in range(8)]


def test_drain_signal_routes_sigterm_once():
    seen = []
    with DrainSignal(seen.append, signals=(signal.SIGUSR1,)) as ds:
        signal.raise_signal(signal.SIGUSR1)
        signal.raise_signal(signal.SIGUSR1)
    assert seen == [signal.SIGUSR1] and ds.fired == signal.SIGUSR1
