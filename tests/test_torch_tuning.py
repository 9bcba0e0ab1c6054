"""The port's dispatch tuner held to the JAX package's contract, on the CPU.

Probe winners round-trip through the JSON cache across processes (the
cache file stays stdlib-readable), the invalidation ladder works (format
stamp, torch stamp, drift eviction directly and through the program
observatory), a warm cache replays a decision without probing, the env
escape hatches override everything, and tuned dispatch equals every
forced candidate's bit for bit at every decision point (``nd_rank``, the
GP interpreter mode, compaction, fused variation; CMA ``eigh`` through
its reconstruction check). Against the JAX package: the helpers agree on
a grid, the two caches write the same JSON for the same operations, a
``tuning_decision`` row has the JAX row's keys, and with the tuner off
each ``'auto'`` gives the JAX package's results.
"""

import json
import os
import subprocess
import sys

import jax
import jax._src.core
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import tuning as jtuning
from deap_tpu.mo import emo as jemo
from deap_tpu.strategies import cma as jcma
from deap_tpu.telemetry.journal import RunJournal as JRunJournal
from deap_tpu.telemetry.journal import read_journal as j_read_journal
from deap_tpu_torch import algorithms as talg
from deap_tpu_torch import gp as tgp
from deap_tpu_torch import convert, tuning
from deap_tpu_torch import ops as tops
from deap_tpu_torch.core.fitness import FitnessSpec
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.gp.loop import resolve_compaction
from deap_tpu_torch.mo.emo import _nd_static_auto, nd_rank
from deap_tpu_torch.mo.ndsort import nd_rank_prefix
from deap_tpu_torch.ops import selection as tsel
from deap_tpu_torch.resilience import ResilientRun
from deap_tpu_torch.strategies import cma as tcma
from deap_tpu_torch.telemetry import costs
from deap_tpu_torch.telemetry.costs import ProgramObservatory
from deap_tpu_torch.telemetry.journal import RunJournal, read_journal
from deap_tpu_torch.tuning import DispatchTuner, TuningCache
from deap_tpu_torch.tuning.cache import CACHE_FORMAT, FILENAME

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
ML, N, P = 32, 24, 12


@pytest.fixture(autouse=True)
def _fresh_tuner(tmp_path, monkeypatch):
    """Every test gets disabled tuners in both packages, clean journal
    dedup, no tuner environment, and private cache directories."""
    for var in [v for v in os.environ if v.startswith("DEAP_TPU_TUNE")
                or v.startswith("DEAP_TPU_TORCH_TUNE")]:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv(tuning.cache.ENV_DIR, str(tmp_path / "tunecache"))
    monkeypatch.setenv(jtuning.cache.ENV_DIR, str(tmp_path / "jtunecache"))
    tuning.tuner._reset_for_tests()
    jtuning.tuner._reset_for_tests()
    yield
    tuning.tuner._reset_for_tests()
    jtuning.tuner._reset_for_tests()


@pytest.fixture
def trace_state_shim(monkeypatch):
    """jax 0.9 moved ``trace_state_clean`` out of ``jax.core``, where the
    JAX package's GP calls it; alias it in this test only."""
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(jax.core, "trace_state_clean",
                            jax._src.core.trace_state_clean, raising=False)


def _decisions(path, knob=None):
    rows = [r for r in read_journal(str(path))
            if r.get("kind") == "tuning_decision"]
    return [r for r in rows if knob is None or r.get("knob") == knob]


def _entries():
    cache = TuningCache()
    cache.refresh()
    return cache.entries()


def _w(n=600, nobj=3, seed=0):
    return torch.randn((n, nobj), generator=make_generator(seed, "cpu"))


def _bitwise(a, b):
    a, b = (x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
            for x in (a, b))
    assert a.shape == b.shape and a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


# ------------------------------------------------------ cache plumbing ----

def test_cache_roundtrip_across_processes(tmp_path):
    """A winner put by one process is read back by another, and the cache
    module stays importable by file path with neither torch nor the port
    nor jax: the stdlib-only contract the health report rides."""
    cdir = str(tmp_path / "xproc")
    parent = TuningCache(cdir)
    parent.put("cpu/cpu/nd_impl/3/1024", {
        "winner": "dc", "timings": {"dc": 0.001, "matrix": 0.002},
        "probe_s": 0.1, "identity": "bitwise", "program": "nd_rank",
        "stamp": {"format": CACHE_FORMAT, "torch": "x", "cuda": None},
    })
    cache_py = os.path.join(REPO, "deap_tpu_torch", "tuning", "cache.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('_tc', "
        f"{cache_py!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"cache = mod.TuningCache({cdir!r})\n"
        "entry = cache.get('cpu/cpu/nd_impl/3/1024')\n"
        "assert entry and entry['winner'] == 'dc', entry\n"
        "cache.put('cpu/cpu/gp_mode/64', {'winner': 'sweep'})\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('torch', 'jax', 'deap_tpu', 'deap_tpu_torch')]\n"
        "assert not bad, bad\n"
        "print('child-ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr
    assert "child-ok" in r.stdout
    # the child's put merged with (not clobbered) the parent's entry
    parent.refresh()
    assert parent.get("cpu/cpu/gp_mode/64")["winner"] == "sweep"
    assert parent.get("cpu/cpu/nd_impl/3/1024")["winner"] == "dc"


def test_cache_stamp_and_format_invalidation(tmp_path):
    cdir = str(tmp_path / "stamps")
    cache = TuningCache(cdir)
    stamp = DispatchTuner(cache).stamp()
    assert stamp == {"format": CACHE_FORMAT, "torch": torch.__version__,
                     "cuda": torch.version.cuda}
    cache.put("k", {"winner": "a", "stamp": stamp})
    assert cache.get("k", stamp=stamp)["winner"] == "a"
    # a torch upgrade misses every old entry
    assert cache.get("k", stamp=dict(stamp, torch="other")) is None
    # a cache-format bump discards the whole file
    with open(cache.path) as fh:
        doc = json.load(fh)
    doc["format"] = CACHE_FORMAT - 1
    with open(cache.path, "w") as fh:
        json.dump(doc, fh)
    assert TuningCache(cdir).entries() == {}
    # and a torn/garbage file reads as empty, never raises
    with open(cache.path, "w") as fh:
        fh.write("{not json")
    assert TuningCache(cdir).entries() == {}
    # the port's file lives under its own name and directory variable
    assert tuning.cache.ENV_DIR == "DEAP_TPU_TORCH_TUNING_CACHE"
    assert tuning.cache.ENV_DIR != jtuning.cache.ENV_DIR


# --------------------------------------------------- probe → persist ----

def test_nd_probe_persists_bit_identical_winner(tmp_path):
    """The headline ladder walk: nd_rank(impl='auto') under an active
    tuner probes the engines, persists the measured winner, and the tuned
    ranks equal every forced engine's bit for bit."""
    tuning.enable()
    w = _w()
    jpath = tmp_path / "run.jsonl"
    with RunJournal(str(jpath)):
        tuned = nd_rank(w)
    rows = _decisions(jpath, "nd_impl")
    assert len(rows) == 1 and rows[0]["source"] == "probe"
    assert rows[0]["identity"] == "bitwise"
    entries = _entries()
    key = [k for k in entries if "/nd_impl/" in k]
    assert key == ["cpu/cpu/nd_impl/3/1024"]
    entry = entries[key[0]]
    assert entry["winner"] == rows[0]["winner"]
    assert entry["program"] == "nd_rank"
    assert set(entry["timings"]) == {"matrix", "sweep", "dc"}
    assert all(t is not None and t > 0 for t in entry["timings"].values())
    for impl in ("matrix", "sweep", "dc", "tiled"):
        _bitwise(tuned, nd_rank(w, impl=impl))


def test_warm_cache_replays_decision_without_reprobing(tmp_path):
    """A second 'process' (a fresh tuner session over the same cache dir)
    resolves the same winner from the cache: source 'cache', no probe."""
    tuning.enable()
    w = _w()
    with RunJournal(str(tmp_path / "cold.jsonl")):
        cold = nd_rank(w)
    winner = _decisions(tmp_path / "cold.jsonl", "nd_impl")[0]["winner"]

    tuning.tuner._reset_for_tests()  # forget the session memo
    tuner = tuning.enable()
    calls = []
    tuner._probe = lambda *a: calls.append(a)
    jpath = tmp_path / "warm.jsonl"
    with RunJournal(str(jpath)):
        warm = nd_rank(w)
    rows = _decisions(jpath, "nd_impl")
    assert len(rows) == 1 and not calls
    assert rows[0]["source"] == "cache" and rows[0]["cache_hit"]
    assert rows[0]["winner"] == winner
    _bitwise(cold, warm)


def test_decision_journaled_once_per_key(tmp_path):
    tuning.enable(reps=1)
    jpath = tmp_path / "run.jsonl"
    with RunJournal(str(jpath)):
        nd_rank(_w())
        nd_rank(_w())  # session memo: no second probe, no second row
        nd_rank(_w(n=1500))  # a new shape bucket is a new decision
    rows = _decisions(jpath, "nd_impl")
    assert len(rows) == 2
    assert {r["bucket"] for r in rows} == {"3/1024", "3/2048"}


def test_tuner_off_is_bitwise_static(tmp_path):
    """No tuner, no env: the ladder bottoms out at the static default with
    no journal rows and no cache file."""
    jpath = tmp_path / "run.jsonl"
    w = _w()
    with RunJournal(str(jpath)):
        auto = nd_rank(w)
    static = _nd_static_auto(600, 3, "cpu")
    _bitwise(auto, nd_rank(w, impl=static))
    assert _decisions(jpath) == []
    assert not os.path.exists(os.path.join(
        os.environ[tuning.cache.ENV_DIR], FILENAME))


def test_under_graph_capture_ladder_stops_at_cache(monkeypatch):
    """Nothing may run for timing while a CUDA graph is captured: the
    tuner must not call candidates, and the static default flows
    through."""
    tuning.enable()
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert not tuning.is_concrete()
    w = _w(n=256)
    _bitwise(nd_rank(w), nd_rank(w, impl=_nd_static_auto(256, 3, "cpu")))
    assert not any("/nd_impl/" in k for k in _entries())


def test_failed_candidate_never_wins_and_journals_its_error(tmp_path):
    tuning.enable(reps=1)
    jpath = tmp_path / "run.jsonl"

    def broken():
        raise RuntimeError("no such kernel")

    with RunJournal(str(jpath)):
        got = tuning.resolve("gp_mode", bucket=(64,), default="scan",
                             candidates={"scan": lambda: torch.ones(2),
                                         "sweep": broken},
                             program="gp_interpreter")
    assert got == "scan"
    row = _decisions(jpath, "gp_mode")[0]
    assert row["timings"]["sweep"] is None
    assert "no such kernel" in row["errors"]["sweep"]
    # the survivor serves this process only: nothing is persisted, so a
    # later process probes the key again
    assert row["persisted"] is False
    assert not any("/gp_mode/" in k for k in _entries())


def test_failed_candidate_on_the_card_raises(tmp_path, monkeypatch):
    """On the card a candidate that fails to build or launch fails the
    decision: the caller never moves to another candidate, and nothing is
    cached."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Fake Card")
    monkeypatch.setattr(tuning.tuner, "_sync", lambda device: None)
    tuning.enable(reps=1)
    jpath = tmp_path / "run.jsonl"

    def broken():
        raise RuntimeError("no kernel image for this card")

    with RunJournal(str(jpath)):
        with pytest.raises(RuntimeError, match="no kernel image"):
            tuning.resolve("fused", bucket=("var_and", 64),
                           default="fused_kernel",
                           candidates={"unfused": lambda: torch.ones(2),
                                       "fused_kernel": broken},
                           program="var_and", device="cuda")
    row = _decisions(jpath, "fused")[0]
    assert row["reason"] == "candidate failed"
    assert row["timings"]["fused_kernel"] is None
    assert _entries() == {}


def test_identity_failure_keeps_static_or_raises(tmp_path):
    cands = {"scan": lambda: torch.ones(2), "sweep": lambda: torch.zeros(2)}
    tuning.enable(reps=1)
    assert tuning.resolve("gp_mode", bucket=(1,), default="scan",
                          candidates=cands) == "scan"
    tuning.enable(reps=1, strict_identity=True)
    with pytest.raises(AssertionError, match="disagree"):
        tuning.resolve("gp_mode", bucket=(2,), default="scan",
                       candidates=cands)
    # a NaN equals a NaN of the same bits, where torch.equal would not
    nan = {"scan": lambda: torch.tensor([float("nan")]),
           "sweep": lambda: torch.tensor([float("nan")])}
    assert tuning.resolve("gp_mode", bucket=(3,), default="scan",
                          candidates=nan) in ("scan", "sweep")


# -------------------------------------------------- env escape hatches ----

def test_env_override_wins_without_tuner(tmp_path, monkeypatch):
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_IMPL", "matrix")
    w = _w()
    jpath = tmp_path / "run.jsonl"
    with RunJournal(str(jpath)):
        forced = nd_rank(w)
    _bitwise(forced, nd_rank(w, impl="matrix"))
    rows = _decisions(jpath, "nd_impl")
    assert rows and rows[0]["source"] == "env"
    assert rows[0]["winner"] == "matrix"


def test_env_override_rejects_unknown_candidate(monkeypatch):
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_IMPL", "warp_speed")
    with pytest.raises(ValueError, match="warp_speed"):
        nd_rank(_w(n=64))


def test_nd_cross_has_one_engine_a_device(tmp_path, monkeypatch):
    """``nd_cross`` has one engine a device, so ``'auto'`` asks no tuner:
    on the CPU the plain cross step; naming the card's engine, by
    argument or by the env, raises."""
    w = _w(n=300)
    tuning.enable()
    jpath = tmp_path / "run.jsonl"
    with RunJournal(str(jpath)):
        ranks = nd_rank_prefix(w)
    assert _decisions(jpath) == [] and _entries() == {}
    _bitwise(ranks, nd_rank_prefix(w, cross="plain"))
    with pytest.raises(ValueError, match="cross"):
        nd_rank_prefix(w, cross="kernel")
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_CROSS", "kernel")
    with pytest.raises(ValueError, match="cross 'kernel'"):
        nd_rank_prefix(w)
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_CROSS", "plain")
    _bitwise(nd_rank_prefix(w), ranks)


def test_nd_candidates_per_device():
    """The engines each device races: on the card the one peel the static
    rule takes there (the matrix below the tiled threshold, K7's peel from
    it, never the matrix as K7's plain version); the CPU races the matrix
    and never a kernel's plain version."""
    from deap_tpu_torch.mo import emo as temo
    thr = temo.ND_TILED_THRESHOLD
    assert temo._nd_candidates(100_000, 3, "cuda") == ["tiled", "sweep",
                                                       "dc"]
    assert temo._nd_candidates(100_000, 2, "cuda") == ["tiled", "staircase"]
    assert temo._nd_candidates(thr, 3, "cuda") == ["tiled", "sweep", "dc"]
    assert temo._nd_candidates(thr - 1, 4, "cuda") == ["matrix", "dc"]
    assert temo._nd_candidates(4096, 2, "cuda") == ["matrix", "staircase"]
    assert temo._nd_candidates(100_000, 4, "cpu") == ["matrix", "dc"]
    for n, m in ((600, 3), (thr - 1, 2), (thr, 3), (100_000, 4)):
        # the static pick is always a candidate
        for dev in ("cpu", "cuda"):
            assert (temo._nd_static_auto(n, m, dev)
                    in temo._nd_candidates(n, m, dev))
    for dev in ("cpu", "cuda"):
        assert temo._nd_candidates(600, 3, dev) == jemo._nd_candidates(
            600, 3, "cpu" if dev == "cpu" else "tpu")


def test_env_int_threshold_overrides(monkeypatch):
    # the default ND_PREFIX_THRESHOLD=512 keeps n=64 nobj=4 on the matrix
    assert _nd_static_auto(64, 4, "cpu") == "matrix"
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_PREFIX_THRESHOLD", "1")
    assert _nd_static_auto(64, 4, "cpu") == "dc"
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_PREFIX_THRESHOLD", "junk")
    assert _nd_static_auto(64, 4, "cpu") == "matrix"
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_ND_TILED_THRESHOLD", "100")
    assert _nd_static_auto(200, 3, "cuda") == "tiled"
    assert _nd_static_auto(200, 2, "cuda") == "staircase"


def test_segment_len_auto_env_and_fallbacks(tmp_path, monkeypatch):
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_SEGMENT_LEN", "7")
    assert ResilientRun(str(tmp_path / "ck1"),
                        segment_len="auto").segment_len == 7
    # unparseable / non-positive env values fall back to the static 10
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_SEGMENT_LEN", "soon")
    assert ResilientRun(str(tmp_path / "ck2"),
                        segment_len="auto").segment_len == 10
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_SEGMENT_LEN", "0")
    assert ResilientRun(str(tmp_path / "ck3"),
                        segment_len="auto").segment_len == 10


def test_segment_len_auto_reads_cache_winner(tmp_path):
    """The cache/env-only integer knob: a winner recorded out of band
    steers ``segment_len='auto'``."""
    tuner = tuning.enable()
    tuner.record("segment_len", (), "25",
                 timings={"10": 0.002, "25": 0.001}, probe_s=0.1,
                 identity="bitwise", program="resilient_scan")
    assert ResilientRun(str(tmp_path / "ck"),
                        segment_len="auto").segment_len == 25


# --------------------------------------------------------- invalidation ----

def test_hlo_drift_evicts_and_reprobes(tmp_path):
    tuning.enable(reps=1)
    w = _w()
    j1 = tmp_path / "j1.jsonl"
    with RunJournal(str(j1)):
        nd_rank(w)
        assert any("/nd_impl/" in k for k in _entries())
        assert tuning.note_hlo_drift("nd_rank") == 1
        assert not any("/nd_impl/" in k for k in _entries())
        nd_rank(w)  # the session memo was dropped too: re-probes
    rows = read_journal(str(j1))
    inval = [r for r in rows if r.get("kind") == "tuning_invalidation"]
    assert len(inval) == 1 and inval[0]["reason"] == "hlo_drift"
    assert "/nd_impl/" in inval[0]["key"]
    probes = [r for r in _decisions(j1, "nd_impl") if r["source"] == "probe"]
    assert len(probes) == 2
    # an unrelated program's drift evicts nothing
    assert tuning.note_hlo_drift("some_other_program") == 0


def test_observatory_drift_triggers_tuning_eviction(tmp_path, monkeypatch):
    """End to end: the observatory seeing the same (label, signature)
    launch other kernels evicts the tuning entries recorded against that
    program label — here the GP interpreter's, whose evaluations it
    profiles under ``gp_interpreter``."""
    tuner = tuning.enable()
    tuner.record("gp_mode", (64,), "scan", timings={"scan": 0.001},
                 probe_s=0.1, program="gp_interpreter")
    assert any("/gp_mode/" in k for k in _entries())
    names = iter([["k_a"], ["k_b"]])

    class _Evt:
        def __init__(self, name):
            self.name = name

    monkeypatch.setattr(costs, "_kernel_events",
                        lambda prof: [_Evt(x) for x in next(names)])
    pset = tgp.math_set(1)
    X = torch.linspace(-1, 1, P)[:, None]
    trees = tgp.gen_half_and_half(pset, ML, 1, 2)(make_generator(0, "cpu"),
                                                  8)
    with ProgramObservatory() as obs:
        for _ in range(2):  # two interpreters: the same signature twice
            tgp.make_batch_interpreter(pset, ML, mode="scan")(trees, X)
    assert [p["label"] for p in obs.profiles] == ["gp_interpreter"] * 2
    assert obs.drifts, "observatory did not flag the drift"
    assert not any("/gp_mode/" in k for k in _entries())


def test_drift_inside_a_resilient_run_evicts_nested_winners(tmp_path,
                                                           monkeypatch):
    """Inside a ResilientRun the segment is the profiled program and
    ``var_and`` runs in it as it is: the segment's drift evicts the winners
    recorded against the programs it called, and no other."""
    tuner = tuning.enable()
    tuner.record("fused", ("var_and", 64, 32, "bool"), "unfused",
                 timings={"unfused": 0.001}, probe_s=0.1,
                 program="var_and", device=CPU)
    tuner.record("gp_mode", (64,), "scan", timings={"scan": 0.001},
                 probe_s=0.1, program="gp_interpreter", device=CPU)
    calls = []

    class _Evt:
        def __init__(self, name):
            self.name = name

    def events(prof):
        calls.append(None)
        return [_Evt("k_a" if len(calls) == 1 else "k_b")]

    monkeypatch.setattr(costs, "_kernel_events", events)
    tb = _onemax_toolbox()
    with ProgramObservatory() as obs:
        for i in range(2):  # two runs: the same segment signature twice
            ResilientRun(str(tmp_path / f"ck{i}"), segment_len=2).ea_simple(
                make_generator(7, "cpu"), _onemax_pop(64, 32, 1), tb, 0.5,
                0.2, 2, device=CPU)
    assert [p["label"] for p in obs.profiles] == ["resilient_ea_simple"] * 2
    assert obs.drifts
    assert "var_and" in obs._nested["resilient_ea_simple"]
    left = _entries()
    assert not any("/fused/" in k for k in left)
    assert any("/gp_mode/" in k for k in left)


def test_knob_programs_are_observatory_labels():
    """Each knob's program label is a label the observatory profiles, so
    an eviction can hit: every decision point's seam is instrumented."""
    seams = {"nd_rank": nd_rank, "var_and": talg.var_and,
             "var_or": talg.var_or}
    for label, fn in seams.items():
        assert isinstance(fn, costs._InstrumentedFunction)
        assert fn.label == label
    s = tcma.Strategy(torch.zeros(3), 1.0, device=CPU)
    assert s._eigh.label == "cma_eigh"
    interp = tgp.make_batch_interpreter(tgp.math_set(1), 16)
    assert interp.unique.label == "gp_interpreter"


def test_nested_programs_are_profiled_once_by_the_outer(tmp_path):
    """An instrumented program called inside another runs as it is: the
    outer profile holds its kernels."""
    inner = costs.instrument(lambda x: x + 1, "inner")
    outer = costs.instrument(lambda x: inner(x) * 2, "outer")
    with ProgramObservatory() as obs:
        outer(torch.ones(2))
        inner(torch.ones(2))
    assert [p["label"] for p in obs.profiles] == ["outer", "inner"]


# --------------------------------------- per-decision-point identity ----

def test_compaction_resolves_from_env_cache_or_static(tmp_path,
                                                     monkeypatch):
    """compaction='auto' never probes: the static split, a winner recorded
    out of band (read back in another tuner from the cache), or the env,
    in the ladder's order; the loop built on either mode gives the same
    generation bit for bit."""
    tuner = tuning.enable()
    assert resolve_compaction("auto", CPU) == "host"
    assert _entries() == {}
    tuner.record("compaction", (), "device", timings={"host": 0.002,
                                                      "device": 0.001},
                 probe_s=0.1, program="gp_loop", device=CPU)
    tuning.enable()  # a fresh session: the cache, not the memo
    assert resolve_compaction("auto", CPU) == "device"
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_COMPACTION", "host")
    assert resolve_compaction("auto", CPU) == "host"
    monkeypatch.setenv("DEAP_TPU_TORCH_TUNE_COMPACTION", "both")
    with pytest.raises(ValueError, match="both"):
        resolve_compaction("auto", CPU)
    monkeypatch.delenv("DEAP_TPU_TORCH_TUNE_COMPACTION")
    pset = tgp.math_set(1)
    X, y = _symbreg_data()
    trees = tgp.gen_half_and_half(pset, ML, 1, 3)(make_generator(3, "cpu"),
                                                   N)
    runs = [tgp.make_symbreg_loop(pset, ML, X, y, mode="scan",
                                  compaction=c, device="cpu")
            for c in ("auto", "host")]
    assert runs[0].compaction == "device"
    got = [r(make_generator(11, "cpu"), trees, 2) for r in runs]
    for k in ("nodes", "consts", "length"):
        _bitwise(got[0]["genomes"][k], got[1]["genomes"][k])
    _bitwise(got[0]["fitness"], got[1]["fitness"])


def test_eigh_auto_probes_with_tolerance_check():
    tuning.enable()
    auto = tcma.Strategy(torch.zeros(8), 0.5, eigh_impl="auto", device=CPU)
    assert auto.eigh_impl in ("lapack", "jacobi")
    entry = _entries().get(DispatchTuner().key_for("eigh_impl", (8,), CPU))
    assert entry is not None and entry["winner"] == auto.eigh_impl
    # the two solvers are NOT bitwise-equal: the probe must have used the
    # reconstruction-residual tolerance check instead
    assert entry["identity"] == "tolerance"
    assert set(entry["timings"]) == {"lapack", "jacobi"}
    forced = tcma.Strategy(torch.zeros(8), 0.5, eigh_impl=auto.eigh_impl,
                           device=CPU)
    for strat in (auto, forced):
        strat._state = strat.initial_state()
    ga = auto.generate(make_generator(5, "cpu"), auto._state)
    gf = forced.generate(make_generator(5, "cpu"), forced._state)
    _bitwise(ga, gf)
    sa = auto.update(auto._state, ga, (ga ** 2).sum(1))
    sf = forced.update(forced._state, gf, (gf ** 2).sum(1))
    for name in ("centroid", "sigma", "C", "B", "diagD", "ps", "pc"):
        _bitwise(getattr(sa, name), getattr(sf, name))


def _onemax_pop(n, L, seed):
    return init_population(make_generator(seed, "cpu"), n,
                           tops.bernoulli_genome(L), FitnessSpec((1.0,)),
                           device="cpu")


def _onemax_toolbox():
    from deap_tpu_torch import Toolbox
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", tops.cx_two_point)
    tb.register("mutate", tops.mut_flip_bit, indpb=0.05)
    tb.register("select", tops.sel_tournament, tournsize=3)
    return tb


@pytest.mark.parametrize("op", ["var_and", "var_or"])
def test_fused_variation_tuned_equals_forced(tmp_path, op):
    """fused='auto' under the tuner races unfused against the plain fused
    apply on the CPU, draws nothing from the caller's generator while it
    probes, and gives every forced path's children and generator state."""
    tuning.enable(reps=1, strict_identity=True)
    tb = _onemax_toolbox()
    pop = talg.evaluate_invalid(_onemax_pop(64, 23, 1), tb.evaluate)

    def run(fused):
        g = make_generator(7, "cpu")
        if op == "var_and":
            off = talg.var_and(g, pop, tb, 0.5, 0.2, fused=fused)
        else:
            off = talg.var_or(g, pop, tb, 50, 0.5, 0.2, fused=fused)
        return off, g.get_state()

    jpath = tmp_path / "run.jsonl"
    with RunJournal(str(jpath)):
        tuned, tuned_g = run("auto")
    for fused in (False, "plain"):
        off, g = run(fused)
        for a, b in ((tuned.genomes, off.genomes),
                     (tuned.fitness, off.fitness), (tuned.valid, off.valid),
                     (tuned_g, g)):
            _bitwise(a, b)
    rows = _decisions(jpath, "fused")
    assert len(rows) == 1 and rows[0]["source"] == "probe"
    assert rows[0]["identity"] == "bitwise"
    assert set(rows[0]["timings"]) == {"unfused", "fused_plain"}
    assert rows[0]["winner"] in ("unfused", "fused_plain")
    assert rows[0]["bucket"] == f"{op}/64/32/bool"
    assert rows[0]["program"] == op


def _symbreg_data():
    X = np.linspace(-1, 1, P).reshape(P, 1).astype(np.float32)
    return X, (X[:, 0] ** 2 + X[:, 0]).astype(np.float32)


def test_gp_mode_auto_loop_bit_identity(tmp_path):
    """make_symbreg_loop(mode='auto') under a tuner: the mode probe races
    the interpreters, and the resulting loop equals the same loop built
    with the winner forced, bit for bit."""
    tuning.enable(reps=1, strict_identity=True)
    pset = tgp.math_set(1)
    X, y = _symbreg_data()
    jpath = tmp_path / "run.jsonl"
    with RunJournal(str(jpath)):
        run_auto = tgp.make_symbreg_loop(pset, ML, X, y, mode="auto",
                                         device="cpu")
    rows = _decisions(jpath, "gp_mode")
    assert len(rows) == 1 and rows[0]["source"] == "probe"
    assert rows[0]["identity"] == "bitwise"
    winner = rows[0]["winner"]
    assert winner in ("scan", "sweep", "grouped")
    assert set(rows[0]["timings"]) == {"scan", "sweep", "grouped"}
    assert run_auto.interpreter.mode == winner
    # compaction='auto' is env/cache only: the static split, journaled
    comp = _decisions(jpath, "compaction")
    assert [(r["source"], r["winner"]) for r in comp] == [("static", "host")]
    assert run_auto.compaction == "host"
    run_forced = tgp.make_symbreg_loop(pset, ML, X, y, mode=winner,
                                       device="cpu")
    gen = tgp.gen_half_and_half(pset, ML, 1, 3)
    trees = gen(make_generator(3, "cpu"), N)
    res_a = run_auto(make_generator(11, "cpu"), trees, 2)
    res_f = run_forced(make_generator(11, "cpu"), trees, 2)
    for k in ("nodes", "consts", "length"):
        _bitwise(res_a["genomes"][k], res_f["genomes"][k])
        _bitwise(res_a["best_genome"][k], res_f["best_genome"][k])
    _bitwise(res_a["fitness"], res_f["fitness"])
    assert res_a["best_fitness"] == res_f["best_fitness"]


# ------------------------------------------------------- health ledger ----

def test_health_report_renders_tuning_ledger(tmp_path):
    """The report renders the tuner's rows — from a real probe, a cache
    replay, an identity failure and a drift eviction — without torch."""
    jpath = str(tmp_path / "run.jsonl")
    with RunJournal(jpath) as j:
        tuning.enable(reps=1)
        nd_rank(_w())
        tuning.tuner._reset_for_tests()
        tuning.enable()
        nd_rank(_w())
        tuning.resolve("fused", bucket=("var_and", 64), default="unfused",
                       candidates={"unfused": lambda: torch.ones(1),
                                   "fused_plain": lambda: torch.zeros(1)},
                       program="var_and")
        tuning.note_hlo_drift("nd_rank")
        j.event("note", text="end")
    report_py = os.path.join(REPO, "deap_tpu_torch", "telemetry",
                             "report.py")
    code = (
        "import runpy, sys\n"
        f"sys.argv = ['report.py', {jpath!r}]\n"
        "try:\n"
        f"    runpy.run_path({report_py!r}, run_name='__main__')\n"
        "except SystemExit:\n"
        "    pass\n"
        "assert 'torch' not in sys.modules, 'the ledger imported torch'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out = r.stdout
    assert "Tuning ledger" in out
    assert "nd_impl" in out and "cache" in out
    assert "identity check" in out  # the failed-identity warning
    assert "drift eviction" in out and "/nd_impl/" in out


# ------------------------------------------------ against the JAX package --

def test_helpers_agree_with_jax(monkeypatch):
    for n in (-3, 0, 1, 2, 3, 4, 5, 63, 64, 65, 4000, 4096, 100_000):
        assert tuning.shape_bucket(n) == jtuning.shape_bucket(n)
    values = (None, "", " ", "1", "on", "TRUE", " yes ", "0", "off", "no",
              "2", "junk", "-5", " 17 ")
    for v in values:
        assert tuning.tuner._truthy(v) == jtuning.tuner._truthy(v), v
        for prefix, mod in (("DEAP_TPU_TORCH_TUNE_", tuning),
                            ("DEAP_TPU_TUNE_", jtuning)):
            for name in ("ND_IMPL", "ND_TILED_THRESHOLD"):
                if v is None:
                    monkeypatch.delenv(prefix + name, raising=False)
                else:
                    monkeypatch.setenv(prefix + name, v)
        assert tuning.env_override("nd_impl") == \
            jtuning.env_override("nd_impl"), v
        assert tuning.int_env("ND_TILED_THRESHOLD", 8192) == \
            jtuning.int_env("ND_TILED_THRESHOLD", 8192), v
    assert set(tuning.KNOBS) == set(jtuning.KNOBS)
    assert tuning.__all__ == jtuning.__all__


def test_caches_write_the_same_json(tmp_path):
    """The two TuningCaches driven by the same put/get/evict sequence
    write the same document but for the stamp and the times."""
    caches = (TuningCache(str(tmp_path / "t")),
              jtuning.TuningCache(str(tmp_path / "j")))
    for cache, stamp in zip(caches, ({"format": 1, "torch": "t"},
                                     {"format": 1, "jax": "j"})):
        for i, knob in enumerate(("nd_impl", "gp_mode", "fused")):
            cache.put(f"cpu/cpu/{knob}/{i}", {
                "winner": f"w{i}", "timings": {f"w{i}": 0.5 * i},
                "probe_s": 0.25, "identity": "bitwise",
                "program": "nd_rank" if i != 1 else "gp_interpreter",
                "stamp": stamp, "recorded_at": f"now{i}"})
        assert cache.get("cpu/cpu/gp_mode/1", stamp=stamp)["winner"] == "w1"
        assert cache.evict(["cpu/cpu/fused/2", "absent"]) == \
            ["cpu/cpu/fused/2"]
        assert cache.evict_program("gp_interpreter") == ["cpu/cpu/gp_mode/1"]

    def doc(cache):
        with open(cache.path) as fh:
            d = json.load(fh)
        d.pop("updated_at")
        for e in d["entries"].values():
            e.pop("stamp"), e.pop("recorded_at")
        return d

    assert doc(caches[0]) == doc(caches[1])
    assert os.path.basename(caches[0].path) == \
        os.path.basename(caches[1].path)


def test_decision_rows_have_the_jax_rows_keys(tmp_path):
    """A probe, a cache replay and an env decision journal the JAX rows'
    keys."""
    rows = {}
    for name, mod, journal, read in (
            ("torch", tuning, RunJournal, read_journal),
            ("jax", jtuning, JRunJournal, j_read_journal)):
        path = str(tmp_path / f"{name}.jsonl")
        with journal(path):
            tuner = mod.enable(str(tmp_path / f"{name}cache"))
            tuner.record("nd_impl", (3, 1024), "dc", timings={"dc": 0.1},
                         probe_s=0.2, program="nd_rank", default="matrix")
            mod.tuner._reset_for_tests()
            mod.enable(str(tmp_path / f"{name}cache"))
            assert mod.resolve("nd_impl", bucket=(3, 1024),
                               default="matrix") == "dc"
            os.environ[mod.tuner.ENV_PREFIX + "GP_MODE"] = "sweep"
            try:
                mod.resolve("gp_mode", bucket=(64,), default="scan")
            finally:
                del os.environ[mod.tuner.ENV_PREFIX + "GP_MODE"]
        rows[name] = [r for r in read(path)
                      if r.get("kind") == "tuning_decision"]
    assert [r["source"] for r in rows["torch"]] == ["probe", "cache", "env"]
    for got, want in zip(rows["torch"], rows["jax"]):
        assert set(got) == set(want), (got, want)
        for k in ("knob", "bucket", "source", "winner", "default",
                  "cache_hit", "program"):
            assert got[k] == want[k]


def test_tuner_off_nd_rank_auto_equals_jax():
    for n, nobj in ((600, 3), (300, 2), (64, 4), (2000, 3)):
        w = _w(n, nobj, seed=n + nobj)
        want = np.asarray(jemo.nd_rank(jnp.asarray(w.numpy())))
        _bitwise(nd_rank(w), want.astype(np.int32))


def test_tuner_off_ea_simple_generation_equals_jax(monkeypatch):
    """One injected ea_simple generation with fused='auto' and no tuner:
    the port's step (its var_and through the tuner's static rung) against
    the JAX step on the same population and draws."""
    from deap_tpu import algorithms as jalg
    from deap_tpu import ops as jops
    from deap_tpu.core.fitness import FitnessSpec as JSpec
    from deap_tpu.core.population import init_population as j_init
    from deap_tpu.core.toolbox import Toolbox as JToolbox
    from deap_tpu.ops import selection as jsel
    from deap_tpu.ops import variation as jvar

    n, L = 101, 100
    jtb = JToolbox()
    jtb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    jtb.register("mate", jops.cx_two_point)
    jtb.register("mutate", jops.mut_flip_bit, indpb=0.05)
    jtb.register("select", jops.sel_tournament, tournsize=3)
    pop = j_init(jax.random.key(1), n, jops.bernoulli_genome(L),
                 JSpec((1.0,)))
    pop, _, hof = jalg.ea_simple(jax.random.key(2), pop, jtb, 0.5, 0.2, 2,
                                 halloffame_size=1)
    key = jax.random.key(3)
    (want, _), _ = jalg.make_ea_simple_step(jtb, 0.5, 0.2)((pop, hof), key)
    k_sel, k_var = jax.random.split(key)
    aspirants = np.array(jsel.tournament_aspirants(k_sel, n, n, 3))
    masks = [np.array(m) for m in jvar.var_and_masks(
        k_var, n, L, 0.5, 0.2, jvar.resolve_plan(jtb), pop.genomes.dtype)]

    tpop = convert.population_from_arrays(pop.genomes, pop.fitness,
                                          pop.valid, (1.0,), device="cpu")
    tb = _onemax_toolbox()
    tb.register("select", lambda g, w, k: tsel._tournament_winners(
        w, torch.from_numpy(aspirants).long()))
    monkeypatch.setattr(talg._variation, "var_and_masks", lambda *a: tuple(
        torch.from_numpy(m) for m in masks[:5]) + (None,))
    step = talg.make_ea_simple_step(tb, 0.5, 0.2, fused="auto")
    off, _, _ = step(make_generator(0, "cpu"), tpop, None)
    got = convert.population_to_arrays(off)
    for name in ("genomes", "fitness", "valid"):
        _bitwise(got[name], np.asarray(getattr(want, name)))


def test_tuner_off_gp_generation_equals_jax(trace_state_shim):
    """One injected GP symbreg generation with mode='auto' and
    compaction='auto' and no tuner: genomes and carried depths equal the
    JAX loop's bit for bit (the generation's harness is the GP loop
    test's)."""
    from test_torch_gp_loop import (CXPB, ML as GML, MUTPB, JaxDraws,
                                    _data, _jax_pop)
    from deap_tpu import gp as jgp
    from deap_tpu.gp import loop as jloop
    from deap_tpu_torch.convert import (gp_genomes_from_arrays,
                                        gp_genomes_to_arrays)

    jps = jgp.math_set(1)
    X, y = _data()
    jrun = jloop.make_symbreg_loop(jps, GML, jnp.asarray(X), jnp.asarray(y),
                                   cxpb=CXPB, mutpb=MUTPB)
    pop = _jax_pop(jps, 3)
    key = jax.random.key(11)
    js = jrun.init_state(key, {k: jnp.asarray(v) for k, v in pop.items()}, 1)
    fit0 = np.array(js["fit"])
    jrun.advance(key, js)
    trun = tgp.make_symbreg_loop(tgp.math_set(1), GML, X, y, cxpb=CXPB,
                                 mutpb=MUTPB, mode="auto",
                                 compaction="auto", device="cpu")
    assert trun.interpreter.mode == "grouped"
    ts = trun.init_state(gp_genomes_from_arrays(pop, "cpu"), 1)
    ts["fit"] = torch.from_numpy(fit0)
    ts["best_fitness"] = js["best_fitness"]
    trun.advance(None, ts, draws=JaxDraws(jps, key, 1))
    got = gp_genomes_to_arrays(ts["genomes"])
    for k in ("nodes", "consts", "length"):
        _bitwise(got[k], np.asarray(js["genomes"][k]))
    _bitwise(ts["depths"], np.asarray(js["depths"]))
    assert ts["nevals"] == js["nevals"]


def test_tuner_off_cma_update_equals_jax():
    """One CMA-ES update with eigh_impl='auto' and no tuner ('lapack')
    within the stated ``state_errors`` tolerances of the JAX update."""
    dim, lam = 6, 12
    js = jcma.Strategy(jnp.full(dim, 2.0, jnp.float32), 0.5, lambda_=lam)
    ts = tcma.Strategy(torch.full((dim,), 2.0), 0.5, lambda_=lam,
                       eigh_impl="auto", device=CPU)
    assert ts.eigh_impl == "lapack"
    jstate = js.initial_state()
    arz = np.random.default_rng(4).standard_normal((lam, dim)).astype(
        np.float32)
    genomes = np.array(
        jstate.centroid + jstate.sigma * jnp.asarray(arz) @ jstate.BD.T)
    values = (genomes ** 2).sum(1)
    want = js.update(jstate, jnp.asarray(genomes), jnp.asarray(values))

    def port(state):
        return convert.cma_state_from_arrays(
            **{f: np.asarray(getattr(state, f)) for f in convert.CMA_FIELDS},
            device="cpu")

    got = ts.update(port(jstate), torch.from_numpy(genomes),
                    torch.from_numpy(values))
    errs = tcma.state_errors(got, port(want))
    assert errs["ok"], errs
