"""The port's profiling hooks (``deap_tpu_torch.support.profiling``) on the
CPU, against the JAX package's where the two compute the same thing.

- ``SpanRecorder``: the same span stream, past the reservoir's bound,
  aggregates to the JAX recorder's numbers exactly (the same
  ``random.Random(seed)`` replacement draws); ``span`` records only while
  a recorder is installed and lands in a traced request's waterfall;
  ``set_span_recorder``/``get_span_recorder`` nest.
- ``trace`` writes a chrome trace holding the spans run inside it;
  ``annotate`` keeps the function's result and name.
- ``sync`` waits for nothing on the CPU and returns its tree;
  ``timed_phases`` and ``timed_generations`` time what they run.
- ``live_buffer_bytes`` and ``device_memory_snapshot`` initialise no CUDA
  context and say so.
- ``deap_tpu_torch.support`` exports profiling's names as the JAX
  package's ``support`` does.
"""

import json

import pytest
import torch

from deap_tpu.support import profiling as jprof
from deap_tpu_torch import support as tsupport
from deap_tpu_torch.support import profiling as tprof
from deap_tpu_torch.telemetry import tracing


def _stream(seed, n):
    import random
    rng = random.Random(seed)
    return [(f"s{rng.randrange(3)}", rng.random()) for _ in range(n)]


@pytest.mark.parametrize("max_samples,n", [(4096, 50), (8, 300), (1, 40)])
def test_span_recorder_aggregates_equal_the_jax_recorder(max_samples, n):
    a = jprof.SpanRecorder(max_samples=max_samples, seed=3)
    b = tprof.SpanRecorder(max_samples=max_samples, seed=3)
    for name, secs in _stream(max_samples, n):
        a.record(name, secs)
        b.record(name, secs)
    assert a.aggregates() == b.aggregates()


def test_span_records_only_with_a_recorder():
    assert tprof.get_span_recorder() is None
    with tprof.span("outside"):
        pass
    with tprof.SpanRecorder() as rec:
        assert tprof.get_span_recorder() is rec
        for _ in range(3):
            with tprof.span("inner"):
                torch.ones(4).sum()
        inner = tprof.SpanRecorder()
        prev = tprof.set_span_recorder(inner)
        assert prev is rec
        with tprof.span("nested"):
            pass
        tprof.set_span_recorder(prev)
    assert tprof.get_span_recorder() is None
    aggs = rec.aggregates()
    assert list(aggs) == ["inner"] and aggs["inner"]["count"] == 3
    assert set(aggs["inner"]) == {"count", "total_s", "mean_s", "p50_s",
                                  "p99_s", "max_s"}
    assert list(inner.aggregates()) == ["nested"]


def test_span_lands_in_a_traced_request(tmp_path):
    from deap_tpu_torch.telemetry import RunJournal, read_journal
    path = str(tmp_path / "j.jsonl")
    ctx = tracing.Tracer().context_for("req-1")
    with RunJournal(path), tprof.SpanRecorder(), tracing.use(ctx):
        with tprof.span("phase"):
            pass
    rows = [r for r in read_journal(path) if r["kind"] == "trace_span"]
    assert [r["name"] for r in rows] == ["span:phase"]
    assert rows[0]["trace_id"] == tracing.trace_id_for("req-1")


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.span("labelled_block"):
            torch.ones(64).cumsum(0)
    data = json.loads((tmp_path / "tr" / tprof.TRACE_FILE).read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "labelled_block" in names
    assert any(a.key == "labelled_block" for a in prof.key_averages())


def test_annotate_keeps_result_and_name():
    @tprof.annotate("region")
    def f(x):
        """doc"""
        return x + 1

    assert f(torch.tensor(2)).item() == 3 and f.__name__ == "f"
    assert f.__doc__ == "doc"


def test_sync_and_timers_on_the_cpu():
    tree = {"a": torch.ones(3), "b": [torch.zeros(2), 5], "c": None}
    assert tprof.sync(tree) is tree
    calls = []

    def thunk():
        calls.append(1)
        return torch.ones(2)

    out = tprof.timed_phases({"x": thunk, "y": thunk}, reps=2)
    assert set(out) == {"x", "y"} and all(v >= 0 for v in out.values())
    assert len(calls) == 6  # a warm-up and two timed runs each
    gens = list(tprof.timed_generations(lambda s, k: s + k,
                                        torch.zeros(1), 4, 2))
    assert [g for g, _, _ in gens] == [0, 1, 2, 3]
    assert gens[-1][1].item() == 8 and all(dt >= 0 for _, _, dt in gens)


def test_memory_samples_need_no_cuda_context(tmp_path):
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        pytest.skip("a CUDA context exists in this process")
    assert tprof.live_buffer_bytes() == {}
    snap = tprof.device_memory_snapshot(str(tmp_path / "m.json"))
    assert snap == {"live_bytes": {}, "profile_error": "no CUDA context"}
    assert tprof.device_memory_snapshot() == {"live_bytes": {}}
    assert not (tmp_path / "m.json").exists()


def test_support_exports_profiling_as_the_jax_package():
    from deap_tpu import support as jsupport
    want = [n for n in jsupport.__all__ if n != "compilecache"]
    assert sorted(set(want) - set(tsupport.__all__)) == []
    for name in ("trace", "annotate", "span", "sync", "SpanRecorder",
                 "set_span_recorder", "get_span_recorder",
                 "timed_generations", "timed_phases"):
        assert getattr(tsupport, name) is getattr(tprof, name)
    assert tprof.__all__ == jprof.__all__
