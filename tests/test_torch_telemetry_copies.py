"""The port's copies of the JAX package's standard-library telemetry
modules behave as the originals: ``metrics``, ``slo``, ``alerts``,
``federation``, ``tracing`` and ``report``, one test per public name, each
calling the JAX module and the port's copy on the same inputs (fixed
journals written row by row, a two-process fleet root) and holding the
outputs equal. Values that are random by design (``new_span_id``, a
span's own id) are compared by format. The copies load their siblings by
path from the port's own directory, and render without torch, jax or
either package in the process (a subprocess).
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import textwrap
import urllib.request
from contextlib import redirect_stdout

import pytest

from deap_tpu.telemetry import alerts as j_alerts
from deap_tpu.telemetry import federation as j_fed
from deap_tpu.telemetry import metrics as j_metrics
from deap_tpu.telemetry import report as j_report
from deap_tpu.telemetry import slo as j_slo
from deap_tpu.telemetry import tracing as j_tracing
from deap_tpu_torch.telemetry import alerts as t_alerts
from deap_tpu_torch.telemetry import federation as t_fed
from deap_tpu_torch.telemetry import metrics as t_metrics
from deap_tpu_torch.telemetry import report as t_report
from deap_tpu_torch.telemetry import slo as t_slo
from deap_tpu_torch.telemetry import tracing as t_tracing

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = {"metrics": (j_metrics, t_metrics), "slo": (j_slo, t_slo),
         "alerts": (j_alerts, t_alerts), "federation": (j_fed, t_fed),
         "tracing": (j_tracing, t_tracing), "report": (j_report, t_report)}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_copy_exports_the_originals_names(name):
    jmod, tmod = PAIRS[name]
    assert tmod.__all__ == jmod.__all__
    assert all(hasattr(tmod, n) for n in tmod.__all__)


def _plain(x):
    """Dataclasses as dicts, tuples as lists: comparable across modules."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {"__type__": type(x).__name__,
                **{k: _plain(v) for k, v in dataclasses.asdict(x).items()}}
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


# ------------------------------------------------------ fixed journals --

REQ = ["req-a", "req-b", "req-c"]


def _service_rows(offset=0.0, slow=1.0):
    """A fixed service journal: header, arrivals, sheds, admissions,
    resumes, per-boundary slo rows, trace spans per request, finishes,
    meter rows, alarms, spans, program profiles, compiles."""
    rows = [{"t": 0.0, "kind": "header", "run_id": "fixed",
             "wall_start": 1000.0 + offset, "env": {"torch": "x"},
             "monitoring": True}]
    t = 0.01
    for i, rid in enumerate(REQ):
        tid = f"tenant-{i}"
        trace = j_tracing.trace_id_for(rid)
        root = j_tracing.root_span_id(rid)
        rows += [
            {"t": t, "kind": "job_submitted", "tenant_id": tid,
             "request_id": rid},
            {"t": t + 0.05, "kind": "tenant_admitted", "tenant_id": tid,
             "wait_s": 0.05 * (i + 1)},
            {"t": t + 0.3, "kind": "slo", "segment_s": 0.02 * (i + 1) * slow,
             "queue_depth": i},
            {"t": t + 0.31, "kind": "trace_span", "name": "admission",
             "phase": "admission", "dur_s": 0.01, "trace_id": trace,
             "span_id": j_tracing.span_id_for(rid, "admission"),
             "parent_id": root, "request_id": rid},
            {"t": t + 0.6, "kind": "trace_span", "name": "segment",
             "phase": "device", "dur_s": 0.2 * slow, "trace_id": trace,
             "span_id": j_tracing.span_id_for(rid, "segment"),
             "parent_id": root, "request_id": rid},
            {"t": t + 0.7, "kind": "trace_span", "name": "request",
             "phase": None, "dur_s": 0.69, "trace_id": trace,
             "span_id": root, "parent_id": None, "request_id": rid},
            {"t": t + 0.71, "kind": "tenant_finished", "tenant_id": tid},
        ]
        t += 0.9
    rows += [{"t": t + 0.1, "kind": "load_shed", "new": 2},
             {"t": t + 0.2, "kind": "deadline_exceeded", "tenant_id": "x"},
             {"t": t + 0.3, "kind": "tenant_resumed", "tenant_id": "y",
              "wait_s": 0.4},
             {"t": t + 0.4, "kind": "run_start", "algorithm": "ea_simple",
              "ngen": 3}]
    for gen in range(4):
        rows.append({"t": t + 0.5 + gen * 0.01, "kind": "meter", "gen": gen,
                     "nevals": 10 * gen, "best": float(gen),
                     "mean": gen / 2, "div_msd": 4.0 - gen,
                     "gp_clone_rate": 0.1 * gen})
    rows += [
        {"t": t + 0.6, "kind": "alarm", "alarm": "zero_improvement",
         "gen": 3, "age": 2, "window": 2},
        {"t": t + 0.61, "kind": "compile", "dur_s": 1.5, "seq": 1,
         "library": "fused_variation"},
        {"t": t + 0.62, "kind": "steady", "label": "ea_simple",
         "n_compiles": 1},
        {"t": t + 0.63, "kind": "retrace", "dur_s": 0.5, "seq": 2,
         "library": "dominance", "after": "ea_simple"},
        {"t": t + 0.64, "kind": "program_profile", "label": "seg",
         "kernel_hash": "ab", "compile_s": 0.0, "kernel_us": {"k": 3.0}},
        {"t": t + 0.65, "kind": "device_memory", "step": 5,
         "live_bytes": {"cuda": 1 << 20}},
        {"t": t + 0.7, "kind": "run_end", "algorithm": "ea_simple"},
        {"t": t + 0.71, "kind": "span", "name": "gp_loop/fetch",
         "count": 3, "total_s": 0.3, "mean_s": 0.1, "p50_s": 0.1,
         "p99_s": 0.2, "max_s": 0.2},
        {"t": t + 0.8, "kind": "summary", "n_compiles": 2,
         "n_retraces": 1}]
    return rows


def _write(path, rows):
    with open(path, "w") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")
    return path


@pytest.fixture
def journal(tmp_path):
    return _write(str(tmp_path / "fixed.jsonl"), _service_rows())


@pytest.fixture
def fleet(tmp_path):
    """A two-process fleet root (each process registered by both
    modules' ``register_process`` into its own root, same journals)."""
    roots = {}
    for tag, mod in (("j", j_fed), ("t", t_fed)):
        root = str(tmp_path / f"fleet_{tag}")
        for k, pid in enumerate(("alpha", "beta")):
            path = mod.register_process(root, pid, role="worker", k=k)
            _write(path, _service_rows(offset=k * 0.5, slow=1.0 + k))
        roots[tag] = root
    return roots


# -------------------------------------------------------------- tracing --

def test_tracing_constants_and_ids():
    assert t_tracing.PHASES == j_tracing.PHASES
    for rid in ("r1", "tenant/42", ""):
        assert t_tracing.trace_id_for(rid) == j_tracing.trace_id_for(rid)
        assert t_tracing.span_id_for(rid, "x") == \
            j_tracing.span_id_for(rid, "x")
        assert t_tracing.root_span_id(rid) == j_tracing.root_span_id(rid)
    a, b = t_tracing.new_span_id(), j_tracing.new_span_id()
    assert len(a) == len(b) and int(a, 16) >= 0


def test_tracing_traceparent_round_trip():
    tid, sid = j_tracing.trace_id_for("r"), j_tracing.span_id_for("r", "s")
    for sampled in (True, False):
        h = j_tracing.format_traceparent(tid, sid, sampled)
        assert t_tracing.format_traceparent(tid, sid, sampled) == h
        assert t_tracing.parse_traceparent(h) == \
            j_tracing.parse_traceparent(h)
    for bad in (None, "", "00-xyz", "01-" + tid + "-" + sid + "-01"):
        assert t_tracing.parse_traceparent(bad) == \
            j_tracing.parse_traceparent(bad)


def test_tracing_context_use_and_current_ids():
    outs = []
    for mod in (j_tracing, t_tracing):
        ctx = mod.TraceContext(mod.trace_id_for("q"), mod.root_span_id("q"),
                               "q", True)
        assert mod.current() is None and mod.current_ids() == {}
        with mod.use(ctx):
            inside = (_plain(mod.current()), mod.current_ids(),
                      ctx.traceparent(), _plain(ctx.child("c1")))
        with mod.use(None):
            assert mod.current() is None
        outs.append(inside)
    assert outs[0] == outs[1]


def test_tracing_emit_current_and_tracer(tmp_path):
    from deap_tpu.telemetry.journal import RunJournal as JJournal
    from deap_tpu_torch.telemetry.journal import RunJournal as TJournal
    from deap_tpu_torch.telemetry.journal import read_journal

    rows = []
    for tag, mod, J in (("j", j_tracing, JJournal),
                        ("t", t_tracing, TJournal)):
        path = str(tmp_path / f"{tag}.jsonl")
        seen = []
        with J(path) as jr:
            tracer = mod.Tracer(journal=jr, sample=0.5,
                                phase_observe=lambda p, d: seen.append(
                                    (p, d)))
            ctx = tracer.context_for("req-x")
            ctx2 = tracer.context_for(
                "req-y", mod.format_traceparent(ctx.trace_id, "ab" * 8))
            with mod.use(ctx):
                mod.emit_current("bridge", 0.25, phase="device",
                                 always=True, links=[{"a": 1}], extra=3)
            with tracer.span("outer", ctx=ctx, phase="admission",
                             always=True):
                tracer.emit("inner", 0.1, phase="device", always=True)
            tracer.emit("plain", 0.2, ctx=ctx2, always=True)
            samp = [tracer.sampled(mod.trace_id_for(f"r{i}"))
                    for i in range(64)]
        # ids are random and a span's own duration is a wall clock
        got = [{k: v for k, v in r.items()
                if k not in ("t", "span_id", "parent_id")
                and not (k == "dur_s" and r["name"] == "outer")}
               for r in read_journal(path) if r["kind"] == "trace_span"]
        rows.append((got, samp, [p for p, _ in seen],
                     _plain(ctx2)["trace_id"], ctx2.sampled))
    assert rows[0] == rows[1]


def test_tracing_assemble_and_perfetto(tmp_path, journal):
    from deap_tpu_torch.telemetry.journal import read_journal
    rows = read_journal(journal)
    groups = [(rows[0], rows)]
    for rid in REQ:
        tid = j_tracing.trace_id_for(rid)
        a = j_tracing.assemble_trace(groups, tid)
        b = t_tracing.assemble_trace(groups, tid)
        assert a == b and len(b["spans"]) == 3
        assert t_tracing.perfetto_events(b["spans"]) == \
            j_tracing.perfetto_events(a["spans"])
        j_tracing.write_perfetto(str(tmp_path / "a.json"), a["spans"])
        t_tracing.write_perfetto(str(tmp_path / "b.json"), b["spans"])
        assert (tmp_path / "a.json").read_text() == \
            (tmp_path / "b.json").read_text()
    # a journal whose root span was lost gets a synthetic root in both
    lost = [r for r in rows if not (r.get("kind") == "trace_span"
                                    and r.get("name") == "request")]
    tid = j_tracing.trace_id_for(REQ[0])
    assert t_tracing.assemble_trace([(rows[0], lost)], tid) == \
        j_tracing.assemble_trace([(rows[0], lost)], tid)


# -------------------------------------------------------------- metrics --

def _exercise_registry(mod):
    reg = mod.MetricsRegistry()
    c = reg.counter("deap_jobs_total", "jobs", labels=("kind",))
    c.inc(kind="a")
    c.inc(2.5, kind="b")
    g = reg.gauge("deap_depth", "depth")
    g.set(4)
    g.inc(2)
    g.dec(1)
    h = reg.histogram("deap_wait_seconds", "wait", labels=("phase",),
                      buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0, 0.05):
        h.observe(v, phase="x")
    snap = h.snapshot(phase="x")
    return reg, {
        "text": reg.metrics_text(),
        "counter": (c.value(kind="a"), c.value(kind="b")),
        "gauge": g.value(),
        "quantiles": [h.quantile(q, phase="x") for q in (0.1, 0.5, 0.99)],
        "labels": h.label_sets(),
        "snap": (snap.quantile(0.5), snap.mean(), snap.n, snap.total,
                 list(snap.counts)),
        "delta": [getattr(snap.delta(snap), k)
                  for k in ("buckets", "counts", "total", "n")],
    }


def test_metrics_instruments_and_registry():
    assert _exercise_registry(t_metrics)[1] == \
        _exercise_registry(j_metrics)[1]


def test_metrics_histogram_snapshot_and_constants():
    for name in ("SERVING_PHASE_BUCKETS", "SERVING_SEGMENT_BUCKETS",
                 "SERVING_WAIT_BUCKETS"):
        assert getattr(t_metrics, name) == getattr(j_metrics, name)
    a = j_metrics.HistogramSnapshot((1.0, 2.0), [1, 3], 4.5, 3)
    b = t_metrics.HistogramSnapshot((1.0, 2.0), [1, 3], 4.5, 3)
    assert (a.quantile(0.5), a.mean()) == (b.quantile(0.5), b.mean())


@pytest.mark.parametrize("fn", ["phase_histogram", "startup_phase_histogram",
                                "alarms_total", "alert_state_gauge"])
def test_metrics_named_instruments(fn):
    texts = []
    for mod in (j_metrics, t_metrics):
        reg = mod.MetricsRegistry()
        inst = getattr(mod, fn)(reg)
        assert getattr(mod, fn)(reg) is inst  # create-or-get
        texts.append(reg.metrics_text())
    assert texts[0] == texts[1]


def test_metrics_resolve_and_process_registry():
    for mod in (j_metrics, t_metrics):
        reg = mod.MetricsRegistry()
        assert mod.resolve_registry(None) is None
        assert mod.resolve_registry(False) is None
        assert mod.resolve_registry(True) is mod.get_registry()
        assert mod.resolve_registry(reg) is reg
        with pytest.raises(TypeError):
            mod.resolve_registry("no")
        assert mod.metrics_text(reg) == reg.metrics_text()
    assert t_metrics.get_registry() is not j_metrics.get_registry()


def test_metrics_server_serves_the_same_text():
    bodies = []
    for mod in (j_metrics, t_metrics):
        reg, _ = _exercise_registry(mod)
        server = mod.serve_metrics(reg, host="127.0.0.1", port=0)
        try:
            assert isinstance(server, mod.MetricsServer)
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{server.port}/metrics",
                    timeout=10) as resp:
                bodies.append(resp.read().decode())
        finally:
            server.close()
    assert bodies[0] == bodies[1] and "deap_jobs_total" in bodies[1]


# ------------------------------------------------------------------ slo --

def test_slo_constants_and_specs():
    for name in ("CURVE_METRICS", "SLO_JOURNAL_KINDS"):
        assert getattr(t_slo, name) == getattr(j_slo, name)
    assert _plain(t_slo.DEFAULT_SLOS) == _plain(j_slo.DEFAULT_SLOS)
    a = j_slo.SloSpec("x", "segment_p99", 0.05, "d")
    b = t_slo.SloSpec("x", "segment_p99", 0.05, "d")
    curve = j_slo.windowed_curve(_service_rows(), 0.5)
    assert (a.worst(curve), a.check(curve)) == (b.worst(curve),
                                                b.check(curve))


def test_slo_exact_quantile():
    for xs in ([], [3.0], [5.0, 1.0, 2.0, 9.0], list(range(100))):
        for q in (0.0, 0.5, 0.99, 1.0):
            assert t_slo.exact_quantile(xs, q) == \
                j_slo.exact_quantile(xs, q)


def test_slo_windowed_curve():
    rows = _service_rows()
    for w in (0.25, 1.0, 10.0):
        assert t_slo.windowed_curve(rows, w) == \
            j_slo.windowed_curve(rows, w)
    assert t_slo.windowed_curve([], 1.0) == []
    with pytest.raises(ValueError):
        t_slo.windowed_curve(rows, 0)


def test_slo_evaluate_gates():
    curve = j_slo.windowed_curve(_service_rows(), 0.5)
    got = []
    for mod in (j_slo, t_slo):
        events = []

        class _J:
            def event(self, kind, **payload):
                events.append((kind, payload))

        specs = list(mod.DEFAULT_SLOS) + [
            mod.SloSpec("tight", "segment_p99", 0.001)]
        got.append((mod.evaluate_gates(curve, specs, journal=_J(),
                                       cell="c"), events))
    assert got[0] == got[1]


def test_slo_phase_samples_and_attribution():
    base, probe = _service_rows(), _service_rows(slow=3.0)
    assert t_slo.phase_samples(base) == j_slo.phase_samples(base)
    for q in (0.5, 0.99):
        assert t_slo.attribute_regression(base, probe, q) == \
            j_slo.attribute_regression(base, probe, q)


# --------------------------------------------------------------- alerts --

def test_alerts_constants_rules_and_builders():
    assert t_alerts.ALERT_STATES == j_alerts.ALERT_STATES
    assert t_alerts.ALERT_STATE_VALUES == j_alerts.ALERT_STATE_VALUES
    for fn in ("default_rules", "service_rules"):
        for kw in ({}, {"fast_window_s": 2.0, "slow_window_s": 20.0}):
            assert _plain(getattr(t_alerts, fn)(**kw)) == \
                _plain(getattr(j_alerts, fn)(**kw))
    assert _plain(t_alerts.AlertRule("r", "shed_rate", 0.1)) == \
        _plain(j_alerts.AlertRule("r", "shed_rate", 0.1))


def test_alerts_engine_transitions():
    curve = j_slo.windowed_curve(_service_rows(slow=4.0), 0.2)
    outs = []
    for mod in (j_alerts, t_alerts):
        seen = []
        eng = mod.AlertEngine(mod.default_rules(0.5, 2.0),
                              on_transition=seen.append)
        ticks = []
        for i in range(12):
            eng.observe(i * 0.3, "shed_rate", 0.5 if i > 3 else 0.0)
            eng.observe(i * 0.3, "segment_p99", 0.01 * i)
            ticks.append(eng.tick(i * 0.3))
        eng.observe_curve(curve)
        ticks.append(eng.tick(10.0))
        outs.append((ticks, seen, eng.firing(), eng.snapshot(),
                     [eng.state(r.name) for r in mod.default_rules()]))
    assert outs[0] == outs[1]


# ----------------------------------------------------------- federation --

def test_federation_register_and_members(fleet):
    for pid in ("alpha", "beta"):
        a = j_fed.process_meta(fleet["j"], pid)
        b = t_fed.process_meta(fleet["t"], pid)
        assert a == b and a["role"] == "worker"
    assert t_fed.fleet_processes(fleet["t"]) == \
        j_fed.fleet_processes(fleet["j"]) == ["alpha", "beta"]
    with pytest.raises(ValueError):
        t_fed.register_process(fleet["t"], "a/b")


def test_federation_groups_and_health(fleet):
    for pid in ("alpha", "beta"):
        ga = j_fed.process_groups(fleet["j"], pid)
        gb = t_fed.process_groups(fleet["t"], pid)
        assert ga == gb
        meta = j_fed.process_meta(fleet["j"], pid)
        assert t_fed.process_health(gb, meta) == j_fed.process_health(ga,
                                                                      meta)


def _strip_root(x, root):
    return json.loads(json.dumps(x).replace(root, "<root>"))


def test_federation_federate_and_curve(fleet):
    a = j_fed.federate(fleet["j"])
    b = t_fed.federate(fleet["t"])
    assert _strip_root(a, fleet["j"]) == _strip_root(b, fleet["t"])
    assert t_fed.fleet_curve(b["rows"], 0.5) == \
        j_fed.fleet_curve(a["rows"], 0.5)


def test_federation_traces(fleet):
    for ident in REQ + [j_tracing.trace_id_for(REQ[1]), "nope"]:
        assert t_fed.resolve_request_id(fleet["t"], ident) == \
            j_fed.resolve_request_id(fleet["j"], ident)
        a = j_fed.fleet_trace(fleet["j"], ident)
        b = t_fed.fleet_trace(fleet["t"], ident)
        assert _strip_root(a, fleet["j"]) == _strip_root(b, fleet["t"])
    assert _strip_root(j_fed.cross_process_traces(fleet["j"]), fleet["j"]) \
        == _strip_root(t_fed.cross_process_traces(fleet["t"]), fleet["t"])


def test_federation_fleet_summary(fleet):
    for w in (0.5, 2.0):
        a = j_fed.fleet_summary(fleet["j"], w)
        b = t_fed.fleet_summary(fleet["t"], w)
        assert _strip_root(a, fleet["j"]) == _strip_root(b, fleet["t"])


# --------------------------------------------------------------- report --

def test_report_sparkline():
    for vals in ([], [1.0], [1, 5, 2, float("nan"), 9], list(range(200))):
        for w in (8, 48):
            assert t_report.sparkline(vals, w) == \
                j_report.sparkline(vals, w)


def test_report_render_report(journal):
    assert t_report.render_report(journal) == \
        j_report.render_report(journal)
    assert t_report.render_report(journal, lines=["x"]) == \
        j_report.render_report(journal, lines=["x"])


def test_report_render_trace(journal, tmp_path):
    for ident in REQ + ["missing"]:
        out = str(tmp_path / "p.json")
        a = j_report.render_trace(journal, ident, perfetto_out=out)
        ja = open(out).read() if os.path.exists(out) else None
        b = t_report.render_trace(journal, ident, perfetto_out=out)
        jb = open(out).read() if os.path.exists(out) else None
        assert a == b and ja == jb


def test_report_render_slo(journal):
    for w in (0.5, 1.0):
        assert t_report.render_slo(journal, w) == \
            j_report.render_slo(journal, w)


def test_report_render_attribution(tmp_path):
    base = _write(str(tmp_path / "base.jsonl"), _service_rows())
    probe = _write(str(tmp_path / "probe.jsonl"), _service_rows(slow=3.0))
    assert t_report.render_attribution(base, probe) == \
        j_report.render_attribution(base, probe)


def test_report_render_fleet(fleet):
    a = j_report.render_fleet(fleet["j"], 0.5)
    b = t_report.render_fleet(fleet["t"], 0.5)
    assert a.replace(fleet["j"], "<root>") == b.replace(fleet["t"],
                                                        "<root>")


def test_report_main(journal):
    outs = []
    for mod in (j_report, t_report):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = mod.main([journal])
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1] and outs[1][0] == 0


# ------------------------------------------- standalone sibling loads --

def test_sibling_loads_are_the_ports_own_files():
    here = os.path.join(ROOT, "deap_tpu_torch", "telemetry")
    assert os.path.dirname(t_report._journal().__file__) == here
    for fn in (t_report._tracing, t_report._slo, t_report._federation,
               t_fed._journal, t_fed._tracing, t_fed._slo):
        assert os.path.dirname(fn().__file__) == here


def test_copies_render_without_torch_or_jax(tmp_path, journal):
    script = textwrap.dedent(f"""
        import importlib.util, os, sys
        here = {os.path.join(ROOT, "deap_tpu_torch", "telemetry")!r}
        mods = {{}}
        for name in ("report", "federation", "metrics", "slo", "alerts",
                     "tracing"):
            spec = importlib.util.spec_from_file_location(
                "_standalone_" + name, os.path.join(here, name + ".py"))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[spec.name] = mod
            spec.loader.exec_module(mod)
            mods[name] = mod
        text = mods["report"].render_report({journal!r})
        assert "Run report" in text or len(text) > 100, text[:200]
        mods["metrics"].MetricsRegistry().counter("deap_x").inc()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("torch", "jax", "deap_tpu", "deap_tpu_torch"))
        print("LOADED", bad)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=str(tmp_path),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout
