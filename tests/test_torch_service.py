"""The port's network service, client, WAL, autoscaler and canary, on the
CPU.

- A job submitted over a loopback socket returns a result whose wire
  digest equals the same job run through the in-process scheduler;
  SIGTERM drains (the in-flight segment finishes, residents checkpoint
  tenant-stamped, ``service_drain`` journals) and a restarted service
  over the same root resumes to the uninterrupted digest; the WAL
  replays accepted jobs after a crash; idempotency keys, bearer auth and
  quotas, the scheduler's thread contract; the fault seams
  (``DropResponse``, ``DelaySegment`` + the watchdog, ``TornWAL``,
  ``CorruptResult`` caught by the known-answer canary); the migration
  endpoints refuse naming ROADMAP A13b.
- **Against the JAX package**: one scripted request sequence through
  both services — routes, status codes, response keys and error bodies;
  the autoscaler's decisions on the same snapshot sequences.
"""

import http.client
import json
import os
import signal
import threading
import time
import urllib.parse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deap_tpu import ops as jops
from deap_tpu.core.fitness import FitnessSpec as JSpec
from deap_tpu.core.population import init_population as j_init_population
from deap_tpu.core.toolbox import Toolbox as JToolbox
from deap_tpu.serving import EvolutionService as JService
from deap_tpu.serving import Job as JJob
from deap_tpu.serving.autoscale import AutoscaleConfig as JAutoscaleConfig
from deap_tpu.serving.autoscale import AutoscalePolicy as JAutoscalePolicy
from deap_tpu.serving.service import SERVICE_JOURNAL_KINDS as J_KINDS
from deap_tpu.telemetry.metrics import MetricsRegistry as JRegistry
from deap_tpu_torch import FitnessSpec, Toolbox, ops
from deap_tpu_torch.core.population import init_population
from deap_tpu_torch.device import make_generator
from deap_tpu_torch.resilience.faultinject import (CorruptResult,
                                                   DelaySegment,
                                                   DropResponse, FaultPlan,
                                                   TornWAL)
from deap_tpu_torch.serving import (AdmissionWAL, AutoscaleConfig,
                                    AutoscalePolicy, EvolutionService, Job,
                                    Scheduler, SchedulerBusyError,
                                    ServiceClient, ServiceError)
from deap_tpu_torch.serving.canary import CanarySpec
from deap_tpu_torch.serving.service import SERVICE_JOURNAL_KINDS
from deap_tpu_torch.serving.wire import pack, result_digest, unpack
from deap_tpu_torch.strategies import cma
from deap_tpu_torch.support.checkpoint import Checkpointer
from deap_tpu_torch.telemetry import read_journal
from deap_tpu_torch.telemetry.metrics import MetricsRegistry
from deap_tpu_torch.telemetry.probes import HealthMonitor

CPU = "cpu"


def _onemax_toolbox():
    tb = Toolbox()
    tb.register("evaluate", lambda g: g.sum(-1).to(torch.float32))
    tb.register("mate", ops.cx_two_point)
    tb.register("mutate", ops.mut_flip_bit, indpb=0.1)
    tb.register("select", ops.sel_tournament, tournsize=3)
    return tb


_TB = _onemax_toolbox()
_STRAT = cma.Strategy(centroid=[2.0] * 4, sigma=0.4, lambda_=8, device=CPU)
_TBC = Toolbox()
_TBC.register("evaluate", lambda g: (g ** 2).sum(-1))
_TBC.register("generate", _STRAT.generate)
_TBC.register("update", _STRAT.update)


def _onemax_job(tid, params):
    seed = int(params.get("seed", 0))
    pop = init_population(make_generator(seed, CPU), 16,
                          ops.bernoulli_genome(12), FitnessSpec((1.0,)),
                          device=CPU)
    return Job(tenant_id=tid, family="ea_simple", toolbox=_TB,
               generator=make_generator(1000 + seed, CPU), init=pop,
               ngen=int(params.get("ngen", 6)),
               hyper={"cxpb": 0.5, "mutpb": 0.2}, program="onemax")


def _sphere_job(tid, params):
    seed = int(params.get("seed", 0))
    return Job(tenant_id=tid, family="ea_generate_update", toolbox=_TBC,
               generator=make_generator(5000 + seed, CPU),
               init=_STRAT.initial_state(
                   sigma=float(params.get("sigma", 0.7))),
               ngen=int(params.get("ngen", 6)), spec=_STRAT.spec,
               program="sphere")


PROBLEMS = {"onemax": _onemax_job, "sphere": _sphere_job}


def _inprocess_digests(root, jobs):
    with Scheduler(str(root), max_lanes=2, segment_len=2) as sched:
        for j in jobs:
            sched.submit(j)
        results = sched.run()
    return {tid: result_digest(res) for tid, res in results.items()}


def _request(url, method, path, body=None, headers=None):
    """One raw request: ``(status, parsed JSON body or text)``."""
    u = urllib.parse.urlparse(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=120)
    data = json.dumps(body).encode() if body is not None else None
    conn.request(method, path, body=data, headers=dict(headers or {}))
    resp = conn.getresponse()
    raw = resp.read().decode()
    conn.close()
    try:
        return resp.status, json.loads(raw)
    except ValueError:
        return resp.status, raw


def _wait(pred, timeout=60.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(0.02)
    return False


# ------------------------------------------------------- wire codec ----

def test_wire_roundtrip_and_digest():
    rng = np.random.default_rng(0)
    payload = {"f32": rng.standard_normal(7).astype(np.float32),
               "f64": np.array([np.nan, -np.inf, 1e-300]),
               "t": torch.arange(6, dtype=torch.int16).reshape(2, 3),
               "nested": (np.arange(5, dtype=np.int8), "text", 3, None)}
    back = unpack(json.loads(json.dumps(pack(payload))))
    assert isinstance(back["nested"], tuple)
    assert back["t"].dtype == np.int16 and back["t"].shape == (2, 3)
    assert back["f64"].tobytes() == payload["f64"].tobytes()
    a, b = _onemax_job("a", {"seed": 1}), _onemax_job("a", {"seed": 2})
    assert result_digest((a.init,)) != result_digest((b.init,))
    assert result_digest((a.init,)) == result_digest((a.init,))


# ------------------------------------------------------- end to end ----

def test_service_e2e_bit_identical_to_inprocess(tmp_path):
    """Two problems, four tenants submitted from two client threads (one
    streaming NDJSON): every wire digest equals the in-process
    scheduler's, and the streamed segments carry byte-exact records."""
    specs = [("onemax", {"seed": 1, "ngen": 6}, "o1"),
             ("onemax", {"seed": 2, "ngen": 4}, "o2"),
             ("sphere", {"seed": 3, "ngen": 5}, "s1"),
             ("sphere", {"seed": 4, "ngen": 3, "sigma": 0.5}, "s2")]
    ref = _inprocess_digests(tmp_path / "ref", [
        PROBLEMS[p](tid, params) for p, params, tid in specs])
    results, streams = {}, {}
    with EvolutionService(str(tmp_path / "svc"), PROBLEMS, max_lanes=2,
                          segment_len=2, metrics=MetricsRegistry()) as svc:
        def client(my, stream):
            c = ServiceClient(svc.url)
            for p, params, tid in my:
                c.submit(p, params=params, tenant_id=tid)
            if stream:
                streams[my[0][2]] = list(c.stream(my[0][2]))
            for _, _, tid in my:
                results[tid] = c.result(tid, wait=True, timeout=120)

        ts = [threading.Thread(target=client, args=(specs[:2], True)),
              threading.Thread(target=client, args=(specs[2:], False))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
    for _, _, tid in specs:
        assert results[tid]["status"] == "finished"
        assert results[tid]["result"]["digest"] == ref[tid], tid
    events = streams["o1"]
    assert events[0]["event"] == "status"
    assert events[-1]["event"] == "finished"
    segs = [e for e in events if e["event"] == "segment"]
    assert all("records" in e for e in segs if e["gen"] > e["gen_from"])
    rows = read_journal(str(tmp_path / "svc" / "journal.jsonl"))
    assert {r["kind"] for r in rows} <= set(SERVICE_JOURNAL_KINDS) | {
        r["kind"] for r in rows if r["kind"] not in SERVICE_JOURNAL_KINDS}
    assert tuple(SERVICE_JOURNAL_KINDS) == tuple(J_KINDS)


def test_service_sigterm_drain_restart_bit_exact(tmp_path):
    NGEN = 12
    ref = _inprocess_digests(tmp_path / "ref", [_onemax_job(
        "tA", {"seed": 3, "ngen": NGEN})])["tA"]

    def kill_after_first_segment(step):
        if step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
            assert svc._drain_req.wait(30)

    root = str(tmp_path / "svc")
    svc = EvolutionService(root, PROBLEMS, max_lanes=2, segment_len=2,
                           metrics=MetricsRegistry(),
                           step_hook=kill_after_first_segment)
    ds = svc.install_signal_handlers()
    try:
        c = ServiceClient(svc.url)
        c.submit("onemax", params={"seed": 3, "ngen": NGEN},
                 tenant_id="tA")
        events = [ev["event"] for ev in c.stream("tA")]
        assert svc._drained.wait(60)
        assert events[-1] == "drained" and "segment" in events
        res = c.result("tA", wait=False)
        assert res["status"] == "drained" and "result" not in res
        with pytest.raises(ServiceError) as ei:
            c.submit("onemax", params={"seed": 9})
        assert ei.value.code == 503
    finally:
        ds.uninstall()
        svc.close()
    rows = read_journal(os.path.join(root, "journal.jsonl"))
    drains = [r for r in rows if r.get("kind") == "service_drain"]
    assert len(drains) == 1 and drains[0]["checkpointed"] == ["tA"]
    ck = Checkpointer(os.path.join(root, "tenants", "tA", "ckpt"))
    assert ck.meta()["tenant_id"] == "tA"
    with EvolutionService(root, PROBLEMS, max_lanes=2, segment_len=2,
                          metrics=MetricsRegistry()) as svc2:
        c2 = ServiceClient(svc2.url)
        c2.submit("onemax", params={"seed": 3, "ngen": NGEN},
                  tenant_id="tA")
        res = c2.result("tA", wait=True, timeout=120)
    assert res["status"] == "finished"
    assert res["result"]["digest"] == ref
    kinds = [r.get("kind") for r in read_journal(os.path.join(
        root, "journal.jsonl"))]
    assert "tenant_checkpoint_found" in kinds and "tenant_resumed" in kinds


def test_wal_replays_accepted_jobs_after_a_crash(tmp_path):
    """Accept records of a service killed before its driver admitted
    them (written as the service writes them): a new service over the
    root replays them to the in-process digests."""
    root = str(tmp_path / "svc")
    os.makedirs(root)
    wal = AdmissionWAL(os.path.join(root, "admission.wal"))
    wal.append_many([("accept", dict(tenant_id=f"w{s}", problem="onemax",
                                     params={"seed": s, "ngen": 4},
                                     idempotency_key=f"k{s}",
                                     request_id="r", token=""))
                     for s in (1, 2)])
    wal.close()
    ref = _inprocess_digests(tmp_path / "ref", [
        _onemax_job(f"w{s}", {"seed": s, "ngen": 4}) for s in (1, 2)])
    with EvolutionService(root, PROBLEMS, max_lanes=2, segment_len=2,
                          metrics=MetricsRegistry()) as svc:
        c = ServiceClient(svc.url)
        for s in (1, 2):
            res = c.result(f"w{s}", wait=True, timeout=120)
            assert res["result"]["digest"] == ref[f"w{s}"]
        # the idempotency key maps a retry to the replayed tenant
        assert c.submit("onemax", params={"seed": 1, "ngen": 4},
                        idempotency_key="k1") == "w1"
    rows = read_journal(os.path.join(root, "journal.jsonl"))
    replay = [r for r in rows if r.get("kind") == "wal_replay"]
    assert replay and replay[0]["replayed"] == ["w1", "w2"]


def test_torn_wal_and_dropped_response(tmp_path):
    """TornWAL tears the second accept and fails that submit; a restart
    replays only the first. DropResponse loses a submit's reply: the
    retry with the same idempotency key maps to the same tenant."""
    root = str(tmp_path / "svc")
    svc = EvolutionService(root, PROBLEMS, max_lanes=2, segment_len=2,
                           metrics=MetricsRegistry(),
                           fault_plan=FaultPlan([TornWAL(seq=2)]))
    try:
        c = ServiceClient(svc.url)
        # "a" runs long enough to be drained, not finished: no WAL record
        # may follow the torn one
        c.submit("onemax", params={"seed": 1, "ngen": 400}, tenant_id="a")
        # one attempt (the client would reconnect and resubmit): the
        # handler dies after tearing the record, so no reply comes
        with pytest.raises(Exception):
            _request(svc.url, "POST", "/v1/jobs",
                     {"problem": "onemax", "params": {"seed": 2},
                      "tenant_id": "b"})
    finally:
        svc.close()
    with EvolutionService(root, PROBLEMS, max_lanes=2, segment_len=2,
                          metrics=MetricsRegistry(),
                          fault_plan=FaultPlan([DropResponse("/v1/jobs")])
                          ) as svc:
        with pytest.raises(Exception):  # accepted, the reply lost
            _request(svc.url, "POST", "/v1/jobs",
                     {"problem": "onemax", "params": {"seed": 3, "ngen": 2},
                      "idempotency_key": "idem"})
        c = ServiceClient(svc.url)
        assert c.result("a", wait=True, timeout=120)["status"] == \
            "finished"
        code, _ = _request(svc.url, "GET", "/v1/jobs/b")
        assert code == 404
        tid = ServiceClient(svc.url).submit(
            "onemax", params={"seed": 3, "ngen": 2},
            idempotency_key="idem")
        assert ServiceClient(svc.url).result(tid, wait=True, timeout=120)[
            "status"] == "finished"
    rows = read_journal(os.path.join(root, "journal.jsonl"))
    assert any(r.get("kind") == "idempotent_replay" for r in rows)
    assert any(r.get("kind") == "wal_replay" and r.get("torn_tail")
               for r in rows)


def test_service_auth_quota_and_isolation(tmp_path):
    tokens = {"alice-key": {"tenant": "alice", "max_jobs": 1},
              "bob-key": {"tenant": "bob"}}
    with EvolutionService(str(tmp_path), PROBLEMS, tokens=tokens,
                          max_lanes=2, segment_len=2,
                          metrics=MetricsRegistry()) as svc:
        for token, code in ((None, 401), ("wrong", 403)):
            with pytest.raises(ServiceError) as ei:
                ServiceClient(svc.url, token=token).submit("onemax")
            assert ei.value.code == code
        assert ServiceClient(svc.url).healthz()["status"] == "ok"
        assert "deap_serving" in ServiceClient(svc.url).metrics_text()
        alice = ServiceClient(svc.url, token="alice-key")
        bob = ServiceClient(svc.url, token="bob-key")
        tid = alice.submit("onemax", params={"seed": 1, "ngen": 8},
                           tenant_id="alice-job")
        with pytest.raises(ServiceError) as ei:
            alice.submit("onemax", params={"seed": 2})
        assert ei.value.code == 429
        with pytest.raises(ServiceError) as ei:
            bob.status("alice-job")
        assert ei.value.code == 403
        assert alice.result(tid, wait=True, timeout=120)["status"] == \
            "finished"
        assert alice.submit("onemax", params={"seed": 2, "ngen": 2}
                            ).startswith("alice-")
    reasons = {r.get("reason") for r in read_journal(
        str(tmp_path / "journal.jsonl")) if r.get("kind") == "auth_rejected"}
    assert {"missing_token", "unknown_token", "quota",
            "foreign_tenant"} <= reasons


def test_scheduler_thread_contract(tmp_path):
    with Scheduler(str(tmp_path), max_lanes=2, segment_len=2) as sched:
        sched.bind_driver()
        err = []
        t = threading.Thread(target=lambda: err.append(
            pytest.raises(SchedulerBusyError, sched.submit,
                          _onemax_job("x", {}))))
        t.start()
        t.join()
        assert err
        sched.submit(_onemax_job("x", {"ngen": 2}))
        assert sched.run()["x"] is not None


def test_watchdog_flags_a_delayed_segment(tmp_path):
    health = HealthMonitor()
    with EvolutionService(str(tmp_path), PROBLEMS, max_lanes=2,
                          segment_len=2, metrics=MetricsRegistry(),
                          watchdog_s=0.2, health=health,
                          fault_plan=FaultPlan([DelaySegment(
                              step=1, delay_s=1.0, event="segment")])
                          ) as svc:
        c = ServiceClient(svc.url)
        tid = c.submit("onemax", params={"seed": 1, "ngen": 4})
        assert c.result(tid, wait=True, timeout=120)["status"] == \
            "finished"
    rows = read_journal(str(tmp_path / "journal.jsonl"))
    stalls = [r for r in rows if r.get("kind") == "driver_stall"]
    assert any("stalled_s" in r for r in stalls)
    assert any(r.get("recovered") for r in stalls)
    assert any(a["alarm"] == "driver_stall" for a in health.alarms)


def test_canary_learns_then_catches_a_corrupt_result(tmp_path):
    health = HealthMonitor()
    with EvolutionService(str(tmp_path), PROBLEMS, segment_len=2,
                          metrics=MetricsRegistry(), health=health,
                          fault_plan=FaultPlan([CorruptResult(
                              tenant_substr="canary-2")]),
                          canary=CanarySpec("onemax", {"seed": 7,
                                                       "ngen": 2},
                                            cadence_boundaries=1)) as svc:
        assert _wait(lambda: svc.canary.failed >= 1), svc.canary.snapshot()
        assert svc.canary.ok >= 1 and svc.canary.reference
        code, body = _request(svc.url, "GET", "/healthz")
        assert code == 503 and body["status"] == "degraded"
        assert "canary_failure" in body["firing_alerts"]
    rows = read_journal(str(tmp_path / "journal.jsonl"))
    fail = [r for r in rows if r.get("kind") == "canary_failed"]
    assert fail[0]["tenant_id"] == "canary-2"
    assert fail[0]["reason"] == "digest_mismatch"
    assert any(r.get("kind") == "canary_ok" and r.get("learned")
               for r in rows)


def test_migration_endpoints_refuse_naming_a13b(tmp_path):
    with EvolutionService(str(tmp_path), PROBLEMS, segment_len=2,
                          metrics=MetricsRegistry()) as svc:
        for path in ("/v1/migrate", "/v1/drain?handoff=http://peer"):
            code, body = _request(svc.url, "POST", path, {})
            assert code == 501 and "ROADMAP A13b" in body["error"]
        assert not svc.draining
        with pytest.raises(NotImplementedError, match="ROADMAP A13b"):
            svc.migrate("x", "http://peer")
        with pytest.raises(NotImplementedError, match="ROADMAP A13b"):
            svc.adopt_orphans(str(tmp_path))


# ------------------------------------------ against the JAX package ----

def _jax_toolbox():
    tb = JToolbox()
    tb.register("evaluate", lambda g: g.sum(-1).astype(jnp.float32))
    tb.register("mate", jops.cx_two_point)
    tb.register("mutate", jops.mut_flip_bit, indpb=0.1)
    tb.register("select", jops.sel_tournament, tournsize=3)
    return tb


_JTB = _jax_toolbox()


def _jax_onemax_job(tid, params):
    seed = int(params.get("seed", 0))
    pop = j_init_population(jax.random.key(seed), 16,
                            jops.bernoulli_genome(12), JSpec((1.0,)))
    return JJob(tenant_id=tid, family="ea_simple", toolbox=_JTB,
                key=jax.random.key(1000 + seed), init=pop,
                ngen=int(params.get("ngen", 6)),
                hyper={"cxpb": 0.5, "mutpb": 0.2}, program="onemax")


def _script(url):
    """One request sequence: what each answers (status, JSON keys, the
    error text)."""
    out = []

    def rec(method, path, body=None, headers=None, keys=True):
        code, resp = _request(url, method, path, body, headers)
        shape = (sorted(resp) if isinstance(resp, dict) and keys else None)
        err = resp.get("error") if isinstance(resp, dict) else None
        out.append((method, path, code, shape, err))
        return code, resp

    rec("GET", "/healthz")
    rec("POST", "/v1/jobs", {"problem": "onemax",
                             "params": {"seed": 1, "ngen": 2},
                             "tenant_id": "a"})
    rec("POST", "/v1/jobs", {"problem": "nope"})
    rec("POST", "/v1/jobs", {"jobs": "x"})
    rec("POST", "/v1/jobs", {"jobs": [{"problem": "onemax",
                                       "params": {"seed": 2, "ngen": 2},
                                       "tenant_id": "b",
                                       "idempotency_key": "k"}]})
    rec("POST", "/v1/jobs", {"problem": "onemax", "params": {"seed": 2},
                             "idempotency_key": "k"})
    rec("POST", "/v1/jobs", {"problem": "onemax", "deadline_s": "soon"})
    rec("GET", "/v1/jobs/a/result?wait=1&timeout=120")
    rec("GET", "/v1/jobs/b/result?wait=1&timeout=120")
    rec("GET", "/v1/jobs/a")
    rec("GET", "/v1/jobs/a/result?wait=1&timeout=abc")
    rec("GET", "/v1/results?ids=a,b&wait=1")
    rec("GET", "/v1/results")
    rec("GET", "/v1/jobs/zzz")
    rec("GET", "/v1/nothing")
    rec("GET", "/v1/alerts")
    code, _ = _request(url, "GET", "/metrics")
    out.append(("GET", "/metrics", code, None, None))
    rec("POST", "/v1/drain")
    rec("POST", "/v1/jobs", {"problem": "onemax"})
    return out


def test_service_routes_codes_and_bodies_match_jax(tmp_path):
    with JService(str(tmp_path / "j"), {"onemax": _jax_onemax_job},
                  max_lanes=2, segment_len=2, metrics=JRegistry()) as js:
        jout = _script(js.url)
    with EvolutionService(str(tmp_path / "t"), {"onemax": _onemax_job},
                          max_lanes=2, segment_len=2,
                          metrics=MetricsRegistry()) as ts:
        tout = _script(ts.url)
    assert len(jout) == len(tout)
    for j, t in zip(jout, tout):
        assert j == t, (j, t)


def _snap(queue=0, occ=0.0, lanes=8, p99=None, idle=()):
    return {"b": {"queue_depth": queue, "occupancy": occ, "lanes": lanes,
                  "queue_wait_p99": p99, "residents": int(occ * lanes),
                  "idle": idle}}


SCENARIOS = {
    "pressure": [_snap(queue=3, occ=1.0)] * 4,
    "oscillating": [_snap(queue=5 * (i % 2 == 0), occ=1.0 if i % 2 == 0
                          else 0.5) for i in range(12)],
    "p99": [_snap(occ=0.9, lanes=4, p99=2.0)] * 3,
    "idle": [_snap(occ=0.0, lanes=16)] * 6,
    "spill": [_snap(queue=4, occ=1.0, lanes=64,
                    idle=(("t1", 5, 40), ("t2", 9, 0), ("t3", 2, 80)))] * 4,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_autoscale_decisions_match_jax(name):
    kw = dict(up_after=2, down_after=3, max_lanes=64, wait_p99_high=0.5)
    tp = AutoscalePolicy(AutoscaleConfig(**kw))
    jp = JAutoscalePolicy(JAutoscaleConfig(**kw))
    for snap in SCENARIOS[name]:
        td, jd = tp.decide(snap), jp.decide(snap)
        assert bool(td) == bool(jd)
        assert td.lane_counts == jd.lane_counts
        assert list(td.prewarm) == list(jd.prewarm)
        assert list(td.spill) == list(jd.spill)
        assert td.reasons == jd.reasons
